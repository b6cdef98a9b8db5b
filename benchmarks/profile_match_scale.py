"""Attribute the "match" stage at 50 views x 2.2 Mpix.

An end-to-end match time lumps upload_extract + host prep + the match
dispatch + result readback. This splits them and further splits the
match dispatch into its substages (knn2 top-2, RANSAC hypotheses,
refit) so optimization targets the real cost, not the label.

Run: python benchmarks/profile_match_scale.py [n_views]
"""
import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano360 import synth  # noqa: E402
from pano360.pipeline import upload_extract, _compact_buffers_dev  # noqa: E402
from pano360 import match as pm  # noqa: E402
from pano360.features import sift as S  # noqa: E402

SHAPE = (1296, 1728)


def force(out):
    for y in jax.tree_util.tree_leaves(out):
        if hasattr(y, "block_until_ready"):
            y.block_until_ready()
    return out


def t(label, fn, n=3):
    out = force(fn())
    times = []
    for _ in range(n):
        t0 = time.time()
        force(fn())
        times.append(time.time() - t0)
    print(f"{label:52s} {sorted(times)[n // 2]:7.3f}s  "
          f"(all {[round(x, 3) for x in times]})", flush=True)
    return out


def main():
    n_views = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    views, _, _ = synth.make_views(n_views=n_views, shape=SHAPE,
                                   overlap=0.45, seed=7)
    imgs = [(np.asarray(im) * 255).astype(np.uint8) for im in views]
    n = len(imgs)

    t0 = time.time()
    dev, feats = upload_extract(imgs)
    force(feats)
    print(f"upload_extract (cold, incl compile)        {time.time()-t0:7.3f}s",
          flush=True)
    t("upload_extract (warm)", lambda: force(upload_extract(imgs)[1]))

    cents = jnp.asarray([[im.shape[1] / 2, im.shape[0] / 2]
                         for im in imgs], jnp.float32)
    kp_buf = feats.xy - cents[:, None, :]
    ds_buf = S.root_sift(feats.desc)
    va_buf = feats.valid
    counts = np.asarray(va_buf).sum(axis=1).astype(np.int32)
    cap0 = kp_buf.shape[1]
    cmax = int(counts.max())
    ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
    print(f"  counts: max={cmax} mean={counts.mean():.0f} cap={cap0} "
          f"ccap={ccap}", flush=True)
    if ccap < cap0:
        kp_c, ds_c, va_c = _compact_buffers_dev(
            kp_buf, ds_buf, va_buf, jnp.asarray(counts), ccap)
    else:
        kp_c, ds_c, va_c = kp_buf, ds_buf, va_buf
    force((kp_c, ds_c, va_c))

    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    keys = jax.random.split(jax.random.key(0), len(pairs))
    pa = jnp.asarray([p[0] for p in pairs], jnp.int32)
    pb = jnp.asarray([p[1] for p in pairs], jnp.int32)
    cap = kp_c.shape[1]
    batch = max(1, min(16, (1 << 28) // max(cap * cap * 4, 1)))
    print(f"  pairs={len(pairs)} batch={batch}", flush=True)

    # --- substage dispatches (each over ALL pairs, lax.map chunked) ---
    @functools.partial(jax.jit, static_argnames=("bs",))
    def knn_only(ds, va, a_idx, b_idx, bs):
        def one(args):
            a, b = args
            idx, good = pm.knn2_matches(ds[a], ds[b], va[a], va[b])
            return idx.astype(jnp.int32), good
        return jax.lax.map(one, (a_idx, b_idx), batch_size=bs)

    t(f"knn2 top-2 only ({len(pairs)} pairs)",
      lambda: knn_only(ds_c, va_c, pa, pb, batch))

    def full():
        return pm.match_all_pairs(kp_c, ds_c, va_c, pa, pb, keys,
                                  batch_size=batch)

    t(f"match_all_pairs full ({len(pairs)} pairs)", full)

    t("match dispatch + naive 5-pull readback",
      lambda: jax.tree_util.tree_map(np.asarray, full()))

    from pano360.pipeline import (_pack_match_results,
                                      _unpack_match_results)
    t("match dispatch + packed readback (production)",
      lambda: _unpack_match_results(
          np.asarray(_pack_match_results(full())), cap))


if __name__ == "__main__":
    main()
