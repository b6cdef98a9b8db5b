"""Substage profile of the per-pair matcher on the GPU.

Splits match_all_pairs (the 0.33-0.35 s matching dispatch) into its
algorithmic substages by timing truncated programs over the same 105
bench pairs, attributing cost by subtraction:

  knn2    : distance matmul + top-2 + ratio test only
  +ransac : + 2048-hypothesis closed-form DLT + inlier scoring
  +refit  : + weighted-DLT eigh refit + 3 GN steps  (== full match_pair)

Run: python benchmarks/profile_match_sub.py
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

from pano360.synth import bench_dataset  # noqa: E402
from pano360.pipeline import upload_extract, _compact_buffers  # noqa: E402
from pano360 import match as pm  # noqa: E402
from pano360.features import sift as S  # noqa: E402


def force(out):
    x = [y for y in jax.tree_util.tree_leaves(out) if hasattr(y, "dtype")][-1]
    np.asarray(x.reshape(-1)[:1])
    return out


def t(label, fn, n=3):
    out = force(fn())
    times = []
    for _ in range(n):
        t0 = time.time()
        force(fn())
        times.append(time.time() - t0)
    print(f"{label:44s} {sorted(times)[n // 2]:7.3f}s  "
          f"(all {[round(x, 3) for x in times]})", flush=True)
    return out


@functools.partial(jax.jit, static_argnames=("batch_size", "stage"))
def truncated_pairs(kpts, desc, valid, pair_a, pair_b, keys,
                    batch_size, stage):
    """All pairs through a truncated per-pair program."""
    def one(args):
        a, b, k = args
        best_idx, good = pm.knn2_matches(desc[a], desc[b],
                                         valid[a], valid[b])
        if stage == "knn2":
            return best_idx.astype(jnp.int32), good
        p1 = kpts[a].astype(jnp.float32)
        p2 = kpts[b][best_idx].astype(jnp.float32)
        m = p1.shape[0]
        n_valid = jnp.maximum(jnp.sum(good.astype(jnp.int32)), 1)
        cum = jnp.cumsum(good.astype(jnp.int32))
        pos = jnp.where(good, cum - 1, m)
        rank_map = jnp.zeros((m,), jnp.int32).at[pos].set(
            jnp.arange(m, dtype=jnp.int32), mode="drop")
        draws = jax.random.randint(k, (pm.RANSAC_ITERS, 4), 0, n_valid)
        sample_idx = rank_map[draws]
        if stage == "sample":
            return sample_idx, good
        homs = jax.vmap(pm.hom_from_4pts)(p1[sample_idx], p2[sample_idx])
        if stage == "homs":
            return homs, good
        errs = jax.vmap(lambda h: pm._reproj_errors(h, p1, p2))(homs)
        inl = (errs < pm.RANSAC_THRESH ** 2) & good[None, :]
        finite = jnp.all(jnp.isfinite(homs.reshape(pm.RANSAC_ITERS, 9)),
                         axis=1)
        counts = jnp.where(finite, jnp.sum(inl, axis=1), 0)
        best = jnp.argmax(counts)
        if stage == "ransac":
            return homs[best], inl[best]
        hom = pm.refit_homography(p1, p2, inl[best].astype(p1.dtype))
        return hom, inl[best]

    return jax.lax.map(one, (pair_a, pair_b, keys), batch_size=batch_size)


def main():
    imgs, _, _ = bench_dataset()
    n = len(imgs)
    dev, feats = upload_extract(imgs)
    force(feats)

    cents = jnp.asarray([[im.shape[1] / 2, im.shape[0] / 2]
                         for im in imgs], jnp.float32)
    kp_buf = feats.xy - cents[:, None, :]
    ds_buf = S.root_sift(feats.desc)
    va_buf = feats.valid
    valid_np = np.asarray(va_buf)
    counts = valid_np.sum(axis=1).astype(np.int32)
    cmax = int(counts.max())
    ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
    if ccap < kp_buf.shape[1]:
        sel = np.zeros((n, ccap), np.int32)
        for i in range(n):
            nz = np.flatnonzero(valid_np[i])
            sel[i, : len(nz)] = nz
        kp_buf, ds_buf, va_buf = _compact_buffers(
            kp_buf, ds_buf, jnp.asarray(sel), jnp.asarray(counts))
    force((kp_buf, ds_buf, va_buf))
    print(f"compact cap={ccap}  counts max={cmax} mean={counts.mean():.0f}",
          flush=True)

    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    keys = jax.random.split(jax.random.key(0), len(pairs))
    pa = jnp.asarray([p[0] for p in pairs], jnp.int32)
    pb = jnp.asarray([p[1] for p in pairs], jnp.int32)
    batch = max(1, min(16, (1 << 28) // max(ccap * ccap * 4, 1)))
    print(f"pairs={len(pairs)} batch={batch}", flush=True)

    t("knn2 only", lambda: truncated_pairs(
        kp_buf, ds_buf, va_buf, pa, pb, keys, batch, "knn2"))
    t("+sample (searchsorted+gather)", lambda: truncated_pairs(
        kp_buf, ds_buf, va_buf, pa, pb, keys, batch, "sample"))
    t("+homs (closed-form DLT)", lambda: truncated_pairs(
        kp_buf, ds_buf, va_buf, pa, pb, keys, batch, "homs"))
    t("+ransac (score+argmax)", lambda: truncated_pairs(
        kp_buf, ds_buf, va_buf, pa, pb, keys, batch, "ransac"))
    t("+refit (== full)", lambda: truncated_pairs(
        kp_buf, ds_buf, va_buf, pa, pb, keys, batch, "refit"))
    t("match_all_pairs (production)", lambda: pm.match_all_pairs(
        kp_buf, ds_buf, va_buf, pa, pb, keys, batch_size=batch))


if __name__ == "__main__":
    main()
