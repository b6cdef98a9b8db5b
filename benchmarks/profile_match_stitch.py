"""Substage profile of matching() and render.stitch() on the GPU.

Separates device compute from host assembly / dispatch+sync latency.

Run: python benchmarks/profile_match_stitch.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano360.synth import bench_dataset  # noqa: E402
from pano360.pipeline import (matching, idx_to_keypoints,  # noqa: E402
                                  upload_extract)
from pano360 import match as pm  # noqa: E402
from pano360.features import sift as S  # noqa: E402
from pano360.register import traverse  # noqa: E402
from pano360 import render  # noqa: E402
from pano360 import geometry as geo  # noqa: E402


def force(out):
    x = [y for y in jax.tree_util.tree_leaves(out) if hasattr(y, "dtype")][0]
    np.asarray(x.reshape(-1)[0])
    return out


def t(label, fn, n=3):
    out = force(fn())
    times = []
    for _ in range(n):
        t0 = time.time()
        force(fn())
        times.append(time.time() - t0)
    print(f"{label:46s} {sorted(times)[n // 2]:7.3f}s  "
          f"(all {[round(x, 3) for x in times]})", flush=True)
    return out


def main():
    imgs, _, _ = bench_dataset()
    n = len(imgs)
    dev, feats = upload_extract(imgs)
    force(feats)

    # --- matching breakdown ---
    # replicate matching()'s prep to isolate the device dispatch
    cents = jnp.asarray([[im.shape[1] / 2, im.shape[0] / 2]
                         for im in imgs], jnp.float32)
    kp_buf = feats.xy - cents[:, None, :]
    ds_buf = S.root_sift(feats.desc)
    va_buf = feats.valid

    t("match prep: valid/kpts readback (host)", lambda: [
        np.asarray(va_buf), np.asarray(kp_buf)][0].sum())

    valid_np = np.asarray(va_buf)
    counts = valid_np.sum(axis=1).astype(np.int32)
    print(f"  counts: max={counts.max()} mean={counts.mean():.0f} "
          f"cap={kp_buf.shape[1]}", flush=True)

    from pano360.pipeline import _compact_buffers
    cmax = int(counts.max())
    ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
    sel = np.zeros((n, ccap), np.int32)
    for i in range(n):
        nz = np.flatnonzero(valid_np[i])
        sel[i, : len(nz)] = nz
    kp_c, ds_c, va_c = _compact_buffers(kp_buf, ds_buf, jnp.asarray(sel),
                                        jnp.asarray(counts))
    force((kp_c, ds_c, va_c))
    print(f"  compact cap: {ccap}", flush=True)

    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    keys = jax.random.split(jax.random.key(0), len(pairs))
    pa = jnp.asarray([p[0] for p in pairs], jnp.int32)
    pb = jnp.asarray([p[1] for p in pairs], jnp.int32)
    batch = max(1, min(16, (1 << 28) // max(ccap * ccap * 4, 1)))

    res = t(f"match_all_pairs dispatch ({len(pairs)} pairs)",
            lambda: pm.match_all_pairs(kp_c, ds_c, va_c, pa, pb, keys,
                                       batch_size=batch))

    # dispatch + FULL result readback in one (fresh dispatch each rep:
    # a jax array caches its host copy after the first np.asarray)
    t("match dispatch + full readback",
      lambda: jax.tree_util.tree_map(np.asarray, pm.match_all_pairs(
          kp_c, ds_c, va_c, pa, pb, keys, batch_size=batch)))

    # matching() is host-synchronous at return (it pulls its results to
    # numpy internally), so a plain scalar suffices for timing
    t("matching() end-to-end", lambda: jnp.zeros(()) + float(
        matching(imgs, seed=0, dev_images=dev, feats=feats)[0][0].shape[0]))

    kpts, matches = matching(imgs, seed=0, dev_images=dev, feats=feats)
    mk = idx_to_keypoints(matches, kpts)
    regions = traverse(imgs, mk, badjust="incr")

    # --- stitch breakdown ---
    shapes = np.array([r.img.shape[:2] for r in regions])
    h, w = int(shapes[:, 0].max()), int(shapes[:, 1].max())
    homs = np.stack([r.hom() for r in regions])
    t("proj_img_range_border (+sync)",
      lambda: np.asarray(render.proj_img_range_border(
          (h, w), jnp.asarray(homs))[0]).sum())

    dev_f = dev.astype(jnp.float32) / 255.0
    t("add_weights", lambda: render.add_weights(dev_f))

    t("stitch() end-to-end",
      lambda: render.stitch(regions, blender="multiband", dev_images=dev))

    # stitch minus the blender: linear for comparison
    t("stitch() blender=linear",
      lambda: render.stitch(regions, blender="linear", dev_images=dev))
    t("stitch() blender=none",
      lambda: render.stitch(regions, blender="none", dev_images=dev))


if __name__ == "__main__":
    main()
