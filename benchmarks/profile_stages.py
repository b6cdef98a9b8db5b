"""Per-stage wall-time profile of the benchmark pipeline on the GPU.

Separates the costs bench.py conflates; every stage is forced with
``jax.block_until_ready`` before its clock stops.

Run: python benchmarks/profile_stages.py
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
                                  upload_extract, _gray_extract)
from pano360.features import sift as S  # noqa: E402
from pano360.register import traverse  # noqa: E402
from pano360 import render  # noqa: E402


def force(out):
    """Wait until the device has finished ``out``."""
    jax.block_until_ready(out)
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


def main():
    imgs, _, _ = bench_dataset()
    host_stack = np.stack(imgs)
    print(f"dataset: {len(imgs)} x {imgs[0].shape} "
          f"({host_stack.nbytes / 1e6:.1f} MB)", flush=True)

    cfg = S.SiftConfig()

    t("upload 45MB uint8 (device_put, forced)",
      lambda: jax.device_put(host_stack).sum())

    dev = force(jax.device_put(host_stack) * 1)
    t("SIFT compute (resident stack)", lambda: _gray_extract(dev, cfg))

    res = t("upload_extract (overlapped, production)",
            lambda: upload_extract(imgs))
    dev, feats = res

    kpts, matches = None, None

    def run_matching():
        nonlocal kpts, matches
        kpts, matches = matching(imgs, seed=0, dev_images=dev, feats=feats)
        return 0

    t("matching (given feats)", run_matching)
    mk = idx_to_keypoints(matches, kpts)
    regions = t("traverse (incr)", lambda: traverse(imgs, mk, badjust="incr"))
    t("stitch (multiband)",
      lambda: render.stitch(regions, blender="multiband", dev_images=dev))

    def e2e():
        d, f = upload_extract(imgs)
        k, m = matching(imgs, seed=0, dev_images=d, feats=f)
        r = traverse(imgs, idx_to_keypoints(m, k), badjust="incr")
        return render.stitch(r, blender="multiband", dev_images=d)

    t("e2e", e2e)


if __name__ == "__main__":
    main()
