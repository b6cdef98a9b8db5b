"""Substage profile of sift_extract on the GPU, in one process.

Times PREFIXES of the production ``sift_extract`` program itself (its
static ``upto`` argument stops after a named stage and returns a scalar
checksum), attributing cost by subtraction:

  gauss   : base image + Gaussian stacks + DoG for all octaves
  cand    : + top-k candidate selection
  refine  : + dense Newton-step-field refinement + survivor compaction
  patch   : + patch extraction / gradients
  full    : sift_extract (adds orientation + descriptor + global top-k)

Run: python benchmarks/profile_sift.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402

from pano360.synth import bench_dataset  # noqa: E402
from pano360.features import sift as S  # noqa: E402

STAGES = ("gauss", "cand", "refine", "patch", "full")


def force(out):
    # sync every leaf: the timed region ends when the device is done
    jax.block_until_ready(out)
    return out


def t(label, fn, n=5):
    force(fn())
    times = []
    for _ in range(n):
        t0 = time.time()
        force(fn())
        times.append(time.time() - t0)
    print(f"{label:24s} {sorted(times)[n // 2]:7.4f}s  (all {times})",
          flush=True)
    return sorted(times)[n // 2]


def gray_batches(imgs, bs=4):
    """Gray stack in the pipeline's fixed 4-image batches (one compile
    per resolution), the tail padded by repeating the last image."""
    gray = np.stack(imgs).astype(np.float32) / 255.0
    gray = (gray[..., 0] * 0.114 + gray[..., 1] * 0.587
            + gray[..., 2] * 0.299).astype(np.float32)
    pad = -len(gray) % bs
    if pad:
        gray = np.concatenate([gray, gray[-1:].repeat(pad, 0)])
    return [jax.device_put(gray[i:i + bs]) for i in range(0, len(gray), bs)]


def main():
    imgs, _, _ = bench_dataset()
    chunks = gray_batches(imgs)
    dev = jax.devices()[0]
    print(f"{dev.platform} {dev.device_kind}: {len(chunks)} batches of "
          f"{chunks[0].shape}", flush=True)
    cfg = S.SiftConfig(
        patch_dtype=os.environ.get("SIFT_PATCH_DTYPE", "float32"))
    meds = {stage: t(stage, lambda stage=stage: [
        S.sift_extract(c, cfg, upto=stage) for c in chunks])
        for stage in STAGES}
    print("attribution (median deltas):", flush=True)
    prev = 0.0
    for stage in STAGES:
        print(f"  {stage:10s} {meds[stage] - prev:7.4f}s "
              f"(cum {meds[stage]:.4f}s)", flush=True)
        prev = meds[stage]


if __name__ == "__main__":
    main()
