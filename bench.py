"""Benchmark: end-to-end stitch of a CMU2-like dataset on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, "device": {...}}

The timed region is the full pipeline (upload + extraction + matching +
registration + render) after one warm-up run that compiles every stage,
as a deployed service would run. ``value`` is the median of 5 steady runs;
every sample goes to stderr so the spread is visible.

``vs_baseline`` is the reference's CPU time on the same dataset
(BASELINE_MEASURED.json, measured on another host's CPU with
``python benchmarks/measure_baseline.py``) over ``value``. The two numbers
come from different machines, so the ratio is indicative only.

Exits non-zero without a GPU: no number here comes from a CPU run.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from pano360 import render  # noqa: E402
from pano360.pipeline import (  # noqa: E402
    idx_to_keypoints, matching, upload_extract)
from pano360.register import traverse  # noqa: E402
from pano360.synth import bench_dataset  # noqa: E402


def run_pipeline(imgs, seed=0):
    dev, feats = upload_extract(imgs)      # upload overlapped with SIFT
    kpts, matches = matching(imgs, seed=seed, dev_images=dev, feats=feats)
    regions = traverse(imgs, idx_to_keypoints(matches, kpts),
                       badjust="incr")
    return render.stitch(regions, blender="multiband", dev_images=dev)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; found {dev.platform}")
    imgs, _, _ = bench_dataset()

    t0 = time.time()
    run_pipeline(imgs, seed=0)             # compiles every stage
    warm = time.time() - t0

    samples = []
    for _ in range(5):
        t0 = time.time()
        mosaic = run_pipeline(imgs, seed=0)   # ends in a host copy
        samples.append(time.time() - t0)
    elapsed = sorted(samples)[len(samples) // 2]

    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as fid:
        ref_s = json.load(fid)["reference"]["e2e_s"]

    print(json.dumps({
        "metric": "e2e_stitch_cmu2like_15x1mpix",
        "value": elapsed,
        "unit": "s",
        "vs_baseline": ref_s / elapsed,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    print(f"# warmup={warm:.3f}s samples={samples} mosaic={mosaic.shape}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
