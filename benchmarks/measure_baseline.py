"""Measure the CPU reference pipeline on the benchmark dataset.

The reference repo publishes no numbers (BASELINE.md), so the baseline is
measured by running the reference end-to-end (SIFT+FLANN+RANSAC matching,
incremental LM bundle adjustment, multiband render) on the host CPU, on the
same synthetic dataset bench.py uses (``synth.bench_dataset``). Results land
in BASELINE_MEASURED.json next to the repo root.

Run: PANO360_REFERENCE=<reference checkout> python benchmarks/measure_baseline.py
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pano360.synth import (  # noqa: E402
    BENCH_OVERLAP, BENCH_SEED, BENCH_SHAPE, BENCH_VIEWS, bench_dataset)
from refcompat import load_reference  # noqa: E402


def main():
    reference = load_reference(os.environ["PANO360_REFERENCE"])
    ref_feat = reference("features")
    ref_st = reference("stitcher")
    ref_ba = reference("bundle_adj")

    imgs, _, _ = bench_dataset()
    print(f"dataset: {len(imgs)} views of {imgs[0].shape}", flush=True)

    t0 = time.time()
    kpts, matches = ref_feat.matching(imgs)
    t_match = time.time() - t0
    print(f"reference matching: {t_match:.2f}s", flush=True)

    t0 = time.time()
    regions = ref_ba.traverse(imgs, ref_st.idx_to_keypoints(matches, kpts),
                              badjust="incr")
    t_reg = time.time() - t0
    print(f"reference registration: {t_reg:.2f}s ({len(regions)} placed)",
          flush=True)

    t0 = time.time()
    mosaic = ref_st.stitch(regions, blender=ref_st.multiband_blend)
    t_stitch = time.time() - t0
    print(f"reference mosaic: {t_stitch:.2f}s {mosaic.shape}", flush=True)

    out = {
        "dataset": {"views": BENCH_VIEWS, "shape": list(BENCH_SHAPE),
                    "overlap": BENCH_OVERLAP, "seed": BENCH_SEED},
        "reference": {
            "matching_s": round(t_match, 3),
            "registration_s": round(t_reg, 3),
            "mosaic_s": round(t_stitch, 3),
            "e2e_s": round(t_match + t_reg + t_stitch, 3),
        },
        "mosaic_shape": list(mosaic.shape),
    }
    path = os.path.join(ROOT, "BASELINE_MEASURED.json")
    with open(path, "w") as fid:
        json.dump(out, fid, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
