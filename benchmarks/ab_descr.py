"""A/B the descriptor sampling modes on the GPU.

Times the FULL production sift_extract program (4-image bench batches)
under descr_mode='grid' (rotated 16x16 bilinear sample grid, the
vectorized-SIFT standard) vs 'dense' (cv2's exact integer-window
semantics, calcSIFTDescriptor — what the reference runs via
features.py:192-201). Quality companion: ab_real_quality.py with a 2nd
argv of grid,dense.

Run: python benchmarks/ab_descr.py [modes]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks.profile_sift import t  # noqa: E402  (timing helper)

import numpy as np  # noqa: E402
import jax

from pano360.synth import bench_dataset
from pano360.features import sift as S


def main():
    imgs, _, _ = bench_dataset()
    gray_np = (np.stack(imgs).astype(np.float32) / 255.0)
    gray_np = (gray_np[..., 0] * 0.114 + gray_np[..., 1] * 0.587
               + gray_np[..., 2] * 0.299).astype(np.float32)
    bs = 4
    pad = -len(gray_np) % bs
    if pad:
        gray_np = np.concatenate([gray_np, gray_np[-1:].repeat(pad, 0)])
    chunks = [jax.device_put(gray_np[i:i + bs])
              for i in range(0, len(gray_np), bs)]
    print(f"gray stack: {gray_np.shape} in {len(chunks)}x{bs} batches",
          flush=True)
    modes = (sys.argv[1].split(",") if len(sys.argv) > 1
             else ("grid", "dense"))
    out = {}
    for mode in modes:
        cfg = S.SiftConfig(descr_mode=mode)
        out[mode] = t(f"full[{mode}]",
                      lambda cfg=cfg: [S.sift_extract(c, cfg)
                                       for c in chunks])
    print(json.dumps({"full_sift_s": {k: round(v, 3)
                                      for k, v in out.items()}}))


if __name__ == "__main__":
    main()
