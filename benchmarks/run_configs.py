"""Run the five BASELINE.md benchmark configurations end-to-end.

Configs (BASELINE.md / BASELINE.json):
  1. CMU0-like:  SIFT+RANSAC, --ba none,  --blend linear,  shrink 2
  2. CMU2-like:  defaults (--ba incr, --blend multiband)
  3. LunchRoom-like: --equalize + multiband (gain-perturbed views)
  4. CMU1-like:  MSOP extractor path
  5. UAV-like:   long sequence, --ba last + --crop

Each runs on its own synthetic dataset (no reference datasets ship with the
environment). Prints one JSON line per config with timing, basic output
stats and the device the run used.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pano360 import synth  # noqa: E402
from pano360.cli import build_parser, run  # noqa: E402


def make_ds(tmp, name, n_views, shape, seed, gains=None):
    imgs, rots, focal = synth.make_views(n_views=n_views, shape=shape,
                                         overlap=0.5, seed=seed)
    if gains is not None:
        imgs = [np.clip(im * g, 0, 1) for im, g in zip(imgs, gains)]
    path = os.path.join(tmp, name)
    synth.write_dataset(path, imgs)
    return path


CONFIGS = [
    ("cmu0_like_ba-none_linear_s2",
     dict(n_views=6, shape=(600, 800), seed=10),
     ["-s", "2", "--ba", "none", "-b", "linear"]),
    ("cmu2_like_defaults",
     dict(n_views=10, shape=(600, 800), seed=11),
     ["-s", "2"]),
    ("lunchroom_like_equalize_multiband",
     dict(n_views=6, shape=(600, 800), seed=12,
          gains=[0.8, 1.15, 0.9, 1.2, 0.95, 1.1]),
     ["-s", "2", "-e"]),
    ("cmu1_like_msop",
     dict(n_views=5, shape=(480, 640), seed=13),
     ["-s", "2", "--detector", "msop", "-b", "linear"]),
    ("uav_like_ba-last_crop",
     dict(n_views=12, shape=(480, 640), seed=14),
     ["-s", "2", "--ba", "last", "-c"]),
]

# Past the reference's 1400-px cap, which exists because CPU rendering
# is slow (stitcher.py:17,153-155).
HIGHRES = ("highres_flagship_maxres4000",
           dict(n_views=10, shape=(1080, 1440), seed=15),
           ["-s", "1", "--max-resolution", "4000"])


def _run_config(tmp, name, ds_kwargs, flags):
    """Cold run (compiles included), then a steady run with the stage
    caches dropped so the full pipeline re-executes."""
    import glob
    ds = make_ds(tmp, name, **ds_kwargs)
    cache = os.path.join(tmp, name + "_cache")
    os.makedirs(cache, exist_ok=True)
    args = build_parser().parse_args([ds, *flags, "--cache-dir", cache])
    t0 = time.time()
    run(args)
    cold = time.time() - t0
    for f in glob.glob(os.path.join(cache, "*")):
        os.remove(f)
    t0 = time.time()
    mosaic = run(args)
    steady = time.time() - t0
    return {"cold_s": cold, "steady_s": steady,
            "mosaic": list(mosaic.shape),
            "filled_frac": float((mosaic.sum(-1) > 0).mean())}


def main():
    import tempfile
    import jax
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ds_kwargs, flags in CONFIGS + [HIGHRES]:
            row = _run_config(tmp, name, ds_kwargs, flags)
            print(json.dumps({name: row, "device": device}), flush=True)


if __name__ == "__main__":
    main()
