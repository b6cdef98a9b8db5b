"""Attribute traverse cost at 50 views x 2.2 Mpix.

The per-add LM grows super-linearly with the view count; this probe
splits the warm 50-view dispatch into its parts by toggling the schedule
knobs:

  badjust='none'                 seeding + gating scan only
  badjust='incr', polish=False   + one full-problem LM per add (the
                                   reference's incremental schedule,
                                   bundle_adj.py:348-395)
  badjust='incr', polish=True    + the adaptive-damping polish (ours)
  badjust='last', polish=True    single LM after the walk + polish

Each timed warm over 3 reps (median), block-until-ready via the host
PanoImage materialization traverse already performs.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from pano360 import synth  # noqa: E402
from pano360.pipeline import matching, idx_to_keypoints  # noqa: E402
from pano360.register import traverse  # noqa: E402

SHAPE = (1296, 1728)
N_VIEWS = int(os.environ.get("N_VIEWS", "50"))


def timed(fn, reps=3):
    fn()  # warm/compile
    ts = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return sorted(ts)[len(ts) // 2]


def main():
    imgs, _, _ = synth.make_views(n_views=N_VIEWS, shape=SHAPE,
                                  overlap=0.45, seed=7)
    imgs = [(np.asarray(im) * 255).astype(np.uint8) for im in imgs]
    kpts, matches = matching(imgs, seed=0)
    m = idx_to_keypoints(matches, kpts)

    rows = [
        ("none", dict(badjust="none")),
        ("incr_nopolish", dict(badjust="incr", polish=False)),
        ("incr_polish(prod)", dict(badjust="incr", polish=True)),
        ("last_polish", dict(badjust="last", polish=True)),
    ]
    for name, kw in rows:
        t = timed(lambda kw=kw: traverse(imgs, m, **kw))
        print(f"{name:20s} {t:6.3f} s", flush=True)


if __name__ == "__main__":
    main()
