"""Standalone feature extraction + matching CLI (features.py:303-321 parity).

Extracts and matches at half resolution, writing ``matches_{name}.npz`` in
the reference's exact cache format.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from pano360.cli import load_images
from pano360.pipeline import matching


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract features.")
    parser.add_argument("--path", type=str, default="../data/ppwwyyxx/CMU2",
                        help="directory with the images to process.")
    parser.add_argument("--detector", default="sift",
                        choices=["sift", "msop"])
    parser.add_argument("--visualize", nargs=2, type=int, default=None,
                        metavar=("I", "J"),
                        help="write a match-overlay image for pair (I, J) "
                             "(the reference's match_images one-shot check, "
                             "features.py:286-299).")
    args = parser.parse_args(argv)

    name = os.path.basename(args.path)
    imgs = load_images(args.path, shrink=2)   # half resolution
    kpts, matches = matching(imgs, detector=args.detector)
    np.savez(f"matches_{name}.npz", kpts=kpts, matches=matches)
    print(f"saved matches_{name}.npz")

    if args.visualize is not None:
        i, j = args.visualize
        md = matches.item() if hasattr(matches, "item") else matches
        if i not in md or j not in md[i]:
            raise SystemExit(f"no match edge between images {i} and {j}")
        from pano360.imageio import imwrite
        from pano360.viz import match_images
        idx, _ = md[i][j]
        cent_i = np.array([imgs[i].shape[1] / 2, imgs[i].shape[0] / 2])
        cent_j = np.array([imgs[j].shape[1] / 2, imgs[j].shape[0] / 2])
        overlay = match_images(imgs[i], imgs[j],
                               kpts[i][idx[:, 0]] + cent_i,
                               kpts[j][idx[:, 1]] + cent_j)
        out = f"matches_{name}_{i}_{j}.png"
        imwrite(out, overlay)
        print(f"saved {out} ({len(idx)} inlier matches)")


if __name__ == "__main__":
    logging.basicConfig(level=logging.DEBUG)
    logging.getLogger("jax").setLevel(logging.WARNING)
    main()
