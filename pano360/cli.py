"""Command-line stitcher, flag- and cache-compatible with the reference.

Mirrors ``stitcher.py:390-451``: same flags and defaults
(``-s/--shrink=2``, ``--ba {none,incr,last}=incr``, ``-e/--equalize``,
``-c/--crop``, ``-b/--blend {none,linear,multiband}=multiband``,
``-o/--out``), same cache files (``matches_{name}_s{shrink}.npz`` with
``kpts``/``matches`` object arrays; ``ba_{name}_s{shrink}.pkl`` with the
pickled region list), same stage timing logs. Adds ``--detector`` for the
MSOP path and ``--seed`` for deterministic RANSAC.
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
import sys
from typing import Optional

import numpy as np

from pano360 import render
from pano360.imageio import imread, imwrite, list_images
from pano360.pipeline import idx_to_keypoints, matching
from pano360.profiling import StageTimer, device_trace, profile
from pano360.register import traverse

LOG = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Stitch images.")
    parser.add_argument('path', type=str,
                        help="directory with the images to process.")
    parser.add_argument("-s", "--shrink", type=float, default=2,
                        help="downsample the images by this amount.")
    parser.add_argument("--ba", default="incr",
                        choices=["none", "incr", "last"],
                        help="bundle adjustment type.")
    parser.add_argument("--equalize", "-e", action="store_true",
                        help="equalize image gain before stitching.")
    parser.add_argument("--crop", "-c", action="store_true",
                        help="remove the black borders.")
    parser.add_argument("--blend", "-b", default="multiband",
                        choices=list(render.BLENDERS.keys()),
                        help="blending algorithm.")
    parser.add_argument("-o", "--out", type=str,
                        help="save result to this file")
    parser.add_argument("--detector", default="sift",
                        choices=["sift", "msop"],
                        help="feature detector.")
    parser.add_argument("--seed", type=int, default=0,
                        help="PRNG seed for RANSAC hypothesis sampling.")
    parser.add_argument("--cache-dir", default=".",
                        help="directory for the match/BA cache files.")
    parser.add_argument("--max-resolution", type=int,
                        default=render.MAX_RESOLUTION,
                        help="cap on the mosaic's longest side "
                             "(reference default 1400).")
    parser.add_argument("--projection", default="spherical",
                        choices=["spherical", "cylindrical"],
                        help="output projection surface (the reference "
                             "ships the cylindrical model, "
                             "stitcher.py:90-104, but never wires it).")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard the pipeline over this many devices "
                             "(jax.sharding.Mesh: extraction over images, "
                             "matching over pairs, bundle adjustment over "
                             "edges, warping over regions); 0 = off.")
    parser.add_argument("--show", action="store_true",
                        help="display the mosaic in an image viewer "
                             "(stitcher.py:449-451 equivalent; no-op with "
                             "a warning on headless hosts).")
    parser.add_argument("--profile", action="store_true",
                        help="cProfile the host pipeline and print a "
                             "per-stage wall-clock report.")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="write a jax.profiler device trace "
                             "(TensorBoard format) to this directory.")
    return parser


def load_images(path: str, shrink: float):
    files = list_images(path)
    imgs = [imread(f) for f in files]
    if shrink > 1:
        import jax.numpy as jnp
        from pano360.ops.resize import resize_bilinear
        out = []
        for im in imgs:
            h, w = im.shape[:2]
            nh, nw = round(h / shrink), round(w / shrink)
            small = np.asarray(resize_bilinear(
                jnp.asarray(im.astype(np.float32)), (nh, nw)))
            out.append(np.clip(small, 0, 255).astype(np.uint8))
        imgs = out
    return imgs


def run(args, timer: Optional[StageTimer] = None) -> np.ndarray:
    timer = timer or StageTimer()
    name = (f"{os.path.basename(os.path.normpath(args.path))}"
            f"_s{args.shrink}")
    with timer.stage("Loaded images"):
        imgs = load_images(args.path, args.shrink)

    dev_images = feats = None
    uniform = len({im.shape for im in imgs}) == 1

    mesh = None
    if args.mesh and args.mesh > 1:
        import jax
        from pano360.parallel import make_mesh
        n_dev = len(jax.devices())
        if n_dev < args.mesh:
            raise SystemExit(
                f"--mesh {args.mesh} needs {args.mesh} devices; "
                f"{jax.default_backend()} has {n_dev}")
        mesh = make_mesh(args.mesh)

    match_cache = os.path.join(args.cache_dir, f"matches_{name}.npz")
    try:
        arr = np.load(match_cache, allow_pickle=True)
        kpts, matches = arr["kpts"], arr["matches"]
        if args.detector == "sift" and uniform:
            from pano360.pipeline import to_device
            dev_images = to_device(imgs)   # single host->device upload
    except IOError:
        with timer.stage("Matched features"):
            if args.detector == "sift" and mesh is None:
                from pano360.pipeline import upload_extract
                # upload || extract; dev stack is None for mixed shapes
                dev_images, feats = upload_extract(imgs)
            kpts, matches = matching(imgs, detector=args.detector,
                                     seed=args.seed, dev_images=dev_images,
                                     feats=feats, mesh=mesh)
            np.savez(match_cache, kpts=kpts, matches=matches)

    ba_cache = os.path.join(args.cache_dir, f"ba_{name}.pkl")
    try:
        with open(ba_cache, "rb") as fid:
            regions = pickle.load(fid)
    except IOError:
        with timer.stage("Image registration"):
            regions = traverse(imgs, idx_to_keypoints(matches, kpts),
                               badjust=args.ba, mesh=mesh)
        with open(ba_cache, "wb") as fid:
            pickle.dump(regions, fid, protocol=pickle.HIGHEST_PROTOCOL)

    if not regions:
        raise SystemExit(
            "no connected images: the match graph is empty (need "
            "overlapping views with enough texture)")
    if not regions[0].intr[0, 0] > 0:
        raise SystemExit(
            "registration failed: the median focal estimate is not "
            "positive (spurious pair homographies outvote the true ones)")

    with timer.stage("Built mosaic"):
        mosaic = render.stitch(regions, blender=args.blend,
                               equalize=args.equalize, crop=args.crop,
                               dev_images=dev_images,
                               max_resolution=args.max_resolution,
                               projection=args.projection, mesh=mesh)
    return mosaic


def main(argv=None, timer: Optional[StageTimer] = None):
    """Parse ``argv``, stitch, save/show; returns the mosaic. ``timer``
    collects the per-stage wall times when given."""
    args = build_parser().parse_args(argv)
    timer = timer if timer is not None else StageTimer()
    with device_trace(args.trace_dir):
        if args.profile:
            mosaic = profile(run, args, timer)
        else:
            mosaic = run(args, timer)
    if args.profile:
        print(timer.report())
    if args.out:
        imwrite(args.out, mosaic)
        print(f"saved {args.out} ({mosaic.shape[1]}x{mosaic.shape[0]})")
    if args.show:
        if os.environ.get("DISPLAY") or sys.platform == "darwin":
            from PIL import Image
            Image.fromarray(mosaic[..., ::-1]).show()  # BGR -> RGB
        else:
            LOG.warning("--show: no display available (headless host); "
                        "use -o to save the mosaic instead")
    return mosaic


if __name__ == "__main__":
    logging.basicConfig(level=logging.DEBUG)
    logging.getLogger("jax").setLevel(logging.WARNING)  # silence jax debug
    main()
