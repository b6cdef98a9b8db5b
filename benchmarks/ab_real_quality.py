"""A/B SIFT front-end knobs on the real-texture world (our side only).

Sweeps ``patch_dtype`` (float32 default vs the bfloat16 opt-in, which
quantizes the descriptor patches) and ``descr_mode`` (the rotated grid
sampler vs cv2-exact dense windows) and prints registration errors +
vs-ground-truth mosaic PSNR per cell. Run:
    python benchmarks/ab_real_quality.py
Optional argv override the swept values (comma lists):
    python benchmarks/ab_real_quality.py float32 grid,dense
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks.compare_quality import psnr_subpixel, reg_errors  # noqa
from benchmarks.real_image import real_world_texture  # noqa


def main():
    from pano360 import render, synth
    from pano360.pipeline import matching, idx_to_keypoints, to_device
    from pano360.register import traverse, PanoImage
    from pano360.features import sift as S
    import pano360.pipeline as pl

    tex = real_world_texture()
    views, rots_gt, focal_gt = synth.make_views(
        n_views=8, shape=(480, 640), overlap=0.5, seed=13, texture=tex)
    imgs = [(v * 255).astype(np.uint8) for v in views]
    dev = to_device(imgs)
    intr_gt = np.diag([focal_gt, focal_gt, 1.0])

    def align_gt(rots_est):
        m = sum(rg.T @ re for re, rg in zip(rots_est, rots_gt))
        uu, _, vt = np.linalg.svd(m)
        g = uu @ vt
        if np.linalg.det(g) < 0:
            g = uu @ np.diag([1, 1, -1]) @ vt
        return [rg @ g for rg in rots_gt]

    dtypes = (sys.argv[1].split(",") if len(sys.argv) > 1
              else ("bfloat16", "float32"))
    dmodes = (sys.argv[2].split(",") if len(sys.argv) > 2
              else ("grid",))
    out = {}
    for patch_dtype in dtypes:
        for dmode in dmodes:
            cfg = S.SiftConfig(patch_dtype=patch_dtype, descr_mode=dmode)
            feats = pl._gray_extract(dev, cfg)
            kpts, matches = matching(imgs, seed=0, dev_images=dev,
                                     feats=feats)
            regs = traverse(imgs, idx_to_keypoints(matches, kpts),
                            badjust="incr")
            m_ours = render.stitch(regs, blender="multiband",
                                   dev_images=dev)
            errs = reg_errors(regs, rots_gt, focal_gt)
            gt_ours = [PanoImage(im.copy(), r.copy(), intr_gt.copy())
                       for im, r in zip(
                           imgs, align_gt([r.rot for r in regs]))]
            m_gt = render.stitch(gt_ours, blender="multiband")
            p, *_ = psnr_subpixel(m_ours, m_gt)
            key = f"{patch_dtype}/{dmode}"
            out[key] = {"placed": len(regs), "vs_gt_db": p, **errs}
            print(key, json.dumps(out[key]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
