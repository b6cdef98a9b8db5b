"""Attribute cold-start cost: device init vs per-stage XLA compiles.

The first run in a fresh process compiles every program; this probe
separates what that time is made of, at run_configs.py config 1's shapes
(6 views, 300x400 after shrink 2):

  - device init + first trivial dispatch
  - SIFT extract compile (the big program) + match graph
  - traverse / stitch compiles

Run with a FRESH compile cache to see true cold time:
  JAX_COMPILATION_CACHE_DIR=<empty dir> python benchmarks/profile_cold.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    t_start = time.time()
    import numpy as np
    import jax
    import jax.numpy as jnp

    t0 = time.time()
    np.asarray(jnp.zeros((8, 128)) + 1.0)
    t_init = time.time() - t0
    print(f"device init + first trivial dispatch: {t_init:7.1f}s",
          flush=True)

    from pano360 import synth
    from pano360.pipeline import matching, idx_to_keypoints
    from pano360.register import traverse
    from pano360 import render

    imgs, _, _ = synth.make_views(n_views=6, shape=(600, 800),
                                  overlap=0.5, seed=10)
    imgs = [(im[::2, ::2] * 255).astype(np.uint8) for im in imgs]

    t0 = time.time()
    kpts, matches = matching(imgs, seed=0)
    t_match = time.time() - t0
    print(f"matching cold (SIFT + match graph): {t_match:7.1f}s",
          flush=True)

    t0 = time.time()
    regions = traverse(imgs, idx_to_keypoints(matches, kpts),
                       badjust="none")
    t_trav = time.time() - t0
    print(f"traverse cold (ba none): {t_trav:7.1f}s", flush=True)

    t0 = time.time()
    render.stitch(regions, blender="linear")
    t_stitch = time.time() - t0
    print(f"stitch cold (linear): {t_stitch:7.1f}s", flush=True)
    print(f"TOTAL (incl. imports): {time.time() - t_start:7.1f}s",
          flush=True)


if __name__ == "__main__":
    main()
