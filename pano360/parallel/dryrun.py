"""Multi-device dryrun: the PRODUCTION pipeline on an n-device mesh.

Runs ``pipeline.matching`` (image batches and pair chunks sent to the
devices in turn), ``register.traverse`` (bundle-adjustment
edges sharded, normal equations reduced across the mesh) and
``render.stitch`` (warp and blend sharded over regions) over the mesh, then
asserts the mosaic matches a single-device run of the same functions.

On GPUs it needs n real devices and fails with fewer. With
``JAX_PLATFORMS=cpu`` it is an explicit CPU rehearsal: ``provision`` gives
the CPU backend n virtual devices (``--xla_force_host_platform_device_count``)
before the backend initializes.

Run: ``python -m pano360.parallel.dryrun 4`` (GPUs) or
``JAX_PLATFORMS=cpu python -m pano360.parallel.dryrun 8``.
"""
from __future__ import annotations

import os
import sys


def cpu_rehearsal() -> bool:
    """True when the process is explicitly held to the CPU backend."""
    return os.environ.get("JAX_PLATFORMS", "") == "cpu"


def provision(n_devices: int) -> None:
    """For a CPU rehearsal, ask for n virtual CPU devices; otherwise a
    no-op. Only effective before the backend initializes."""
    if not cpu_rehearsal():
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()


def run(n_devices: int) -> None:
    """Run the PRODUCTION pipeline (matching -> traverse -> stitch) over
    an n-device mesh on tiny shapes and assert the mosaic matches the
    single-device run of the same functions (>= 50 dB PSNR; features and
    matches are bit-identical, and the bundle adjuster's ordered grouped
    reduction — register._group_reduce — keeps the remaining divergence
    small: 69.2 dB on 4 and 76.0 dB on 8 virtual CPU devices)."""
    import numpy as np
    import jax

    from pano360 import render, synth
    from pano360.parallel import make_mesh
    from pano360.pipeline import idx_to_keypoints, matching
    from pano360.register import traverse

    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(jax.devices())} "
            f"({jax.default_backend()}); for a CPU rehearsal set "
            "JAX_PLATFORMS=cpu before the backend initializes")

    mesh = make_mesh(n_devices)
    imgs, _, _ = synth.make_views(
        n_views=n_devices, shape=(64, 96), overlap=0.5, seed=0)
    # production inputs are uint8 BGR (cv2.imread convention)
    imgs = [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]

    def pipeline(use_mesh):
        kpts, matches = matching(imgs, max_kpts=256, seed=0, mesh=use_mesh)
        regions = traverse(imgs, idx_to_keypoints(matches, kpts),
                           badjust="incr", mesh=use_mesh)
        assert regions, "empty match graph in dryrun"
        return render.stitch(regions, blender="multiband", mesh=use_mesh)

    mosaic = pipeline(mesh)
    placed = mosaic.shape
    mosaic0 = pipeline(None)
    assert mosaic.shape == mosaic0.shape, (mosaic.shape, mosaic0.shape)
    diff = mosaic.astype(np.float64) - mosaic0.astype(np.float64)
    mse = float(np.mean(diff * diff))
    psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    assert psnr >= 50.0, f"mesh/single-device mosaic mismatch: {psnr:.1f} dB"
    print(f"dryrun_multichip({n_devices}): ok on platform "
          f"{jax.default_backend()} x{n_devices} — production "
          f"matching/traverse/stitch sharded over the mesh, mosaic "
          f"{placed[1]}x{placed[0]}, parity vs single-device "
          f"{psnr:.1f} dB", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    provision(n)
    run(n)


if __name__ == "__main__":
    main()
