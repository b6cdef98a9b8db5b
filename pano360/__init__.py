"""pano360: a batched JAX panorama stitching framework.

A from-scratch JAX / XLA re-design of the capabilities of Banus/pano360:
SIFT & MSOP feature extraction, brute-force matmul descriptor matching,
massively parallel RANSAC homography estimation, incremental
Levenberg-Marquardt bundle adjustment, exposure compensation,
spherical/cylindrical backward warping and none/linear/multiband blending —
with native C++ components for the sequential host-side hot loops and
``shard_map`` scale-out over device meshes.
"""

__version__ = "0.1.0"

import os as _os

# the persistent compile cache's home when JAX_COMPILATION_CACHE_DIR is
# unset: one fixed path inside the checkout (the path is part of the
# cache key, so a directory that moves never hits)
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``DEFAULT_CACHE_DIR``."""
    environ = _os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def _enable_compile_cache():
    """Turn on JAX's persistent compilation cache for every program.

    The pipeline dispatches ~30 distinct programs, many sub-second to
    compile, so the size/time thresholds are zeroed: a second process
    at the same shapes loads every program instead of compiling it.
    """
    import jax
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()

from pano360 import geometry  # noqa: F401, E402
