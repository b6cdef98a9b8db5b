"""Test configuration: CPU backend with a virtual 8-device mesh.

The tests run on the CPU; multi-device sharding paths are exercised against
``--xla_force_host_platform_device_count=8`` virtual CPU devices. Code that
only runs on a GPU is tested on the card by ``chip_smoke.py``. This file
runs before any test module imports jax, so the env vars take effect.
"""
import os
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import jax  # noqa: E402

import pano360  # noqa: E402, F401  (enables the persistent cache)

# No persistent compile cache for the CPU test run: CPU executables are
# tied to this host's CPU features and must not land in the checkout.
jax.config.update("jax_enable_compilation_cache", False)

# Geometry parity tests compare against float64 numpy; enable x64 on the CPU
# test backend. Pipeline code casts to explicit float32 at its entry points,
# so production behavior is unchanged.
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def reference():
    """Importer for modules of the original CPU stitcher (Banus/pano360),
    used only as a golden oracle by the parity tests.

    Skips the test unless ``PANO360_REFERENCE`` names a checkout of it
    (and OpenCV, which it needs, is installed).
    """
    from refcompat import load_reference
    path = os.environ.get("PANO360_REFERENCE", "")
    if not os.path.isdir(path):
        pytest.skip("reference stitcher not available "
                    "(set PANO360_REFERENCE to its checkout)")
    try:
        return load_reference(path)
    except ImportError as exc:
        pytest.skip(f"reference stitcher not importable: {exc}")
