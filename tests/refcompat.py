"""Import helper for the original CPU stitcher (Banus/pano360).

The reference targets an old OpenCV (``cv2.xfeatures2d.SIFT_create``) and an
old numpy (``np.object``). Shim both so its modules import under the modern
stack — used only to generate golden outputs for parity tests, never as part
of the framework. Its checkout is found through the ``reference`` fixture in
``conftest.py``.
"""
import importlib
import sys
import types

import numpy as np


def load_reference(path: str):
    """Put the reference checkout at ``path`` on ``sys.path`` (with the
    cv2/numpy shims) and return an importer for its modules
    (features/stitcher/bundle_adj/blend). Raises ImportError when OpenCV
    is missing."""
    import cv2

    if not hasattr(cv2, "xfeatures2d"):
        cv2.xfeatures2d = types.SimpleNamespace(SIFT_create=cv2.SIFT_create)
    if "object" not in np.__dict__:  # hasattr would trip the FutureWarning
        np.object = object  # removed in numpy>=1.24; reference uses np.object
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module
