"""Native (C++) host-side components, built on demand with g++.

The device compute path is JAX/XLA; these are the *host* sequential
hot loops where the reference leaned on native code too (Numba-JIT crop,
stitcher.py:330-369; heapq seam flood, blend.py:56-100). A pure-Python
fallback keeps the framework importable if no compiler is available,
mirroring the reference's optional-Numba behavior (``try_jit``).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

LOG = logging.getLogger(__name__)
_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "crop.cpp")
_CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    """The library's path, keyed by a hash of the tracked source and the
    compiler flags: a library built from any other source is never
    loaded, whatever its timestamp."""
    with open(_SRC, "rb") as fid:
        key = hashlib.sha256(fid.read() + " ".join(_CXXFLAGS).encode())
    return os.path.join(_DIR, f"libpanonative-{key.hexdigest()[:16]}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = lib_path()
        if not os.path.exists(path):
            # build under a private name, then rename: concurrent
            # processes never load a half-written library
            tmp = f"{path}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_CXXFLAGS, _SRC, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.largest_rectangle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.seam_flood.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int8)]
        lib.ssc_select.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int)]
        lib.ssc_select.restype = ctypes.c_int
        _lib = lib
    except (subprocess.CalledProcessError, OSError) as exc:
        LOG.warning("native build failed (%s); using Python fallback", exc)
    return _lib


def largest_rectangle(valid: np.ndarray):
    """Maximal all-valid rectangle bounds (top, left, bottom, right)."""
    valid = np.ascontiguousarray(valid.astype(np.uint8))
    h, w = valid.shape
    lib = _build()
    if lib is not None:
        out = (ctypes.c_int * 4)()
        lib.largest_rectangle(
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h, w, out)
        return out[0], out[1], out[2], out[3]
    return _largest_rectangle_py(valid)


def _largest_rectangle_py(valid: np.ndarray):
    """Pure-Python fallback (same histogram/stack algorithm)."""
    h, w = valid.shape
    heights = np.zeros(w, np.int64)
    best = (0, 0, 0, -1, -1)
    for i in range(h):
        heights = np.where(valid[i], heights + 1, 0)
        stack = []
        for j in range(w + 1):
            hh = heights[j] if j < w else 0
            while stack and heights[stack[-1]] >= hh:
                k = stack.pop()
                hk = int(heights[k])
                lk = stack[-1] + 1 if stack else 0
                area = hk * (j - lk)
                if area > best[0]:
                    best = (area, i - hk + 1, lk, i, j - 1)
            stack.append(j)
    return best[1], best[2], best[3], best[4]


def crop_mosaic(mosaic: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Crop to the largest fully valid rectangle (stitcher.py:341-369)."""
    top, left, bottom, right = largest_rectangle(valid)
    if bottom < top or right < left:
        return mosaic
    return mosaic[top:bottom + 1, left:right + 1]


def seam_flood(diff: np.ndarray, border: int) -> np.ndarray:
    """Two-source priority flood for graph-cut style seams (blend.py:56-100).

    Returns an int8 mask of -1 (left source) / +1 (right source).
    """
    diff = np.ascontiguousarray(diff.astype(np.float32))
    rows, cols = diff.shape
    mask = np.zeros((rows, cols), np.int8)
    lib = _build()
    if lib is not None:
        lib.seam_flood(
            diff.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows, cols, border,
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        return mask
    return _seam_flood_py(diff, border)


def _seam_flood_py(diff: np.ndarray, border: int) -> np.ndarray:
    import heapq
    rows, cols = diff.shape
    mask = np.zeros((rows, cols), np.int32)
    mask[:, :border] = -1
    mask[:, cols - border + 1:] = 1
    qq = []
    for y in range(rows):
        qq.append((-1e3, -1, border, y))
        qq.append((-1e3, 1, cols - border, y))
    heapq.heapify(qq)
    dd = [[0, 1], [0, -1], [1, 0], [-1, 0]]
    while qq:
        _, clr, x, y = heapq.heappop(qq)
        if mask[y, x] != 0:
            continue
        mask[y, x] = clr
        for dx, dy in dd:
            nx, ny = x + dx, y + dy
            if 0 <= nx < cols and 0 <= ny < rows and mask[ny, nx] == 0:
                heapq.heappush(qq, (-diff[ny, nx], clr, nx, ny))
    return mask.astype(np.int8)


def ssc_select(kpts_xy: np.ndarray, im_size, n_points: int,
               tol: float = 0.1):
    """SSC adaptive NMS over score-ordered keypoints (C++ fast path).

    Returns selected indices, or None when the native library is
    unavailable (caller falls back to the Python implementation).
    The greedy cover pass is a sequential loop over up to ~100k
    candidates per MSOP pyramid level — the dominant host cost of the
    MSOP detector when run in Python.
    """
    lib = _build()
    if lib is None:
        return None
    kp = np.ascontiguousarray(kpts_xy, np.float32)
    out = np.empty(len(kp), np.int32)
    cols, rows = im_size
    n = lib.ssc_select(
        kp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(kp),
        int(cols), int(rows), int(n_points), float(tol),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out[:n].copy()


__all__ = ["largest_rectangle", "crop_mosaic", "seam_flood", "ssc_select"]
