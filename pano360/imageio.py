"""Host-side image I/O (no OpenCV dependency in the framework path).

Replaces the reference's ``cv2.imread``/``imwrite``/``imshow`` call sites
(stitcher.py:418-450). Images are kept in the reference's BGR uint8
convention on disk boundaries and float32 BGR in [0, 1] on device, so cache
files and outputs stay structurally identical.

Binary PPM (P6, 8-bit) is read and written with numpy alone; every other
format goes through Pillow, imported only when such a file is touched.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

IMG_EXTS = (".jpg", ".png", ".bmp", ".ppm",
            ".JPG", ".PNG", ".BMP", ".PPM")


def list_images(path: str) -> List[str]:
    """Image files in a directory, sorted (stitcher.py:415-416 semantics)."""
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(IMG_EXTS))


def _is_ppm(path: str) -> bool:
    return path.lower().endswith(".ppm")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "reading or writing this image format needs Pillow "
            "(pip install pillow); binary PPM (.ppm) works without it"
        ) from exc
    return Image


def _ppm_tokens(data: bytes, count: int):
    """First ``count`` header tokens of a PPM (comments skipped) and the
    offset of the single whitespace byte that ends the header."""
    tokens, pos = [], 0
    while len(tokens) < count:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    return tokens, pos


def read_ppm(path: str) -> np.ndarray:
    """Binary 8-bit PPM (P6) -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as fid:
        data = fid.read()
    (magic, w, h, maxval), pos = _ppm_tokens(data, 4)
    if magic != b"P6" or int(maxval) != 255:
        raise ValueError(f"{path}: only binary 8-bit PPM (P6, maxval 255) "
                         f"is supported, got {magic!r} maxval {maxval!r}")
    w, h = int(w), int(h)
    pix = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos + 1)
    return pix.reshape(h, w, 3)


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB -> binary PPM (P6)."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as fid:
        fid.write(b"P6\n%d %d\n255\n" % (w, h))
        fid.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def imread(path: str) -> np.ndarray:
    """Load an image as uint8 BGR (cv2.imread convention)."""
    if _is_ppm(path):
        img = read_ppm(path)
    else:
        img = np.asarray(_pil_image().open(path).convert("RGB"))
    return img[..., ::-1].copy()


def imwrite(path: str, img: np.ndarray) -> None:
    """Save a uint8 BGR image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if _is_ppm(path):
        write_ppm(path, img[..., ::-1])
    else:
        _pil_image().fromarray(img[..., ::-1]).save(path)


__all__ = ["IMG_EXTS", "list_images", "imread", "imwrite", "read_ppm",
           "write_ppm"]
