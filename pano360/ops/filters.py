"""Separable filters, pyramids and corner responses on device.

Device replacements for the reference's OpenCV C++ filter calls
(``cv2.GaussianBlur``, ``cv2.Sobel``, ``cv2.cornerHarris``, ``cv2.pyrDown``,
``cv2.pyrUp``, ``scipy.ndimage.maximum_filter`` — see SURVEY.md §2b).
Everything is expressed as XLA convolutions / reduce-windows over statically
shaped arrays so the compiler can fuse and tile them; batching is a leading
``vmap`` axis.

Layout convention: public functions accept ``(H, W)``, ``(H, W, C)`` or
``(N, H, W, C)`` float arrays and filter over the two spatial dims.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

_BORDER_TO_PAD = {
    "reflect101": "reflect",   # cv2.BORDER_REFLECT_101 (default):  gfedcb|abcd
    "reflect": "symmetric",    # cv2.BORDER_REFLECT:                fedcba|abcd
    "replicate": "edge",       # cv2.BORDER_REPLICATE
    "constant": "constant",
}


# ---------------------------------------------------------------------------
# Kernel construction (cv2-compatible rules)
# ---------------------------------------------------------------------------

def gaussian_kernel1d(sigma: float, ksize: int, dtype=jnp.float32):
    """1-D Gaussian kernel identical to ``cv2.getGaussianKernel``.

    ``exp(-(x - (k-1)/2)^2 / (2 sigma^2))`` normalized to sum 1; when
    ``sigma <= 0`` cv2 derives it as ``0.3*((ksize-1)*0.5 - 1) + 0.8``.
    """
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    # static constant: build in f64 numpy at trace time, ship as `dtype`
    import numpy as np
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return jnp.asarray(k / np.sum(k), dtype=dtype)


def auto_ksize(sigma: float, depth8u: bool = False) -> int:
    """cv2.GaussianBlur's automatic kernel size for ``ksize=(0, 0)``.

    ``round(sigma * (3 if 8U else 4) * 2 + 1) | 1`` — used by the reference's
    multi-band blender (stitcher.py:226 on float images).
    """
    k = int(round(sigma * (3 if depth8u else 4) * 2 + 1))
    return k | 1


def feature_ksize(sigma: float) -> int:
    """The reference feature path's kernel-size rule (features.py:23-24)."""
    ksz = max(int((sigma - 0.35) / 0.15), 1)
    return ksz + (not ksz % 2)


# ---------------------------------------------------------------------------
# Core separable convolution
# ---------------------------------------------------------------------------

def _normalize(img):
    """Reshape any supported layout to (B, H, W); return restore fn."""
    img = jnp.asarray(img)
    if img.ndim == 2:
        return img[None], lambda y: y[0]
    if img.ndim == 3:  # (H, W, C) -> channels as batch
        return jnp.moveaxis(img, -1, 0), lambda y: jnp.moveaxis(y, 0, -1)
    if img.ndim == 4:  # (N, H, W, C)
        n, h, w, c = img.shape
        flat = jnp.moveaxis(img, -1, 1).reshape(n * c, h, w)
        def restore(y):
            return jnp.moveaxis(y.reshape(n, c, y.shape[1], y.shape[2]), 1, -1)
        return flat, restore
    raise ValueError(f"unsupported image rank {img.ndim}")


def _conv_axis(img_bhw, kernel, axis: int, border: str, cval=0.0):
    """Correlate (B, H, W) along one spatial axis with a 1-D kernel."""
    k = kernel.shape[0]
    if k == 1:
        return img_bhw * kernel[0]
    lo = (k - 1) // 2
    hi = k - 1 - lo
    pad = [(0, 0), (0, 0), (0, 0)]
    pad[axis] = (lo, hi)
    mode = _BORDER_TO_PAD[border]
    if mode == "constant":
        padded = jnp.pad(img_bhw, pad, mode=mode, constant_values=cval)
    else:
        padded = jnp.pad(img_bhw, pad, mode=mode)
    # 1-D correlation as a sum of shifted slices: XLA fuses this into a
    # single vectorized expression; for the small/medium kernels used here
    # this beats spawning a conv custom-call and keeps dtype flexibility.
    n = img_bhw.shape[axis]
    out = None
    for i in range(k):
        sl = [slice(None)] * 3
        sl[axis] = slice(i, i + n)
        term = padded[tuple(sl)] * kernel[i]
        out = term if out is None else out + term
    return out


def sep_filter2d(img, kx, ky, border: str = "reflect101"):
    """Separable 2-D correlation (``ky`` over rows, ``kx`` over cols)."""
    flat, restore = _normalize(img)
    kx = jnp.asarray(kx, dtype=flat.dtype)
    ky = jnp.asarray(ky, dtype=flat.dtype)
    out = _conv_axis(_conv_axis(flat, ky, 1, border), kx, 2, border)
    return restore(out)


def gaussian_blur(img, sigma: float, ksize: Optional[int] = None,
                  border: str = "reflect101"):
    """cv2.GaussianBlur-compatible separable Gaussian smoothing.

    ``ksize=None`` applies cv2's automatic rule for float images
    (``auto_ksize``). Use ``feature_ksize(sigma)`` for the feature-path rule.
    """
    if ksize is None:
        ksize = auto_ksize(sigma)
    flat, restore = _normalize(img)
    k = gaussian_kernel1d(sigma, ksize, dtype=flat.dtype)
    out = _conv_axis(_conv_axis(flat, k, 1, border), k, 2, border)
    return restore(out)


def box_filter(img, size: int, border: str = "reflect101",
               normalize: bool = False):
    """Box filter (running sum) over a ``size x size`` window.

    cv2.cornerHarris uses an *unnormalized* box sum; for even sizes cv2's
    anchor makes output(y, x) sum the window *ending* at (y, x), which we
    reproduce via asymmetric padding (verified against cv2 numerically).
    """
    flat, restore = _normalize(img)
    k = jnp.ones((size,), dtype=flat.dtype)
    if normalize:
        k = k / size
    lo = size // 2
    hi = size - 1 - lo

    def conv(x, axis):
        n = x.shape[axis]
        pad = [(0, 0)] * 3
        pad[axis] = (lo, hi)  # anchor offset: more padding before
        padded = jnp.pad(x, pad, mode=_BORDER_TO_PAD[border])
        out = None
        for i in range(size):
            sl = [slice(None)] * 3
            sl[axis] = slice(i, i + n)
            term = padded[tuple(sl)] * k[i]
            out = term if out is None else out + term
        return out

    return restore(conv(conv(flat, 1), 2))


# ---------------------------------------------------------------------------
# Derivatives / corner response
# ---------------------------------------------------------------------------

_SOBEL_D = (-1.0, 0.0, 1.0)
_SOBEL_S = (1.0, 2.0, 1.0)


def sobel(img, dx: int, dy: int, border: str = "reflect101"):
    """3x3 Sobel derivative, matching ``cv2.Sobel(..., ksize=3)``."""
    assert (dx, dy) in ((1, 0), (0, 1)), "only first derivatives supported"
    flat, restore = _normalize(img)
    d = jnp.asarray(_SOBEL_D, dtype=flat.dtype)
    s = jnp.asarray(_SOBEL_S, dtype=flat.dtype)
    if dx:
        out = _conv_axis(_conv_axis(flat, s, 1, border), d, 2, border)
    else:
        out = _conv_axis(_conv_axis(flat, d, 1, border), s, 2, border)
    return restore(out)


def harris_response(gray, block_size: int = 2, k: float = 0.04,
                    border: str = "reflect101"):
    """Harris corner response, matching ``cv2.cornerHarris(block, 3, k)``.

    Structure tensor from 3x3 Sobel gradients scaled like cv2
    (``scale = 1/(2**(ksize-1) * block_size) ; sobel *= scale``), summed over
    a ``block_size`` window (unnormalized box filter), then
    ``det(M) - k trace(M)^2``. (features.py:140 uses blockSize=2, k=0.04.)
    """
    # cv2's scale: 1/(2^(ksize-1) * blockSize), with an extra 1/255 only for
    # 8-bit inputs; our images are float already.
    scale = 1.0 / ((1 << (3 - 1)) * block_size)
    gx = sobel(gray, 1, 0, border) * scale
    gy = sobel(gray, 0, 1, border) * scale
    gxx = box_filter(gx * gx, block_size, border)
    gyy = box_filter(gy * gy, block_size, border)
    gxy = box_filter(gx * gy, block_size, border)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    return det - k * tr * tr


def max_pool3x3(img, border: str = "reflect101"):
    """3x3 max filter (scipy ``maximum_filter(size=3)`` equivalent)."""
    flat, restore = _normalize(img)
    pad = jnp.pad(flat, [(0, 0), (1, 1), (1, 1)],
                  mode=_BORDER_TO_PAD[border])
    out = lax.reduce_window(pad, -jnp.inf, lax.max,
                            window_dimensions=(1, 3, 3),
                            window_strides=(1, 1, 1), padding="VALID")
    return restore(out)


# ---------------------------------------------------------------------------
# Image pyramids
# ---------------------------------------------------------------------------

_PYR_K = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # [1 4 6 4 1] / 16


def pyr_down(img, border: str = "reflect101"):
    """Gaussian 5-tap downsample, matching ``cv2.pyrDown`` (odd sizes too)."""
    flat, restore = _normalize(img)
    k = jnp.asarray(_PYR_K, dtype=flat.dtype)
    blurred = _conv_axis(_conv_axis(flat, k, 1, border), k, 2, border)
    return restore(blurred[:, ::2, ::2])


def pyr_up(img, out_shape: Optional[Tuple[int, int]] = None,
           border: str = "reflect101"):
    """Zero-stuffed 5-tap upsample, matching ``cv2.pyrUp``."""
    flat, restore = _normalize(img)
    b, h, w = flat.shape
    oh, ow = out_shape if out_shape is not None else (2 * h, 2 * w)
    up = jnp.zeros((b, oh, ow), dtype=flat.dtype)
    up = up.at[:, ::2, ::2].set(flat[:, : (oh + 1) // 2, : (ow + 1) // 2])
    k = jnp.asarray(_PYR_K, dtype=flat.dtype) * 2.0
    out = _conv_axis(_conv_axis(up, k, 1, border), k, 2, border)
    return restore(out)


__all__ = [
    "gaussian_kernel1d", "auto_ksize", "feature_ksize", "sep_filter2d",
    "gaussian_blur", "box_filter", "sobel", "harris_response",
    "max_pool3x3", "pyr_down", "pyr_up",
]
