"""Gather-based resampling: remap, perspective warp.

Batched replacement for ``cv2.remap`` / ``cv2.warpPerspective``
(stitcher.py:315, stitcher.py:56, features.py:122, blend.py:43). The core is
a bilinear gather over a statically shaped query grid; border handling is
done by index arithmetic (reflection/clamping) rather than padding, so
arbitrarily out-of-range coordinates cost nothing extra.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from pano360.geometry import inv3x3


def reflect_index(idx: jnp.ndarray, n: int, mode: str = "reflect"):
    """Fold integer indices into ``[0, n)`` according to a border mode.

    ``reflect``    cv2.BORDER_REFLECT     (fedcba|abcdefgh|hgfedcb)
    ``reflect101`` cv2.BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)
    ``replicate``  cv2.BORDER_REPLICATE   (clamp)
    """
    if n == 1:
        return jnp.zeros_like(idx)
    if mode == "replicate":
        return jnp.clip(idx, 0, n - 1)
    if mode == "reflect":
        period = 2 * n
        m = jnp.mod(idx, period)
        return jnp.where(m < n, m, period - 1 - m)
    if mode == "reflect101":
        period = 2 * n - 2
        m = jnp.mod(idx, period)
        return jnp.where(m < n, m, period - m)
    raise ValueError(f"unknown border mode {mode!r}")


def remap_bilinear(img: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray,
                   border: str = "reflect", cval: float = 0.0):
    """Bilinear resampling of ``img`` at float coordinates, like ``cv2.remap``.

    ``img``: (H, W) or (H, W, C); ``map_x``/``map_y``: query arrays of any
    (matching) shape giving source x/y in pixel units. Returns samples with
    shape ``map_x.shape (+ (C,))``.

    ``border='constant'`` fills out-of-range queries with ``cval`` using the
    same convention as cv2 (a query is outside once the *sample* footprint
    leaves the image; partial footprints blend with the constant).
    """
    img = jnp.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    dtype = img.dtype
    qshape = map_x.shape

    x = map_x.reshape(-1).astype(dtype)
    y = map_y.reshape(-1).astype(dtype)

    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    if border == "constant":
        ix0 = jnp.clip(x0, 0, w - 1)
        ix1 = jnp.clip(x0 + 1, 0, w - 1)
        iy0 = jnp.clip(y0, 0, h - 1)
        iy1 = jnp.clip(y0 + 1, 0, h - 1)
        vx0 = (x0 >= 0) & (x0 <= w - 1)
        vx1 = (x0 + 1 >= 0) & (x0 + 1 <= w - 1)
        vy0 = (y0 >= 0) & (y0 <= h - 1)
        vy1 = (y0 + 1 >= 0) & (y0 + 1 <= h - 1)
    else:
        ix0 = reflect_index(x0, w, border)
        ix1 = reflect_index(x0 + 1, w, border)
        iy0 = reflect_index(y0, h, border)
        iy1 = reflect_index(y0 + 1, h, border)

    flat = img.reshape(h * w, c)
    g00 = flat[iy0 * w + ix0]
    g01 = flat[iy0 * w + ix1]
    g10 = flat[iy1 * w + ix0]
    g11 = flat[iy1 * w + ix1]

    if border == "constant":
        cfill = jnp.asarray(cval, dtype)
        g00 = jnp.where((vy0 & vx0)[:, None], g00, cfill)
        g01 = jnp.where((vy0 & vx1)[:, None], g01, cfill)
        g10 = jnp.where((vy1 & vx0)[:, None], g10, cfill)
        g11 = jnp.where((vy1 & vx1)[:, None], g11, cfill)

    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    out = top * (1 - fy) + bot * fy

    out = out.reshape(qshape + (c,))
    return out[..., 0] if squeeze else out


def warp_perspective(img: jnp.ndarray, hom: jnp.ndarray, out_shape,
                     border: str = "constant", cval: float = 0.0,
                     inverse: bool = False):
    """Apply a perspective transform like ``cv2.warpPerspective``.

    ``hom`` maps *source* pixel coords to *destination* coords (cv2
    convention); sampling inverts it unless ``inverse=True`` (equivalent to
    cv2's WARP_INVERSE_MAP).  ``out_shape``: (height, width).
    """
    oh, ow = out_shape
    m = jnp.asarray(hom)
    if not inverse:
        m = inv3x3(m)
    m = m.astype(jnp.float32)
    ys, xs = jnp.meshgrid(jnp.arange(oh, dtype=jnp.float32),
                          jnp.arange(ow, dtype=jnp.float32), indexing="ij")
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    sz = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    inv_z = jnp.where(sz != 0, 1.0 / sz, 0.0)
    return remap_bilinear(img, sx * inv_z, sy * inv_z, border=border,
                          cval=cval)


__all__ = ["reflect_index", "remap_bilinear", "warp_perspective"]
