"""Image resizing (bilinear / area) matching cv2 semantics.

Replaces the reference's host-side ``cv2.resize`` calls
(stitcher.py:419-421, features.py:318) with device code so image shrink can
run on the device alongside the rest of the pipeline.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from pano360.ops.warp import remap_bilinear


def resize_bilinear(img: jnp.ndarray, out_shape):
    """Bilinear resize to ``(height, width)``, cv2.INTER_LINEAR convention.

    cv2 maps destination pixel centers to source coordinates via
    ``src = (dst + 0.5) * scale - 0.5`` and clamps the sample footprint to
    the image (replicate border).
    """
    oh, ow = out_shape
    h, w = img.shape[:2]
    sy = h / oh
    sx = w / ow
    ys = (jnp.arange(oh, dtype=jnp.float32) + 0.5) * sy - 0.5
    xs = (jnp.arange(ow, dtype=jnp.float32) + 0.5) * sx - 0.5
    my, mx = jnp.meshgrid(ys, xs, indexing="ij")
    return remap_bilinear(img, mx, my, border="replicate")


def upsample2x_bilinear(img: jnp.ndarray) -> jnp.ndarray:
    """Exact 2x bilinear upsample of (..., H, W) without gathers.

    cv2's INTER_LINEAR at fx=fy=2 reduces to a fixed 2-phase FIR:
    even outputs = 0.75*x[i] + 0.25*x[i-1], odd = 0.75*x[i] + 0.25*x[i+1]
    (edges clamped) — pure shifted adds, no remap gather as in the general
    resize.
    """
    def up_axis(x, axis):
        lo = jnp.concatenate([lax.slice_in_dim(x, 0, 1, axis=axis),
                              lax.slice_in_dim(x, 0, x.shape[axis] - 1,
                                               axis=axis)], axis=axis)
        hi = jnp.concatenate([lax.slice_in_dim(x, 1, x.shape[axis],
                                               axis=axis),
                              lax.slice_in_dim(x, x.shape[axis] - 1,
                                               x.shape[axis], axis=axis)],
                             axis=axis)
        even = 0.75 * x + 0.25 * lo
        odd = 0.75 * x + 0.25 * hi
        stacked = jnp.stack([even, odd], axis=axis + 1 if axis >= 0
                            else x.ndim + axis + 1)
        new_shape = list(x.shape)
        ax = axis if axis >= 0 else x.ndim + axis
        new_shape[ax] *= 2
        return stacked.reshape(new_shape)

    return up_axis(up_axis(img, -2), -1)


def shrink_area(img: jnp.ndarray, factor: int):
    """Integer-factor area downsample (mean pool), cv2.INTER_AREA for ints."""
    h, w = img.shape[:2]
    nh, nw = h // factor, w // factor
    crop = img[: nh * factor, : nw * factor]
    if img.ndim == 2:
        return crop.reshape(nh, factor, nw, factor).mean(axis=(1, 3))
    c = img.shape[2]
    return crop.reshape(nh, factor, nw, factor, c).mean(axis=(1, 3))


__all__ = ["resize_bilinear", "upsample2x_bilinear", "shrink_area"]
