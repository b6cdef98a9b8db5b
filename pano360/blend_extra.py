"""Experimental blenders: full-image warp, graph-cut seams, Laplacian and
Poisson blending.

Re-design of the reference's ``blend.py`` sandbox (blend.py:21-231):

- ``warp``: forward cylindrical/spherical warp of a whole image
  (blend.py:21-45);
- ``alpha_blend``: linear ramp mix (blend.py:48-53);
- ``graph_cut``: max-color-difference seam via the native two-source
  priority flood (C++ in pano360.native, blend.py:56-100);
- ``laplacian_blending``: pyrDown/pyrUp Laplacian pyramids mixed through a
  Gaussian mask pyramid (blend.py:105-140), pure jnp;
- ``poisson_blend``: Poisson image editing. Where the reference builds a
  sparse matrix and calls MKL Pardiso / SuperLU (blend.py:143-203), the
  device formulation solves the same 5-point system *matrix-free* with
  Jacobi-preconditioned conjugate gradient — the Laplacian is a stencil
  convolution; no sparse factorization needed.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from pano360 import geometry as geo
from pano360.ops.filters import pyr_down, pyr_up
from pano360.ops.warp import remap_bilinear
from pano360.native import seam_flood
from pano360.ops.resize import resize_bilinear


def warp(img: np.ndarray, kint: np.ndarray, hom: Optional[np.ndarray] = None,
         projector=geo.SphProj) -> np.ndarray:
    """Warp a full image into spherical/cylindrical coords (blend.py:21-45).

    Returns an RGBA image with transparent background. The reference
    passes ``cv2.INTER_AREA`` to ``cv2.remap`` (blend.py:43), but
    OpenCV's remap does not implement area resampling and silently falls
    back to bilinear (verified: INTER_AREA and INTER_LINEAR outputs are
    bit-identical under 4x minification on this cv2 build), so bilinear
    here IS exact behavioral parity.
    """
    hh, ww = img.shape[:2]
    hom = np.eye(3) if hom is None else hom

    ys, xs = jnp.meshgrid(jnp.arange(hh, dtype=jnp.float32),
                          jnp.arange(ww, dtype=jnp.float32), indexing="ij")
    ones = jnp.ones_like(xs)
    pts = jnp.stack([xs, ys, ones], axis=-1).reshape(-1, 3)
    pts = pts @ jnp.asarray(hom, jnp.float32).T
    kinv = geo.inv3x3(jnp.asarray(kint, jnp.float32))
    pts = pts @ kinv.T
    x_n = projector.proj2hom(pts)
    x_pr = x_n @ jnp.asarray(kint, jnp.float32).T
    x_pr = x_pr[:, :2] / x_pr[:, 2:]
    inb = ((x_pr[:, 0] >= 0) & (x_pr[:, 0] < ww)
           & (x_pr[:, 1] >= 0) & (x_pr[:, 1] < hh))
    qx = jnp.where(inb, x_pr[:, 0], -1.0).reshape(hh, ww)
    qy = jnp.where(inb, x_pr[:, 1], -1.0).reshape(hh, ww)

    rgba = jnp.concatenate([
        jnp.asarray(img, jnp.float32),
        jnp.full((hh, ww, 1), 255.0)], axis=-1)
    out = remap_bilinear(rgba, qx, qy, border="constant", cval=0.0)
    return np.asarray(jnp.clip(out, 0, 255)).astype(np.uint8)


def alpha_blend(img1: np.ndarray, img2: np.ndarray,
                mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Linear-ramp alpha blend (blend.py:48-53)."""
    if mask is None:
        delta = img1.shape[1]
        mask = np.linspace(1, 0, delta).reshape((1, delta, 1))
    return (img1 * mask + img2 * (1 - mask)).astype("uint8")


def graph_cut(img1: np.ndarray, img2: np.ndarray,
              shrink: int = 5) -> np.ndarray:
    """Seam mask between two overlapping images (blend.py:56-100).

    Cost = max channel difference; optional min-pool downsampling; native
    two-source priority flood; returns a uint8 mask (255 = take img1).
    """
    diff = np.max(np.abs(img1.astype(np.float32)
                         - img2.astype(np.float32)), axis=2)
    if img1.shape[2] == 4:   # borders are low priority
        diff[img1[:, :, 3] == 0] = -1
        diff[img2[:, :, 3] == 0] = -1
    if shrink > 1:
        hh, ww = diff.shape
        hh, ww = hh // shrink, ww // shrink
        diff = diff[: shrink * hh, : shrink * ww]
        diff = diff.reshape(hh, shrink, ww, shrink).min(axis=(1, 3))

    border = int(13 / shrink) + 1
    mask = seam_flood(diff, border)

    full = np.asarray(resize_bilinear(
        jnp.asarray((mask == -1).astype(np.float32)), img1.shape[:2]))
    return (full[..., None] * 255).astype("uint8")


def laplacian_blending(img1: np.ndarray, img2: np.ndarray,
                       mask: Optional[np.ndarray] = None,
                       n_levels: int = 6) -> np.ndarray:
    """Laplacian-pyramid blending (blend.py:105-140), pure device code."""
    if mask is None:
        hh, ww, cc = img1.shape
        m = np.linspace(1, -1, ww).reshape((1, ww, 1))
        m = 1.0 / (1 + np.exp(-100 * m))
        mask = np.tile(m, (hh, 1, cc))
    mask = np.asarray(mask, np.float32)
    if mask.ndim == 2:
        mask = mask[..., None]
    if mask.shape[2] == 1:
        mask = np.repeat(mask, img1.shape[2], axis=2)

    a = jnp.asarray(img1, jnp.float32)
    b = jnp.asarray(img2, jnp.float32)
    m = jnp.asarray(mask)

    def gaussian_pyr(x):
        pyr = [x]
        for _ in range(n_levels):
            x = pyr_down(x)
            pyr.append(x)
        return pyr

    def laplacian_pyr(x):
        pyr = gaussian_pyr(x)
        lap = [pyr[-1]]
        for idx in range(n_levels, 0, -1):
            up = pyr_up(pyr[idx], out_shape=pyr[idx - 1].shape[:2])
            lap.append(pyr[idx - 1] - up)
        return lap

    pyr1 = laplacian_pyr(a)
    pyr2 = laplacian_pyr(b)
    pyrm = gaussian_pyr(m)[::-1]

    blended = None
    for la, lb, gm in zip(pyr1, pyr2, pyrm):
        lvl = la * gm + lb * (1.0 - gm)
        if blended is None:
            blended = lvl
        else:
            blended = lvl + pyr_up(blended, out_shape=lvl.shape[:2])
    return np.asarray(jnp.clip(blended, 0, 255)).astype("uint8")


# ---------------------------------------------------------------------------
# Poisson blending via matrix-free CG
# ---------------------------------------------------------------------------

def _laplacian_apply(x: jnp.ndarray, interior: jnp.ndarray) -> jnp.ndarray:
    """Apply the masked 5-point system: A x = 4x - sum(neighbors) on
    interior pixels, x elsewhere (Dirichlet rows)."""
    up = jnp.roll(x, 1, axis=0).at[0, :].set(0)
    dn = jnp.roll(x, -1, axis=0).at[-1, :].set(0)
    lf = jnp.roll(x, 1, axis=1).at[:, 0].set(0)
    rt = jnp.roll(x, -1, axis=1).at[:, -1].set(0)
    lap = 4.0 * x - (up + dn + lf + rt)
    return jnp.where(interior, lap, x)


@functools.partial(jax.jit, static_argnames=("iters",))
def _poisson_cg(src_lap, target, interior, iters: int = 400):
    """Jacobi-preconditioned CG on the masked Poisson system."""
    bb = jnp.where(interior, src_lap, target)
    x0 = target

    def amat(x):
        return _laplacian_apply(x, interior)

    minv = jnp.where(interior, 0.25, 1.0)

    def body(state, _):
        x, r, z, p, rz = state
        ap = amat(p)
        alpha = rz / jnp.maximum(jnp.sum(p * ap), 1e-12)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-12)
        p = z + beta * p
        return (x, r, z, p, rz_new), None

    r0 = bb - amat(x0)
    z0 = minv * r0
    state = (x0, r0, z0, z0, jnp.sum(r0 * z0))
    (x, *_), _ = lax.scan(body, state, None, length=iters)
    return x


def poisson_blend(img_source: np.ndarray, img_target: np.ndarray,
                  img_mask: np.ndarray, iters: int = 400) -> np.ndarray:
    """Poisson editing (blend.py:176-203): paste source gradients into the
    target inside the mask, matching target values at the boundary.

    Matrix-free CG replaces the reference's sparse LU/Pardiso solve.
    """
    mask = np.asarray(img_mask) != 0
    if mask.ndim == 3:
        mask = mask[..., 0]
    interior = jnp.asarray(mask)

    out = np.array(img_target, copy=True)
    for ch in range(img_target.shape[2]):
        src = jnp.asarray(img_source[..., ch], jnp.float32)
        tgt = jnp.asarray(img_target[..., ch], jnp.float32)
        src_lap = _laplacian_apply(src, jnp.ones_like(interior))
        sol = _poisson_cg(src_lap, tgt, interior, iters)
        out[..., ch] = np.clip(np.asarray(sol), 0, 255).astype(
            img_target.dtype)
    return out


__all__ = ["warp", "alpha_blend", "graph_cut", "laplacian_blending",
           "poisson_blend"]


def main():
    """Two-image blend demo (blend.py:206-231 equivalent).

    Renders two synthetic views, warps them, cuts a seam through the
    overlap, Poisson-blends it and saves the concatenated result.
    """
    import numpy as np
    from pano360 import synth
    from pano360.imageio import imwrite
    from pano360.geometry import intrinsics
    import jax.numpy as jnp

    imgs, rots, focal = synth.make_views(n_views=2, shape=(360, 480),
                                         overlap=0.55, seed=0)
    u8 = [(im * 255).astype(np.uint8) for im in imgs]
    kint = np.asarray(intrinsics(jnp.float32(focal), (240.0, 180.0)))
    w1, w2 = warp(u8[0], kint), warp(u8[1], kint)

    delta = 260
    mask = graph_cut(w1[:, -delta:], w2[:, :delta])
    overlap = poisson_blend(w1[:, -delta:, :3], w2[:, :delta, :3].copy(),
                            mask > 127)
    blended = np.concatenate(
        [w1[:, :-delta, :3], overlap, w2[:, delta:, :3]], axis=1)
    imwrite("blend_demo.png", blended)
    print(f"saved blend_demo.png ({blended.shape[1]}x{blended.shape[0]})")


if __name__ == "__main__":
    main()
