"""Batched SIFT feature extraction in pure JAX.

Batched replacement for the reference's OpenCV SIFT
(``features.py:192-201`` -> ``cv2.xfeatures2d.SIFT``): the Gaussian
scale-space, DoG pyramid, 26-neighbour extrema detection, iterative subpixel
refinement, contrast/edge rejection, orientation histograms and 128-d
descriptors are all expressed as statically shaped XLA programs batched over
images. Keypoint buffers are fixed-capacity with validity masks (SURVEY.md §7
hard part #2).

Algorithmic parity follows OpenCV's SIFT (Lowe 2004):

- base image upscaled 2x, assumed camera blur 0.5, base sigma 1.6;
- ``n_layers`` (3) scales per octave, S+3 Gaussian / S+2 DoG images;
- extrema: |DoG| > 0.5*contrast_thresh/S and 26-neighbour max/min;
- up to 5 Newton iterations of subpixel refinement with integer re-centering,
  contrast (|c|*S >= CT) and edge (tr^2/det < (r+1)^2/r, r=10) tests;
- orientation: 36-bin gradient histogram over an exact integer-pixel window
  of radius round(4.5 sigma), Gaussian-weighted, 5-tap smoothed, up to 2
  peaks >= 0.8*max (cv2-style duplication);
- descriptor: 4x4x8 trilinear binning, two modes (``descr_mode``):
  ``grid`` samples a rotated 16x16 grid with bilinear interpolation
  (sigma-scaled; the standard vectorized-SIFT deviation from cv2), and
  ``dense`` reproduces cv2's exact semantics -- every integer pixel in
  the rotated window around the ROUNDED keypoint center contributes its
  own central-difference gradient, masked by the (-1, d) bin bounds
  (sift.cpp calcSIFTDescriptor; parity is judged downstream on match
  graphs / mosaics per SURVEY.md §7 hard part #1);
- RootSIFT normalization (features.py:198) is applied by the caller.

Keypoint coordinates are returned in original-image pixels.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pano360.geometry import det3x3, inv3x3
from pano360.ops.filters import gaussian_blur
from pano360.ops.resize import upsample2x_bilinear


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    n_layers: int = 3            # scales per octave (cv2 nOctaveLayers)
    sigma: float = 1.6           # base blur
    init_sigma: float = 0.5      # assumed camera blur
    contrast_thresh: float = 0.04
    edge_thresh: float = 10.0
    upscale: bool = True         # cv2 firstOctave = -1
    max_kpts: int = 4096         # global keypoint capacity
    img_border: int = 5          # SIFT_IMG_BORDER
    refine_iters: int = 5
    n_orientations: int = 2      # duplicated keypoints per extra peak
    ori_bins: int = 36
    ori_radius: int = 16         # max integer window radius (sigma<=3.6)
    descr_width: int = 4         # 4x4 spatial bins
    descr_ori_bins: int = 8
    descr_samples: int = 16      # 16x16 rotated sample grid
    descr_mag_thresh: float = 0.2
    # scale-space construction: "incremental" (default) = the cv2-parity
    # chain of per-layer blurs (a sequential 2*(S+2)-pass dependency
    # chain); "direct" = every layer from the shared base as fused slice
    # sums (_gaussian_stack_direct). Their speed on the GPU is not
    # measured.
    gauss_mode: str = os.environ.get("PANO_SIFT_GAUSS", "incremental")
    # dtype of the per-keypoint gradient patches and the one-hot
    # sampling matmuls. float32 is the default: a bfloat16 A/B on the
    # real-texture quality gate (benchmarks/ab_real_quality.py) raised
    # the mean relative-rotation error and lowered the vs-ground-truth
    # mosaic PSNR, and registration accuracy is the framework's core
    # quality. bfloat16 (PANO_SIFT_PATCH_DTYPE=bfloat16) halves the
    # bytes of the biggest keypoint-stage buffers for throughput-first
    # workloads; its speed on the GPU is not measured.
    patch_dtype: str = os.environ.get("PANO_SIFT_PATCH_DTYPE",
                                      "float32")
    # post-refinement compaction: octaves with >=1024 candidate slots
    # keep only the top max(cap >> sel_shift, 512) surviving candidates
    # by |contrast| before the (heavy) patch/orientation/descriptor
    # stages. Raw DoG candidates outnumber refinement survivors ~10x
    # (the budgets saturate with low-contrast extrema the Newton step
    # rejects), so without compaction ~75% of the descriptor work is on
    # dead slots.
    sel_shift: int = 2
    # descriptor sampling: "grid" = rotated 16x16 bilinear sample grid
    # (two one-hot GEMMs per keypoint, the round-1..4 default), "dense"
    # = cv2's exact integer-window semantics: every pixel of the
    # (2*40)^2 gradient patch contributes its own exact gradient,
    # masked by the rotated (-1, d) bin bounds around the ROUNDED
    # center (sift.cpp calcSIFTDescriptor). Dense needs no sampling
    # GEMMs at all but bins 25x more samples per keypoint.
    descr_mode: str = os.environ.get("PANO_SIFT_DESCR", "grid")

    @property
    def patch_half(self) -> int:
        """Half-extent of the per-keypoint patch for the current mode.

        grid: 32 (see the _PATCH_HALF derivation). dense: cv2's window
        radius is hist_width*sqrt(2)*(d+1)/2 = 38.1 px at the max
        octave-relative sigma 3.592, and the (-1, d) bin mask keeps
        pixels up to 2.5*sqrt(2)*hist_width = 38.1 px from the rounded
        center; half = 40 covers it (gradient interior reach 39).
        """
        return _PATCH_HALF if self.descr_mode == "grid" else 40

    @property
    def dim(self) -> int:
        return self.descr_width * self.descr_width * self.descr_ori_bins


# jax.named_scope of the Gaussian scale space (base blur, per-octave
# stacks and DoG), so a device trace can attribute its kernels
GAUSS_SCOPE = "sift_gauss_dog"


class SiftFeatures(NamedTuple):
    """Fixed-capacity keypoint set for a batch of images."""

    xy: jnp.ndarray        # (N, K, 2) float32, original-image pixels
    size: jnp.ndarray      # (N, K) keypoint diameter (cv2 .size convention)
    angle: jnp.ndarray     # (N, K) orientation in radians
    response: jnp.ndarray  # (N, K) |contrast|
    desc: jnp.ndarray      # (N, K, 128) float32
    valid: jnp.ndarray     # (N, K) bool


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------

def _blur_nhw(img: jnp.ndarray, sigma: float, ksize: int) -> jnp.ndarray:
    """Gaussian blur of a (N, H, W) stack over the two *trailing* axes.

    ``gaussian_blur`` interprets 3-D arrays as (H, W, C); route through the
    unambiguous 4-D layout so the batch axis is never convolved.
    """
    return gaussian_blur(img[..., None], sigma, ksize)[..., 0]


def _base_image(gray: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """(N, H, W) gray -> base image with blur sigma (upscaled 2x if set)."""
    n, h, w = gray.shape
    if cfg.upscale:
        img = upsample2x_bilinear(gray)
        cur = cfg.init_sigma * 2.0
    else:
        img = gray
        cur = cfg.init_sigma
    delta = math.sqrt(max(cfg.sigma ** 2 - cur ** 2, 0.01))
    return _blur_nhw(img, delta, _cv2_sift_ksize(delta))


def _cv2_sift_ksize(sigma: float) -> int:
    """cv2 SIFT blurs with GaussianBlur auto kernel size on float images."""
    return int(round(sigma * 4 * 2 + 1)) | 1


def n_octaves_for(shape: Tuple[int, int], upscale: bool) -> int:
    """cv2: actualNOctaves = round(log2(min(H, W))) - 2 (+1 if upscaled)."""
    side = min(shape)
    if upscale:
        side *= 2
    return max(int(round(math.log2(side))) - 2, 1)


def _gaussian_stack(base: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """One octave's Gaussian images: (N, H, W) -> (N, S+3, H, W).

    ``gauss_mode='incremental'``: the cv2-parity chain, each layer blurs
    the previous one by the incremental sigma (a sequential 2*(S+2)-pass
    dependency chain). ``'direct'``: ``_gaussian_stack_direct``.
    """
    if cfg.gauss_mode == "direct":
        return _gaussian_stack_direct(base, cfg)
    if cfg.gauss_mode != "incremental":
        raise ValueError(f"unknown gauss_mode {cfg.gauss_mode!r} "
                         "(expected 'incremental' or 'direct')")
    s = cfg.n_layers
    k = 2.0 ** (1.0 / s)
    sigs = [cfg.sigma * (k ** i) for i in range(s + 3)]
    imgs = [base]
    for i in range(1, s + 3):
        delta = math.sqrt(sigs[i] ** 2 - sigs[i - 1] ** 2)
        imgs.append(_blur_nhw(imgs[-1], delta, _cv2_sift_ksize(delta)))
    return jnp.stack(imgs, axis=1)


def _gaussian_stack_direct(base: jnp.ndarray, cfg: SiftConfig
                           ) -> jnp.ndarray:
    """All octave layers straight from the base, as fused slice sums.

    Layer i carries total blur sigs[i]; Gaussians compose, so
    ``blur(base, sqrt(sigs[i]^2 - sigs[0]^2))`` equals the incremental
    chain (what cv2 computes, features.py via GaussianBlur) up to kernel
    truncation and f32 rounding. The incremental chain is a SEQUENTIAL
    dependency chain of 2*(S+2) separable passes — each layer waits for
    the previous. Here every layer reads the SAME reflect-padded base:
    the S+2 row passes share one padded input (XLA multi-output fusion
    CSEs the shifted slices), and the col passes are independent, so the
    whole stack is two bandwidth-bound sweeps with no serialization, at
    the price of larger taps (ksize up to 39 vs the chain's 25).

    Expressed as shifted-slice multiply-adds (ops.filters._conv_axis
    style) rather than ``conv_general_dilated``: a (N, L, H, W) conv
    with L=5 layers as channels forces a channel-minor layout that pads
    the tiny channel axis; elementwise slice sums keep the natural
    (H, W) layout.

    Parity with the incremental chain is pinned by test_sift (interior
    ~1e-6, border ~1e-3 from composition-order rounding).
    """
    import numpy as np

    s = cfg.n_layers
    k = 2.0 ** (1.0 / s)
    sig0 = cfg.sigma
    deltas = [math.sqrt(sig0 ** 2 * (k ** (2 * i) - 1.0))
              for i in range(1, s + 3)]
    ksizes = [_cv2_sift_ksize(d) for d in deltas]
    half = max(ksizes) // 2

    # trace-time tap constants: same rule as ops.filters.gaussian_kernel1d
    # (cv2.getGaussianKernel in f64, normalized, cast f32)
    def taps(d, ks):
        x = np.arange(ks, dtype=np.float64) - (ks - 1) / 2.0
        g = np.exp(-(x * x) / (2.0 * d * d))
        return (g / g.sum()).astype(np.float32)

    n, h, w = base.shape
    # one shared reflect pad over rows; each layer's own (smaller) pad is
    # the centered window of this one (reflect indexing depends only on
    # distance from the edge)
    padr = jnp.pad(base, ((0, 0), (0, 0), (half, half)), mode="reflect")
    layers = []
    for d, ks in zip(deltas, ksizes):
        g = taps(d, ks)
        off = half - ks // 2
        row = None
        for i in range(ks):
            term = padr[:, :, off + i: off + i + w] * float(g[i])
            row = term if row is None else row + term
        padc = jnp.pad(row, ((0, 0), (ks // 2, ks // 2), (0, 0)),
                       mode="reflect")
        col = None
        for i in range(ks):
            term = padc[:, i: i + h, :] * float(g[i])
            col = term if col is None else col + term
        layers.append(col)
    return jnp.stack([base] + layers, axis=1)


# ---------------------------------------------------------------------------
# Extrema detection
# ---------------------------------------------------------------------------

def _octave_candidates(dog: jnp.ndarray, cfg: SiftConfig, cap: int):
    """Top-`cap` DoG extrema per image. dog: (N, S+2, H, W).

    Returns (layer, y, x, score_valid) each (N, cap) int32/bool.
    """
    n, nl, h, w = dog.shape
    s = cfg.n_layers
    thresh = 0.5 * cfg.contrast_thresh / s

    # layer axis padded so mx[:, 1:-1] is each center layer's OWN
    # 3x3x3 window (cv2's 26-neighbour test, features.py via
    # SIFT_detectAndCompute). The unpadded form compared every
    # center layer against the max over the middle layer band — a
    # shape fluke that only broadcast for n_layers == 3.
    mx = lax.reduce_window(dog, -jnp.inf, lax.max, (1, 3, 3, 3),
                           (1, 1, 1, 1),
                           [(0, 0), (1, 1), (1, 1), (1, 1)])
    mn = lax.reduce_window(dog, jnp.inf, lax.min, (1, 3, 3, 3),
                           (1, 1, 1, 1),
                           [(0, 0), (1, 1), (1, 1), (1, 1)])
    center = dog[:, 1:-1]
    is_ext = ((center >= mx[:, 1:-1]) & (center > thresh)) | \
             ((center <= mn[:, 1:-1]) & (center < -thresh))

    b = cfg.img_border
    ys = jnp.arange(h)[None, None, :, None]
    xs = jnp.arange(w)[None, None, None, :]
    in_border = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    is_ext = is_ext & in_border

    # dense edge pre-filter: the same principal-curvature ratio test
    # that refinement applies, evaluated at integer positions, so the
    # fixed candidate budget is not wasted on edge responses that
    # would be rejected later anyway (they dominate raw |DoG|
    # ranking).
    dxx = (center[..., :, 2:] - 2 * center[..., :, 1:-1]
           + center[..., :, :-2])
    dyy = (center[..., 2:, :] - 2 * center[..., 1:-1, :]
           + center[..., :-2, :])
    dxy = (center[..., 2:, 2:] - center[..., 2:, :-2]
           - center[..., :-2, 2:] + center[..., :-2, :-2]) * 0.25
    dxx = jnp.pad(dxx, ((0, 0), (0, 0), (0, 0), (1, 1)))
    dyy = jnp.pad(dyy, ((0, 0), (0, 0), (1, 1), (0, 0)))
    dxy = jnp.pad(dxy, ((0, 0), (0, 0), (1, 1), (1, 1)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    is_ext = is_ext & edge_ok

    score = jnp.where(is_ext, jnp.abs(center), 0.0)
    flat = score.reshape(n, s * h * w)
    cap = min(cap, s * h * w)
    # exact top-k: ties resolve to the lower flat index, so the selection
    # is deterministic on every backend
    top, idx = lax.top_k(flat, cap)
    layer = idx // (h * w) + 1
    rem = idx % (h * w)
    return (layer.astype(jnp.int32), (rem // w).astype(jnp.int32),
            (rem % w).astype(jnp.int32), top > 0)


# ---------------------------------------------------------------------------
# Subpixel refinement
# ---------------------------------------------------------------------------

def _gather_cube(dog: jnp.ndarray, l, y, x):
    """3x3x3 neighbourhood of (l, y, x) from (S+2, H, W). Returns (3,3,3)."""
    nl, h, w = dog.shape
    dl = jnp.arange(-1, 2)
    cube_idx = ((l + dl[:, None, None]) * (h * w)
                + (y + dl[None, :, None]) * w
                + (x + dl[None, None, :]))
    return dog.reshape(-1)[cube_idx]


# Design note: the refine loop reads a dense per-pixel Newton-step field
# (below) with ONE int32 gather per iteration, instead of slicing a
# per-candidate (S+2, 16, 16) DoG window, which would copy far more
# bytes per candidate than the scalar gathers it replaces.
def _newton_step_field(dog: jnp.ndarray) -> jnp.ndarray:
    """Packed dense Newton-step field over every interior DoG pixel.

    The per-candidate refinement loop only needs, at each visited
    (l, y, x), the integer re-centering step and the converged flag —
    both functions of that pixel's 3x3x3 neighbourhood alone. Solving
    the Newton system DENSELY over the whole grid is cheap elementwise math
    (same stencils as ``_cube_derivs``, same closed-form adjugate solve
    as ``inv3x3``), and turns each scan iteration's 27-scalar gather
    per candidate into ONE int32 gather: bit 0 = converged
    (all |offs| < 0.5), bits 1-2 / 3-4 / 5-6 = step_x/y/l + 1.

    dog: (N, S+2, H, W) -> (N, S, H, W) int32 for layers 1..S. Values
    in the roll wrap-around border rows/cols are garbage; candidates
    are confined to y, x in [border, dim-1-border] so they are never
    read.
    """
    cm = dog[:, 1:-1]          # layer l
    cl = dog[:, :-2]           # layer l-1
    cu = dog[:, 2:]            # layer l+1

    def shx(a, d):
        return jnp.roll(a, -d, axis=-1)

    def shy(a, d):
        return jnp.roll(a, -d, axis=-2)

    dx = (shx(cm, 1) - shx(cm, -1)) * 0.5
    dy = (shy(cm, 1) - shy(cm, -1)) * 0.5
    ds = (cu - cl) * 0.5
    dxx = shx(cm, 1) - 2 * cm + shx(cm, -1)
    dyy = shy(cm, 1) - 2 * cm + shy(cm, -1)
    dss = cu - 2 * cm + cl
    dxy = (shy(shx(cm, 1), 1) - shy(shx(cm, -1), 1)
           - shy(shx(cm, 1), -1) + shy(shx(cm, -1), -1)) * 0.25
    dxs = (shx(cu, 1) - shx(cu, -1) - shx(cl, 1) + shx(cl, -1)) * 0.25
    dys = (shy(cu, 1) - shy(cu, -1) - shy(cl, 1) + shy(cl, -1)) * 0.25

    # det of the raw Hessian (det3x3's expansion order) gates the solve;
    # the inverse itself runs on the 1e-12-regularized diagonal, exactly
    # as the per-candidate path (``_refine_one``) does
    det0 = (dxx * (dyy * dss - dys * dys)
            - dxy * (dxy * dss - dys * dxs)
            + dxs * (dxy * dys - dyy * dxs))
    a, e, i = dxx + 1e-12, dyy + 1e-12, dss + 1e-12
    b, c, f = dxy, dxs, dys
    co00, co01, co02 = e * i - f * f, c * f - b * i, b * f - c * e
    co10, co11, co12 = f * c - b * i, a * i - c * c, c * b - a * f
    co20, co21, co22 = b * f - e * c, b * c - a * f, a * e - b * b
    det = a * co00 + b * co01 + c * co02
    solve = jnp.abs(det0) > 1e-20
    ox = jnp.where(solve, -(co00 * dx + co01 * dy + co02 * ds) / det, 0.0)
    oy = jnp.where(solve, -(co10 * dx + co11 * dy + co12 * ds) / det, 0.0)
    ol = jnp.where(solve, -(co20 * dx + co21 * dy + co22 * ds) / det, 0.0)

    conv = ((jnp.abs(ox) < 0.5) & (jnp.abs(oy) < 0.5)
            & (jnp.abs(ol) < 0.5))

    def step(o):
        return jnp.clip(jnp.round(o), -1, 1).astype(jnp.int32) + 1

    return (conv.astype(jnp.int32) | (step(ox) << 1) | (step(oy) << 3)
            | (step(ol) << 5))


def _cube_derivs(c):
    """Gradient, Hessian and the spatial second derivatives of a 3x3x3
    DoG cube (cv2's interpolation stencils)."""
    dd = jnp.array([
        (c[1, 1, 2] - c[1, 1, 0]) * 0.5,
        (c[1, 2, 1] - c[1, 0, 1]) * 0.5,
        (c[2, 1, 1] - c[0, 1, 1]) * 0.5,
    ])
    dxx = c[1, 1, 2] - 2 * c[1, 1, 1] + c[1, 1, 0]
    dyy = c[1, 2, 1] - 2 * c[1, 1, 1] + c[1, 0, 1]
    dss = c[2, 1, 1] - 2 * c[1, 1, 1] + c[0, 1, 1]
    dxy = (c[1, 2, 2] - c[1, 2, 0] - c[1, 0, 2] + c[1, 0, 0]) * 0.25
    dxs = (c[2, 1, 2] - c[2, 1, 0] - c[0, 1, 2] + c[0, 1, 0]) * 0.25
    dys = (c[2, 2, 1] - c[2, 0, 1] - c[0, 2, 1] + c[0, 0, 1]) * 0.25
    hess = jnp.array([[dxx, dxy, dxs],
                      [dxy, dyy, dys],
                      [dxs, dys, dss]])
    return dd, hess, (dxx, dyy, dxy)


def _refine_one(dog: jnp.ndarray, field: jnp.ndarray, l0, y0, x0,
                cfg: SiftConfig):
    """Iterative Newton refinement of one candidate (cv2-style).

    dog: (S+2, H, W); field: (S, H, W) packed step/conv words from
    ``_newton_step_field`` (layers 1..S). Each scan iteration is a
    single int32 gather; the full 3x3x3 cube is gathered ONCE at the
    final position for the contrast/edge tests. Returns (l, y, x int
    final, offs (3,), contrast, ok bool).
    """
    nl, h, w = dog.shape
    s = cfg.n_layers
    b = cfg.img_border
    flat = field.reshape(-1)

    def body(state, _):
        l, y, x, _ = state
        word = flat[(l - 1) * (h * w) + y * w + x]
        conv = (word & 1) > 0
        nx = jnp.clip(x + ((word >> 1) & 3) - 1, b, w - 1 - b)
        ny = jnp.clip(y + ((word >> 3) & 3) - 1, b, h - 1 - b)
        nl_ = jnp.clip(l + ((word >> 5) & 3) - 1, 1, s)
        l = jnp.where(conv, l, nl_)
        y = jnp.where(conv, y, ny)
        x = jnp.where(conv, x, nx)
        return (l, y, x, conv), None

    init = (l0, y0, x0, jnp.asarray(False))
    (l, y, x, conv), _ = lax.scan(body, init, None,
                                  length=cfg.refine_iters)

    c = _gather_cube(dog, l, y, x)
    dd, hess, (dxx, dyy, dxy) = _cube_derivs(c)
    # when converged the position is a Newton fixed point, so re-solving
    # at the final cube reproduces the last iteration's offsets exactly;
    # when not converged the offsets are zeroed (cv2 rejects anyway)
    det = det3x3(hess)
    offs = jnp.where(
        conv & (jnp.abs(det) > 1e-20),
        -(inv3x3(hess + 1e-12 * jnp.eye(3, dtype=dog.dtype)) @ dd),
        jnp.zeros(3, dog.dtype)).astype(dog.dtype)
    contrast = c[1, 1, 1] + 0.5 * jnp.dot(dd, offs)

    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = cfg.edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
    contrast_ok = jnp.abs(contrast) * s >= cfg.contrast_thresh
    ok = conv & edge_ok & contrast_ok
    return l, y, x, offs, contrast, ok


# ---------------------------------------------------------------------------
# Per-keypoint patches
# ---------------------------------------------------------------------------
#
# Orientation windows and descriptor sampling are the SIFT hot path. Each
# keypoint extracts ONE aligned square patch around itself (vmapped
# dynamic_slice); the orientation histogram is then dense elementwise math
# over the patch, and rotated bilinear sampling becomes two small matmuls
# per keypoint: sample_s = U[s] @ patch @ V[s] with U/V the separable
# bilinear one-hot-fraction matrices. This replaces ~10^8 scattered
# per-sample loads per batch with dense GEMMs.

# Half-extent of the per-keypoint patch. The patch must cover every
# sample the descriptor/orientation stages can read; with the refine
# clamps (layer in [1, S] and |subpixel offs| < 0.5, _refine_one) the
# max octave-relative sigma is 1.6 * 2^((S+0.5)/S) = 3.592, and the
# p=16 descriptor grid reaches |gu| <= 1.875 bin units, so the farthest
# gradient read is 0.5 (subpixel) + 1.875*sqrt(2)*3*sigma (rotated
# grid) + 1 (bilinear footprint) = 30.07 px; the orientation window
# radius is round(4.5*sigma) = 16. half-1 = 31 >= 30.07 keeps every
# sample inside the patch (round 3 used 40 from cv2's conservative
# (d+1)/2 window-radius formula; shrinking to 32 drops no samples and
# makes psg = 64, cutting the per-candidate patch copies and the one-hot
# sampling matmuls by ~36%).
_PATCH_HALF = 32


def _extract_patch(gauss: jnp.ndarray, l, y, x, ps_y: int, ps_x: int):
    """Aligned (ps_y, ps_x) patch of layer ``l`` centered near (y, x).

    Returns (patch, corner_y, corner_x); the corner is clipped so the patch
    always lies inside the image. The two sizes are clipped independently
    per dimension (thin octaves must not truncate the window along their
    LARGER dimension — cv2's descriptor window reaches every in-bounds
    pixel, so the patch must too).
    """
    nl, h, w = gauss.shape
    cy = jnp.clip(y - ps_y // 2, 0, max(h - ps_y, 0))
    cx = jnp.clip(x - ps_x // 2, 0, max(w - ps_x, 0))
    patch = lax.dynamic_slice(gauss, (l, cy, cx), (1, ps_y, ps_x))[0]
    return patch, cy, cx


def _patch_grads(patch: jnp.ndarray):
    """cv2-sign gradients of the patch interior: (..., ps-2, ps-2) each.

    Grad pixel (i, j) corresponds to absolute position (cy+1+i, cx+1+j).
    """
    gx = patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2]
    gy = patch[..., :-2, 1:-1] - patch[..., 2:, 1:-1]
    return gx, gy


def _orientation_from_patch(gx, gy, y, x, cy, cx, sig_oct, h, w,
                            cfg: SiftConfig):
    """36-bin orientation histogram from dense patch gradients.

    Exact cv2 semantics: integer window of radius round(4.5 sigma) around
    (y, x), Gaussian weights exp(-d^2 / (2 (1.5 sigma)^2)), histogram by
    rounded angle, 5-tap circular smoothing. Returns the smoothed (36,)
    histogram.
    """
    psg = gx.shape[0]
    ay = cy + 1 + jnp.arange(psg)[:, None]      # absolute rows
    ax = cx + 1 + jnp.arange(psg)[None, :]
    # coordinate/weight math stays f32 even for bf16 patches (distances
    # up to +-31 square past bf16's exact-integer range)
    dyc = (ay - y).astype(jnp.float32)
    dxc = (ax - x).astype(jnp.float32)
    radius = jnp.round(4.5 * sig_oct)
    inside = ((jnp.abs(dyc) <= radius) & (jnp.abs(dxc) <= radius)
              & (ay >= 1) & (ay <= h - 2) & (ax >= 1) & (ax <= w - 2))

    mag = jnp.sqrt(gx * gx + gy * gy)
    ori = jnp.arctan2(gy, gx)
    rr = dyc * dyc + dxc * dxc
    wgt = jnp.exp(rr / (-2.0 * (1.5 * sig_oct) ** 2)) * inside

    nb = cfg.ori_bins
    bins = jnp.round(ori * (nb / (2 * jnp.pi))).astype(jnp.int32) % nb
    onehot = (bins.reshape(-1)[:, None]
              == jnp.arange(nb)[None, :]).astype(mag.dtype)
    # accumulate in f32 regardless of the patch dtype. DEFAULT precision:
    # on the GPU a float32 contraction runs in TF32 (a 10-bit mantissa
    # on the inputs), which the histogram's 0.8*max peak test tolerates
    hist = jnp.dot((mag * wgt).astype(mag.dtype).reshape(-1), onehot,
                   precision=jax.lax.Precision.DEFAULT,
                   preferred_element_type=jnp.float32)

    # cv2 circular smoothing: (h[i-2]+h[i+2])/16 + 4(h[i-1]+h[i+1])/16 + 6h/16
    hm2, hm1 = jnp.roll(hist, 2), jnp.roll(hist, 1)
    hp1, hp2 = jnp.roll(hist, -1), jnp.roll(hist, -2)
    return (hm2 + hp2) * (1 / 16) + (hm1 + hp1) * (4 / 16) + hist * (6 / 16)


def _peak_angles(hist: jnp.ndarray, cfg: SiftConfig):
    """Up to ``n_orientations`` interpolated peak angles (radians).

    Returns (angles (n_ori,), valid (n_ori,)).
    """
    nb = cfg.ori_bins
    hm1, hp1 = jnp.roll(hist, 1), jnp.roll(hist, -1)
    mx = jnp.max(hist)
    is_peak = (hist > hm1) & (hist > hp1) & (hist >= 0.8 * mx) & (mx > 0)
    peak_val = jnp.where(is_peak, hist, -jnp.inf)
    vals, idx = lax.top_k(peak_val, cfg.n_orientations)
    denom = hm1[idx] - 2 * hist[idx] + hp1[idx]
    interp = jnp.where(jnp.abs(denom) > 1e-12,
                       0.5 * (hm1[idx] - hp1[idx]) / denom, 0.0)
    bin_pos = (idx + interp) % nb
    angles = bin_pos * (2 * jnp.pi / nb)
    return angles, jnp.isfinite(vals)


# ---------------------------------------------------------------------------
# Descriptor
# ---------------------------------------------------------------------------

def _descriptor_from_patch(gx_patch, gy_patch, yf, xf, cy, cx, sig_oct,
                           angle, h, w, cfg: SiftConfig):
    """128-d descriptor from dense patch gradients (no scattered gathers).

    Rotated bilinear sampling is expressed as two separable one-hot-fraction
    matmuls per gradient map: ``sample = U @ patch @ V`` row-wise, run
    as dense GEMMs instead of per-sample gathers.

    gx_patch/gy_patch: (psg, psg) gradients anchored at absolute position
    (cy+1, cx+1); yf/xf: refined keypoint position (absolute, octave
    coords).
    """
    psg = gx_patch.shape[0]
    d = cfg.descr_width
    p = cfg.descr_samples
    nob = cfg.descr_ori_bins

    # sample grid in bin units, covering the d x d descriptor window
    g = (jnp.arange(p) + 0.5) / p * d - d / 2          # (-2, 2) for d=4
    gu, gv = jnp.meshgrid(g, g, indexing="xy")          # (p, p)
    cosa, sina = jnp.cos(angle), jnp.sin(angle)
    hist_width = 3.0 * sig_oct                          # SIFT_DESCR_SCL_FCTR
    # rotate into image frame (cv2: c_rot = (c*cos - r*sin) etc.)
    sx = xf + (gu * cosa - gv * sina) * hist_width
    sy = yf + (gu * sina + gv * cosa) * hist_width

    # patch-relative sample coordinates (gradient patch anchored at +1)
    px = (sx - (cx + 1)).reshape(-1)
    py = (sy - (cy + 1)).reshape(-1)
    x0 = jnp.floor(px).astype(jnp.int32)
    y0 = jnp.floor(py).astype(jnp.int32)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]

    ii = jnp.arange(psg)[None, :]
    uu = ((ii == jnp.clip(y0, 0, psg - 1)[:, None]) * (1 - fy)
          + (ii == jnp.clip(y0 + 1, 0, psg - 1)[:, None]) * fy)
    vv = ((ii == jnp.clip(x0, 0, psg - 1)[:, None]) * (1 - fx)
          + (ii == jnp.clip(x0 + 1, 0, psg - 1)[:, None]) * fx)
    uu = uu.astype(gx_patch.dtype)                     # (p^2, psg)
    vv = vv.astype(gx_patch.dtype)

    # DEFAULT precision: TF32 inputs on the GPU for float32 patches, bf16
    # for the bf16 opt-in; accumulation and everything downstream stays
    # f32 via preferred_element_type
    prec = jax.lax.Precision.DEFAULT
    rows_x = jnp.dot(uu, gx_patch, precision=prec,
                     preferred_element_type=jnp.float32)  # (p^2, psg)
    rows_y = jnp.dot(uu, gy_patch, precision=prec,
                     preferred_element_type=jnp.float32)
    gx = jnp.sum(rows_x * vv, axis=1).reshape(p, p)
    gy = jnp.sum(rows_y * vv, axis=1).reshape(p, p)

    # valid: sample footprint inside the patch AND inside the image interior
    pin = ((px >= 0) & (px <= psg - 2) & (py >= 0)
           & (py <= psg - 2)).reshape(p, p)
    inb = pin & (sx >= 1) & (sx <= w - 2) & (sy >= 1) & (sy <= h - 2)

    mag = jnp.sqrt(gx * gx + gy * gy)
    ori = jnp.arctan2(gy, gx) - angle
    ori = jnp.mod(ori, 2 * jnp.pi)

    # Gaussian weight over the window (sigma = 0.5 * d in bin units)
    wgt = jnp.exp(-(gu * gu + gv * gv) / (2 * (0.5 * d) ** 2)) * inb

    # trilinear binning into (d+2, d+2, nob) then crop (cv2 layout).
    # Instead of 8 scatter-adds per sample, the trilinear weights
    # factorize: per sample each of the row/col/ori axes has a 2-entry
    # one-hot; the histogram is one small einsum contraction over the
    # 256 samples.
    rbin = (gv + d / 2 - 0.5).reshape(-1)
    cbin = (gu + d / 2 - 0.5).reshape(-1)
    obin = (ori * (nob / (2 * jnp.pi))).reshape(-1)
    val = (mag * wgt).reshape(-1)
    acc = _trilinear_hist(rbin, cbin, obin, val, d, nob)

    # normalize, clip, renormalize (cv2)
    nrm = jnp.sqrt(jnp.sum(acc * acc))
    acc = jnp.minimum(acc, cfg.descr_mag_thresh * jnp.maximum(nrm, 1e-12))
    nrm2 = jnp.sqrt(jnp.sum(acc * acc))
    return acc / jnp.maximum(nrm2, 1e-12)


def _trilinear_hist(rbin, cbin, obin, val, d, nob, dtype=jnp.float32):
    """(d*d*nob,) trilinear histogram from flat sample bin coords.

    The shared binning backend of both descriptor modes: instead of 8
    scatter-adds per sample the trilinear weights factorize into
    per-axis 2-entry one-hots and the histogram is one einsum
    contraction over the samples.
    Row/col bins live in a (d+2) padded frame cropped at the end; the
    orientation axis wraps (cv2's hist layout, sift.cpp).
    """
    r0 = jnp.floor(rbin).astype(jnp.int32)
    c0 = jnp.floor(cbin).astype(jnp.int32)
    o0 = jnp.floor(obin).astype(jnp.int32)
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    o0 = o0 % nob

    def axis_onehot(i0, frac, n, wrap):
        ii = jnp.arange(n)[None, :]
        a = i0[:, None]
        b = i0[:, None] + 1
        if wrap:
            a, b = a % n, b % n
        else:
            a = jnp.clip(a, 0, n - 1)
            b = jnp.clip(b, 0, n - 1)
        return (((ii == a) * (1 - frac[:, None])
                 + (ii == b) * frac[:, None])).astype(dtype)

    oh_r = axis_onehot(r0 + 1, fr, d + 2, wrap=False)   # (S, d+2)
    oh_c = axis_onehot(c0 + 1, fc, d + 2, wrap=False)
    oh_o = axis_onehot(o0, fo, nob, wrap=True)          # (S, nob)

    tmp = jnp.einsum("sr,so->sro", oh_r * val[:, None].astype(dtype), oh_o)
    acc = jnp.einsum("sro,sc->rco", tmp, oh_c)          # [row][col][ori]
    return acc[1:-1, 1:-1].reshape(-1)


def _descriptor_from_patch_dense(gx_patch, gy_patch, yf, xf, cy, cx,
                                 sig_oct, angle, h, w, cfg: SiftConfig):
    """cv2-exact dense integer-window 128-d descriptor.

    Reproduces OpenCV's calcSIFTDescriptor semantics (the path the
    reference runs via ``cv2.xfeatures2d.SIFT``, features.py:192-201):
    every integer pixel (i, j) around the ROUNDED keypoint center whose
    rotated bin coordinates fall in (-1, d) contributes its own exact
    central-difference gradient with weight exp(-(c_rot^2 + r_rot^2)
    / (0.5 d^2)). No sampling interpolation at all — the per-keypoint
    gradient patch IS the window; out-of-window pixels are masked.
    This is a masked einsum over the psg^2 patch pixels
    (psg = 80 covers cv2's max window radius 38.1, see
    SiftConfig.patch_half).
    """
    psg = gx_patch.shape[0]
    d = cfg.descr_width
    nob = cfg.descr_ori_bins

    # integer pixel offsets from the ROUNDED center (cv2: Point pt =
    # cvRound(ptf); i, j in [-radius, radius])
    yr = jnp.round(yf)
    xr = jnp.round(xf)
    ay = (cy + 1 + jnp.arange(psg, dtype=jnp.int32))[:, None]  # abs rows
    ax = (cx + 1 + jnp.arange(psg, dtype=jnp.int32))[None, :]
    di = (ay - yr).astype(jnp.float32)                 # row offset i
    dj = (ax - xr).astype(jnp.float32)                 # col offset j

    hist_width = 3.0 * sig_oct                         # SIFT_DESCR_SCL_FCTR
    cosw = jnp.cos(angle) / hist_width
    sinw = jnp.sin(angle) / hist_width
    c_rot = dj * cosw - di * sinw
    r_rot = dj * sinw + di * cosw
    rbin = (r_rot + d / 2 - 0.5).reshape(-1)
    cbin = (c_rot + d / 2 - 0.5).reshape(-1)

    # cv2 masks: rotated bins strictly inside (-1, d) AND the gradient
    # footprint inside the image (0 < r < rows-1, 0 < c < cols-1)
    inb = ((ay >= 1) & (ay <= h - 2) & (ax >= 1) & (ax <= w - 2))
    valid = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
             & inb.reshape(-1))

    gx = gx_patch.astype(jnp.float32)
    gy = gy_patch.astype(jnp.float32)
    mag = jnp.sqrt(gx * gx + gy * gy).reshape(-1)
    ori = jnp.mod(jnp.arctan2(gy, gx) - angle, 2 * jnp.pi).reshape(-1)
    obin = ori * (nob / (2 * jnp.pi))

    wgt = jnp.exp((c_rot * c_rot + r_rot * r_rot)
                  * (-1.0 / (d * d * 0.5))).reshape(-1)
    val = mag * wgt * valid

    acc = _trilinear_hist(rbin, cbin, obin, val, d, nob)

    nrm = jnp.sqrt(jnp.sum(acc * acc))
    acc = jnp.minimum(acc, cfg.descr_mag_thresh * jnp.maximum(nrm, 1e-12))
    nrm2 = jnp.sqrt(jnp.sum(acc * acc))
    return acc / jnp.maximum(nrm2, 1e-12)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def _octave_caps(cfg: SiftConfig, n_oct: int,
                 base_shape: Tuple[int, int]) -> List[int]:
    """Per-octave DoG candidate budgets.

    Megapixel-scale octaves (>= ~0.75 Mpix) get half the geometric
    ``max_kpts >> o`` budget: their |DoG|-ranked candidate tail is junk
    that refinement rejects anyway — measured at the 1-Mpix benchmark,
    halving changes the surviving keypoint set by <1.5% and ground-truth
    registration error not at all, while refine/descriptor time scales
    linearly with the budget. Small octaves keep the full budget
    (candidate density relative to area is much higher, and the ranking
    cut would drop real survivors — caught by the small-image focal
    parity test)."""
    h, w = base_shape
    caps = []
    for o in range(n_oct):
        pix = (h >> o) * (w >> o)
        shift = o + 1 if pix >= 750_000 else o
        caps.append(max(cfg.max_kpts >> shift, 128))
    return caps


@functools.partial(jax.jit, static_argnames=("cfg", "upto"))
def sift_extract(gray: jnp.ndarray, cfg: SiftConfig = SiftConfig(),
                 upto: str = "full") -> SiftFeatures:
    """Extract SIFT keypoints + descriptors from a batch of gray images.

    ``gray``: (N, H, W) float32 in [0, 1]. Returns fixed-capacity
    ``SiftFeatures`` sorted by response (descending) per image.

    ``upto`` (static, profiling only): stop after a named stage —
    ``gauss`` | ``cand`` | ``refine`` | ``patch`` — and return a scalar
    checksum instead of features. The profiler times PREFIXES of the
    production program itself (benchmarks/profile_sift.py), rather than
    hand-maintained truncated copies that could drift from it.
    """
    n, h0, w0 = gray.shape
    gray = gray.astype(jnp.float32)
    n_oct = n_octaves_for((h0, w0), cfg.upscale)
    base = (2 * h0, 2 * w0) if cfg.upscale else (h0, w0)
    caps = _octave_caps(cfg, n_oct, base)
    s = cfg.n_layers

    # named scope: the trace reduction (benchmarks/device_profile.py)
    # sums the scale-space fusions under this name
    with jax.named_scope(GAUSS_SCOPE):
        base = _base_image(gray, cfg)
    scale0 = 0.5 if cfg.upscale else 1.0  # octave->original coord factor

    outs = []
    acc = jnp.float32(0)   # profiling checksum (upto != "full" only)
    octv = base
    for o in range(n_oct):
        with jax.named_scope(GAUSS_SCOPE):
            gauss = _gaussian_stack(octv, cfg)
            dog = gauss[:, 1:] - gauss[:, :-1]
        if o + 1 < n_oct:
            nxt = gauss[:, s][:, ::2, ::2]  # cv2: downsample layer S
        if upto == "gauss":
            acc += jnp.sum(dog[:, 0])
            octv = nxt
            continue
        cap = min(caps[o], s * dog.shape[2] * dog.shape[3])
        l0, y0, x0, cand_ok = _octave_candidates(dog, cfg, cap)
        if upto == "cand":
            acc += jnp.sum(x0) + jnp.sum(cand_ok)
            octv = nxt
            continue

        field = _newton_step_field(dog)            # (N, S, H, W) int32
        refine = jax.vmap(jax.vmap(
            lambda dg, fl, a, b, c: _refine_one(dg, fl, a, b, c, cfg),
            in_axes=(None, None, 0, 0, 0)), in_axes=(0, 0, 0, 0, 0))
        l, y, x, offs, contrast, ok = refine(dog, field, l0, y0, x0)
        ok = ok & cand_ok

        # compact the refinement survivors before the (heavy) patch /
        # orientation / descriptor stages: raw DoG candidates outnumber
        # survivors ~10x at production scale (the caps saturate with
        # low-contrast extrema the Newton step rejects), so without
        # compaction ~75% of the descriptor work runs on dead slots.
        # Ranking by true refined |contrast| keeps recall exact whenever
        # the per-octave survivor count fits sel_cap (measured: <=317
        # survivors/octave at 1-Mpix bench scale vs sel_cap >= 512).
        sel_cap = cap if cap < 1024 else max(cap >> cfg.sel_shift, 512)
        if sel_cap < cap:
            score = jnp.where(ok, jnp.abs(contrast), -jnp.inf)
            _, sel = lax.top_k(score, sel_cap)
            take = jax.vmap(lambda a, ii: a[ii])
            l, y, x = take(l, sel), take(y, sel), take(x, sel)
            offs, contrast, ok = (take(offs, sel), take(contrast, sel),
                                  take(ok, sel))
            cap = sel_cap
        if upto == "refine":
            acc += jnp.sum(x) + jnp.sum(ok)
            octv = nxt
            continue

        lf = l.astype(jnp.float32) + offs[..., 2]
        sig_oct = cfg.sigma * jnp.power(2.0, lf / s)
        xf = x.astype(jnp.float32) + offs[..., 0]
        yf = y.astype(jnp.float32) + offs[..., 1]

        oh, ow = gauss.shape[2], gauss.shape[3]
        # per-dimension clipping: a thin octave (oh != ow with one dim
        # below the window size) must keep full window reach along its
        # larger dimension — the dense descriptor's in-bounds mask admits
        # every cv2-visible pixel, so the patch has to contain them all
        ps_y = min(2 * cfg.patch_half + 2, oh)
        ps_x = min(2 * cfg.patch_half + 2, ow)
        patch_fn = jax.vmap(jax.vmap(
            lambda g, a, b, c: _extract_patch(g, a, b, c, ps_y, ps_x),
            in_axes=(None, 0, 0, 0)), in_axes=(0, 0, 0, 0))
        patches, pcy, pcx = patch_fn(gauss, l, y, x)  # (N, cap, ps_y, ps_x)
        gxp, gyp = _patch_grads(patches)
        # pad small-octave patches to the uniform size so the (heavy)
        # orientation/descriptor stage compiles ONCE for all octaves —
        # zero-padded gradients contribute zero magnitude, so no masking
        # beyond the existing absolute-coordinate checks is needed
        psg = 2 * cfg.patch_half
        pad_y = psg - gxp.shape[-2]
        pad_x = psg - gxp.shape[-1]
        if pad_y or pad_x:
            pw_ = [(0, 0), (0, 0), (0, pad_y), (0, pad_x)]
            gxp = jnp.pad(gxp, pw_)
            gyp = jnp.pad(gyp, pw_)
        if cfg.patch_dtype != "float32" and cfg.descr_mode != "dense":
            # bf16 patches are a measured throughput opt-in for the grid
            # sampler; the dense mode's contract is cv2-exact gradients,
            # so it always keeps f32 (the cast would silently cost the
            # 2e-5 agreement TestDenseDescriptor pins)
            gxp = gxp.astype(cfg.patch_dtype)
            gyp = gyp.astype(cfg.patch_dtype)
        if upto == "patch":
            acc += jnp.sum(gxp[..., ::16, ::16])
            octv = nxt
            continue

        factor = scale0 * (2.0 ** o)
        outs.append(dict(
            gxp=gxp, gyp=gyp,
            y=y, x=x, yf=yf, xf=xf, pcy=pcy, pcx=pcx, sig=sig_oct,
            response=jnp.abs(contrast), ok=ok,
            factor=jnp.full((n, cap), factor, jnp.float32),
            oh=jnp.full((n, cap), oh, jnp.int32),
            ow=jnp.full((n, cap), ow, jnp.int32),
        ))

        if o + 1 < n_oct:
            octv = nxt

    if upto != "full":
        return acc

    cat = {k: jnp.concatenate([d[k] for d in outs], axis=1) for k in outs[0]}
    total = cat["y"].shape[1]

    # fused keypoint stage over ALL octaves' candidates, processed in
    # fixed-size chunks with lax.map: bounds the one-hot sampling-matrix
    # transients (a single vmap materializes ~2.5 KB * samples * n_ori per
    # candidate — tens of GB at 15-image batch) and compiles the heavy
    # body exactly once regardless of batch or octave count. Dense mode
    # bins psg^2 = 6400 samples per keypoint (25x the grid's 256), so
    # its chunk is smaller to keep the einsum transients bounded.
    chunk = 2048 if cfg.descr_mode == "grid" else 256
    m = n * total
    n_chunks = -(-m // chunk)
    padded = n_chunks * chunk

    def flat_pad(a):
        a = a.reshape((m,) + a.shape[2:])
        pad_widths = [(0, padded - m)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, pad_widths).reshape((n_chunks, chunk)
                                              + a.shape[1:])

    fc = {k: flat_pad(v) for k, v in cat.items()}

    def kp_stage(c):
        hists = jax.vmap(
            lambda a, b, cc, dd, e, f, sg, hh, ww: _orientation_from_patch(
                a, b, cc, dd, e, f, sg, hh, ww, cfg))(
            c["gxp"], c["gyp"], c["y"], c["x"], c["pcy"], c["pcx"],
            c["sig"], c["oh"], c["ow"])                # (chunk, 36)
        angles, avalid = jax.vmap(
            lambda hh: _peak_angles(hh, cfg))(hists)   # (chunk, n_ori)
        descr_fn = (_descriptor_from_patch if cfg.descr_mode == "grid"
                    else _descriptor_from_patch_dense)
        descs = jax.vmap(jax.vmap(
            lambda a, b, cc, dd, e, f, sg, an, hh, ww:
                descr_fn(a, b, cc, dd, e, f, sg, an, hh, ww, cfg),
            in_axes=(None, None, None, None, None, None, None, 0, None,
                     None)),
            in_axes=(0,) * 10)(
            c["gxp"], c["gyp"], c["yf"], c["xf"], c["pcy"], c["pcx"],
            c["sig"], angles, c["oh"], c["ow"])        # (chunk, n_ori, 128)
        return angles, avalid, descs

    angles_c, avalid_c, descs_c = lax.map(kp_stage, fc)
    no = cfg.n_orientations
    angles = angles_c.reshape(padded, no)[:m].reshape(n, total, no)
    avalid = avalid_c.reshape(padded, no)[:m].reshape(n, total, no)
    descs = descs_c.reshape(padded, no, cfg.dim)[:m].reshape(
        n, total, no, cfg.dim)

    xy = (jnp.stack([cat["xf"], cat["yf"]], axis=-1)
          * cat["factor"][..., None])                   # (N, T, 2)
    size = cat["sig"] * 2.0 * cat["factor"]             # cv2 kp.size
    kp_ok = cat["ok"][..., None] & avalid               # (N, T, n_ori)

    flat = dict(
        xy=jnp.broadcast_to(xy[:, :, None, :], (n, total, no, 2)
                            ).reshape(n, total * no, 2),
        size=jnp.broadcast_to(size[:, :, None], (n, total, no)
                              ).reshape(n, total * no),
        angle=angles.reshape(n, total * no),
        response=jnp.broadcast_to(
            cat["response"][:, :, None], (n, total, no)
        ).reshape(n, total * no),
        desc=descs.reshape(n, total * no, cfg.dim),
        valid=kp_ok.reshape(n, total * no),
    )

    # global top-K by response
    score = jnp.where(flat["valid"], flat["response"], -jnp.inf)
    _, sel = lax.top_k(score, cfg.max_kpts)             # (N, K)
    take = jax.vmap(lambda arr, ii: arr[ii])
    return SiftFeatures(
        xy=take(flat["xy"], sel),
        size=take(flat["size"], sel),
        angle=take(flat["angle"], sel),
        response=take(flat["response"], sel),
        desc=take(flat["desc"], sel),
        valid=take(flat["valid"], sel),
    )


def root_sift(desc: jnp.ndarray) -> jnp.ndarray:
    """RootSIFT normalization: sqrt(des / (sum + 1e-7)) (features.py:198)."""
    return jnp.sqrt(desc / (jnp.sum(desc, axis=-1, keepdims=True) + 1e-7))


__all__ = ["SiftConfig", "SiftFeatures", "sift_extract", "root_sift",
           "n_octaves_for"]
