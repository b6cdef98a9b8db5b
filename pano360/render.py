"""Rendering: projection extents, exposure gains, backward warp, blenders.

Batched device re-design of the reference's L4 render stage (stitcher.py:24-327):

- per-region projection ranges and the output-resolution rule are identical
  math, batched over regions (stitcher.py:107-157);
- exposure compensation solves the same Brown-Lowe eq.(29) gain system, but
  computes every pairwise overlap in one batched device warp instead of an
  O(N^2) Python loop of cv2.warpPerspective calls (stitcher.py:24-66);
- the backward warp (grid -> proj2hom -> proj -> divide -> mask -> bilinear
  gather, stitcher.py:288-319) runs for ALL regions in a single batched
  device program over bbox-padded patches;
- blenders (none / linear / multiband, stitcher.py:160-248) are jitted
  device programs accumulating into the mosaic with dynamic-slice updates;
  multiband reproduces the reference's difference-of-Gaussians bands with
  sigma = sqrt(2l+1)*4 on the *original* patch per level.

Host keeps only the tiny data-dependent pieces: resolution bookkeeping,
patch bbox computation, and the final crop (native C++, see
pano360.native).
"""
from __future__ import annotations

import functools
import logging
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from pano360 import geometry as geo
from pano360.ops.filters import gaussian_blur
from pano360.ops.warp import remap_bilinear, warp_perspective
from pano360.register import PanoImage

MAX_RESOLUTION = 1400   # stitcher.py:17
WARP_SCOPE = "render_warp"   # jax.named_scope of the backward warp
LOG = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Projection extents & resolution (stitcher.py:107-157)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("shape", "projection", "nel",
                                    "unwrapped"))
def proj_img_range_border(shape: Tuple[int, int], homs: jnp.ndarray,
                          projection=geo.SphProj, nel: int = 100,
                          shapes: Optional[jnp.ndarray] = None,
                          unwrapped: bool = False):
    """Projected extent of image borders; batched over (N, 3, 3) homs.

    ``shapes``: optional per-image (N, 2) float (h, w) overriding the
    single ``shape`` when images have mixed sizes.

    ``unwrapped=True`` additionally returns the azimuth range of each
    view unwrapped around its own center direction, i.e. a CONTIGUOUS
    interval [azc - d1, azc + d2] that may leave [-pi, pi) when the view
    crosses the azimuth seam. The wrapped min/max of a seam-crossing
    view degenerates to ~[-pi, pi] (its border azimuths cluster at both
    ends), which forces a full-canvas-width render window; the unwrapped
    range keeps the window at the view's true footprint (measured 15x
    1-Mpix: one crossing view made EVERY region pay a 1400-px-wide patch
    instead of ~236 px — ~6x the warp+blend work). Returns one stacked
    (4, N, 2) array [rmin, rmax, uw_min, uw_max] so the host pays a
    single pull.
    """
    height, width = shape
    if shapes is None:
        shapes = jnp.broadcast_to(
            jnp.asarray([height, width], jnp.float32), (homs.shape[0], 2))
    frac = jnp.linspace(0.0, 1.0, nel)
    zeros, ones = jnp.zeros(nel), jnp.ones(nel)

    def borders_of(hw):
        h, w = hw[0], hw[1]
        side_x = frac * w
        side_y = frac * h
        b = jnp.concatenate([
            jnp.stack([zeros, side_y, ones], axis=1),
            jnp.stack([jnp.full((nel,), 1.0) * w, side_y, ones], axis=1),
            jnp.stack([side_x, zeros, ones], axis=1),
            jnp.stack([side_x, jnp.full((nel,), 1.0) * h, ones], axis=1),
        ]).astype(jnp.float32)
        return b - jnp.stack([w / 2, h / 2, jnp.float32(0.0)])

    borders = jax.vmap(borders_of)(shapes.astype(jnp.float32))  # (N, 4nel, 3)
    pts = projection.hom2proj(
        jnp.einsum("nij,nkj->nki", homs.astype(jnp.float32), borders,
                   precision=jax.lax.Precision.HIGHEST))
    rmin = jnp.min(pts, axis=1)
    rmax = jnp.max(pts, axis=1)                          # (N, 2), (N, 2)
    if not unwrapped:
        return rmin, rmax

    # center direction = hom @ [0, 0, 1] (borders are center-origin)
    azc = projection.hom2proj(homs[:, :, 2].astype(jnp.float32))[:, 0]
    ax = pts[..., 0]
    ax_u = azc[:, None] + jnp.mod(ax - azc[:, None] + jnp.pi,
                                  2 * jnp.pi) - jnp.pi
    uw_min = jnp.stack([jnp.min(ax_u, axis=1), rmin[:, 1]], axis=-1)
    uw_max = jnp.stack([jnp.max(ax_u, axis=1), rmax[:, 1]], axis=-1)
    return jnp.stack([rmin, rmax, uw_min, uw_max])


def _np_hom2proj(pts: np.ndarray, projection) -> np.ndarray:
    """Host (numpy) forward projection of a handful of points — a jnp call
    here would cost a device dispatch and a host sync for 4 values."""
    hypot = np.hypot(pts[..., 0], pts[..., 2])
    theta = np.arctan2(pts[..., 0], pts[..., 2])
    if projection is geo.CylProj:
        return np.stack([theta, pts[..., 1] / hypot], axis=-1)
    return np.stack([theta, np.arctan2(pts[..., 1], hypot)], axis=-1)


def proj_img_range_corners(shape: Tuple[int, int], hom: np.ndarray,
                           projection=geo.SphProj):
    """Corner-based extent with wraparound fix (stitcher.py:125-139). Host."""
    height, width = shape
    pts = np.array([[-width / 2, -height / 2, 1], [width / 2, -height / 2, 1],
                    [-width / 2, height / 2, 1], [width / 2, height / 2, 1]])
    pts = _np_hom2proj(pts @ hom.T, projection)

    xmin = min(pts[0, 0], pts[2, 0])
    xmax = max(pts[1, 0], pts[3, 0])
    ymin = min(pts[0, 1], pts[1, 1])
    ymax = max(pts[2, 1], pts[3, 1])
    if xmin > xmax:
        xmax += 2 * np.pi
    if ymin > ymax:
        ymax += np.pi
    return np.array([xmin, ymin]), np.array([xmax, ymax])


def estimate_resolution(regions: List[PanoImage],
                        max_resolution: int = MAX_RESOLUTION,
                        projection=geo.SphProj):
    """Output resolution and global range (stitcher.py:142-157). Host.

    ``max_resolution``: cap on the mosaic's longest side (the reference
    hardcodes 1400; exposed as a knob since device rendering is not the
    bottleneck that motivated the cap).
    """
    min_r = np.min(np.stack([r.range[0] for r in regions]), axis=0)
    max_r = np.max(np.stack([r.range[1] for r in regions]), axis=0)
    size = max_r - min_r

    mid = regions[len(regions) // 2]
    im_shape = np.array(mid.img.shape[:2][::-1])
    mid_range = proj_img_range_corners(mid.img.shape[:2], mid.hom(),
                                       projection)
    resolution = (mid_range[1] - mid_range[0]) / im_shape

    max_side = np.max(size / resolution)
    if max_side > max_resolution:
        resolution *= max_side / max_resolution
    return resolution, (min_r, max_r)


# ---------------------------------------------------------------------------
# Weights (stitcher.py:251-263)
# ---------------------------------------------------------------------------

def hat(size: int) -> jnp.ndarray:
    """Triangular 0-0.5-0 ramp (stitcher.py:251-254)."""
    xx = jnp.arange(size, dtype=jnp.float32) - size / 2
    return 0.5 - jnp.abs(xx / size)


def add_weights(imgs: jnp.ndarray,
                shapes: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(N, H, W, 3) BGR [0,1] -> (N, H, W, 4) with hat-product alpha.

    ``shapes``: optional per-image (N, 2) true (h, w) when the stack is
    zero-padded to a common max shape (mixed-size inputs); the hat ramp
    then spans each image's true extent and is zero over the padding.
    """
    n, h, w, _ = imgs.shape
    if shapes is None:
        alpha = hat(h)[:, None] * hat(w)[None, :]
        alpha = jnp.broadcast_to(alpha, (n, h, w))
    else:
        hs = shapes[:, 0].astype(jnp.float32)[:, None, None]
        ws = shapes[:, 1].astype(jnp.float32)[:, None, None]
        yy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
        xx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
        hy = jnp.maximum(0.5 - jnp.abs((yy - hs / 2) / hs), 0.0)
        hx = jnp.maximum(0.5 - jnp.abs((xx - ws / 2) / ws), 0.0)
        alpha = hy * hx * (yy < hs) * (xx < ws)
    return jnp.concatenate([imgs, alpha[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Exposure compensation (stitcher.py:24-66)
# ---------------------------------------------------------------------------

def find_gains(overlaps: np.ndarray, sizes: np.ndarray,
               stdn: float = 0.1, stdg: float = 2.0) -> np.ndarray:
    """Solve the Brown-Lowe eq.(29) gain system (stitcher.py:24-33). Host."""
    nsize1 = (sizes + sizes.T) / (stdn * stdn)
    nsize2 = sizes / (stdg * stdg)
    aa = np.diag(np.sum(nsize1 * overlaps * overlaps + nsize2, axis=1))
    aa -= nsize1 * overlaps * overlaps.T
    return np.linalg.solve(aa, np.sum(nsize2, axis=1))


@functools.partial(jax.jit, static_argnames=("wh", "ww"))
def _pair_overlap_stats(imgs, homs_win, pair_i, pair_j, origins,
                        wh: int, ww: int, dims_i=None):
    """Overlap mean intensities for all pairs in one batched warp.

    Each pair works inside its own (wh, ww) window of image i's frame —
    the bbox of j's warped corners intersected with the frame, computed
    on the host (``estimate_gains``) — instead of warping the FULL
    frame per pair (stitcher.py:48-56 pays the full warp; at N views
    only ~adjacent pairs overlap, so the full-frame version did
    O(N^2 * H * W) device work for O(N * window) useful pixels).

    imgs: (N, H, W, 4); homs_win: (P, 3, 3) mapping j's pixels into the
    WINDOW's coords (i-frame hom pre-composed with the window origin
    shift); pair_i/pair_j: (P,) indices; origins: (P, 2) int (oy, ox)
    window origins in i's frame, host-clamped so the window lies inside
    the frame; ``dims_i``: optional per-pair (h_i, w_i) true dims
    restricting the overlap to image i's true region (padded mixed-size
    stacks). Returns (mean_i, mean_j, size) each (P,).
    """
    yy = jnp.arange(wh)[:, None]
    xx = jnp.arange(ww)[None, :]

    def one(hom, ii, jj, org, di):
        overlap = warp_perspective(imgs[jj], hom, (wh, ww),
                                   border="constant", cval=0.0)
        mask = overlap[..., 3] != 0
        if di is not None:
            mask &= ((yy + org[0] < di[0]) & (xx + org[1] < di[1]))
        cnt = jnp.sum(mask)
        win_i = lax.dynamic_slice(
            imgs[ii], (org[0], org[1], jnp.zeros((), org.dtype)),
            (wh, ww, imgs.shape[-1]))
        sum_i = jnp.sum(jnp.where(mask[..., None], win_i[..., :3], 0.0))
        sum_j = jnp.sum(jnp.where(mask[..., None], overlap[..., :3], 0.0))
        denom = jnp.maximum(cnt * 3, 1)
        return sum_i / denom, sum_j / denom, cnt

    if dims_i is None:
        return jax.vmap(lambda h, a, b, o: one(h, a, b, o, None))(
            homs_win, pair_i, pair_j, origins)
    return jax.vmap(one)(homs_win, pair_i, pair_j, origins, dims_i)


def estimate_gains(regions: List[PanoImage], imgs_rgba: jnp.ndarray,
                   shapes: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-image exposure gains over pairwise overlaps
    (stitcher.py:36-66). Returns the (N,) gain vector; application
    (``rgb * g`` clipped to [0, 1]) happens inside the fused
    warp+blend program so the corrected stack is never materialized
    separately.

    ``shapes``: optional per-image true (h, w) for padded mixed-size
    stacks.
    """
    overlaps, sizes = overlap_matrices(regions, imgs_rgba, shapes)
    gains = find_gains(overlaps, sizes)
    LOG.debug("Gains: %s", gains)
    return gains


def overlap_matrices(regions: List[PanoImage], imgs_rgba: jnp.ndarray,
                     shapes: Optional[np.ndarray] = None):
    """(overlaps, sizes) matrices feeding the Brown-Lowe gain solve:
    overlaps[i, j] = mean intensity of image i over the (i, j) overlap,
    sizes[i, j] = overlap pixel count (stitcher.py:36-56 semantics,
    computed in per-pair bbox windows instead of full frames)."""
    n = len(regions)
    height, width = imgs_rgba.shape[1:3]
    if shapes is None:
        shapes = np.array([[height, width]] * n)

    pair_i, pair_j, homs, boxes = [], [], [], []
    for i in range(n):
        hi, wi = shapes[i]
        tr = np.array([[1, 0, wi / 2], [0, 1, hi / 2], [0, 0, 1]])
        for j in range(i + 1, n):
            hj, wj = shapes[j]
            inv_tr = np.array([[1, 0, -wj / 2], [0, 1, -hj / 2],
                               [0, 0, 1]])
            corners = np.array([[0, 0, 1], [wj, 0, 1],
                                [wj, hj, 1], [0, hj, 1]])
            hom = tr @ _np_hom_to_from(regions[i], regions[j]) @ inv_tr
            pts = corners @ hom.T
            if np.any(pts[:, 2] < 0):   # behind the screen, skip
                continue
            # overlap bbox: warped-quad bounds (+2 px bilinear edge
            # fade) intersected with i's true frame; empty => the pair
            # contributes nothing, skip it entirely (at N views only
            # ~adjacent pairs overlap, so this prunes most of the
            # O(N^2) loop the reference pays in full)
            q = pts[:, :2] / pts[:, 2:3]
            x0 = max(int(np.floor(q[:, 0].min())) - 2, 0)
            y0 = max(int(np.floor(q[:, 1].min())) - 2, 0)
            x1 = min(int(np.ceil(q[:, 0].max())) + 2, int(wi))
            y1 = min(int(np.ceil(q[:, 1].max())) + 2, int(hi))
            if x0 >= x1 or y0 >= y1:
                continue
            pair_i.append(i)
            pair_j.append(j)
            homs.append(hom)
            boxes.append((y0, x0, y1, x1))
    overlaps = np.zeros((n, n))
    sizes = np.zeros((n, n))
    if homs:
        boxes = np.array(boxes)
        # one static window shape for all pairs (64-px buckets bound
        # recompiles across scenes), clamped into each frame
        wh = min(-(-int((boxes[:, 2] - boxes[:, 0]).max()) // 64) * 64,
                 height)
        ww = min(-(-int((boxes[:, 3] - boxes[:, 1]).max()) // 64) * 64,
                 width)
        oy = np.minimum(boxes[:, 0], height - wh)
        ox = np.minimum(boxes[:, 1], width - ww)
        shift = [np.array([[1, 0, -x], [0, 1, -y], [0, 0, 1]])
                 for y, x in zip(oy, ox)]
        homs_win = np.stack([s @ h for s, h in zip(shift, homs)])
        mi, mj, cnt = _pair_overlap_stats(
            imgs_rgba, jnp.asarray(homs_win, jnp.float32),
            jnp.asarray(pair_i), jnp.asarray(pair_j),
            jnp.asarray(np.stack([oy, ox], axis=1), jnp.int32), wh, ww,
            jnp.asarray(shapes[np.asarray(pair_i)], jnp.float32))
        mi, mj, cnt = np.asarray(mi), np.asarray(mj), np.asarray(cnt)
        for k in range(len(homs)):
            i, j = pair_i[k], pair_j[k]
            if cnt[k] == 0:
                continue
            sizes[i, j] = sizes[j, i] = cnt[k]
            overlaps[i, j] = mi[k]
            overlaps[j, i] = mj[k]
    return overlaps, sizes


def apply_gains(imgs_rgba: jnp.ndarray, gains) -> jnp.ndarray:
    """Scale rgb by per-image gains, clipped to [0, 1] (stitcher.py:63)."""
    g = jnp.asarray(gains, jnp.float32)[:, None, None, None]
    rgb = jnp.clip(imgs_rgba[..., :3] * g, 0.0, 1.0)
    return jnp.concatenate([rgb, imgs_rgba[..., 3:]], axis=-1)


def equalize_gains(regions: List[PanoImage], imgs_rgba: jnp.ndarray,
                   shapes: Optional[np.ndarray] = None) -> jnp.ndarray:
    """Estimate + apply exposure gains (stitcher.py:36-66); returns the
    gain-corrected (N, H, W, 4) stack."""
    return apply_gains(imgs_rgba,
                       estimate_gains(regions, imgs_rgba, shapes))


def _np_hom_to_from(c1: PanoImage, c2: PanoImage) -> np.ndarray:
    return (c1.intr @ c1.rot) @ (c2.rot.T @ np.linalg.inv(c2.intr))


# ---------------------------------------------------------------------------
# Backward warp (stitcher.py:288-319)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("ph", "pw", "projection",
                                             "period"))
def backward_warp_all(imgs, projs, bottoms, resolution, range_min,
                      ph: int, pw: int, projection=geo.SphProj,
                      shapes: Optional[jnp.ndarray] = None,
                      wins: Optional[jnp.ndarray] = None,
                      period: Optional[int] = None):
    """Backward-warp every region into its bbox-padded patch.

    imgs: (N, H, W, 4); projs: (N, 3, 3) = K R; bottoms: (N, 2) int patch
    origins in mosaic pixels; resolution/range_min: (2,); ``shapes``:
    optional per-image true (h, w) when the stack is padded to a common
    max shape; ``wins``: optional (N, 4) [lo_x, lo_y, hi_x, hi_y] true
    region windows in mosaic pixels — pixels outside [lo, hi) are marked
    invalid. Required whenever the common (ph, pw) patch shape is padded
    past a region's extent (compile-shape bucketing): the reference
    (stitcher.py:288-319) only renders inside each region's own bbox, so
    content the enlarged window can see past ``top`` must be masked off
    to keep paste parity. Returns (patches (N, ph, pw, 4),
    invalid (N, ph, pw)).

    ``period``: mosaic width of one full azimuth turn, in pixels, when
    the canvas wraps (spherical/cylindrical x is periodic). Patch
    columns past the seam (px >= period) sample at their FINAL mosaic
    column's azimuth (px - period) so the blend-time fold of the wrapped
    strip is exact — folding at integer ``period`` alone would shift
    content by the sub-pixel residual period*res_x - 2*pi. Window
    masking stays in unwrapped coords.
    """
    n, h, w, _ = imgs.shape
    if shapes is None:
        shapes = jnp.broadcast_to(jnp.asarray([h, w], jnp.float32), (n, 2))
    if wins is None:
        wins = jnp.broadcast_to(
            jnp.asarray([-1.0, -1.0, np.inf, np.inf], jnp.float32), (n, 4))

    y_i, x_i = jnp.meshgrid(jnp.arange(ph, dtype=jnp.float32),
                            jnp.arange(pw, dtype=jnp.float32), indexing="ij")

    def one(img, proj, bottom, hw, win):
        hh, ww = hw[0], hw[1]
        px = x_i + bottom[0]
        py = y_i + bottom[1]
        px_s = px if period is None else px - period * (px >= period)
        xs = px_s * resolution[0] + range_min[0]
        ys = py * resolution[1] + range_min[1]
        rays = projection.proj2hom(jnp.stack([xs, ys], axis=-1))
        xx = jnp.einsum("ij,hwj->hwi", proj.astype(jnp.float32), rays,
                        precision=jax.lax.Precision.HIGHEST)
        mask = xx[..., 2] < 0   # behind the screen
        x_pr = xx[..., 0] / xx[..., 2] + ww / 2
        y_pr = xx[..., 1] / xx[..., 2] + hh / 2
        mask |= ((x_pr < 0) | (x_pr > ww - 1)
                 | (y_pr < 0) | (y_pr > hh - 1))
        mask |= ((px < win[0]) | (py < win[1])
                 | (px >= win[2]) | (py >= win[3]))
        warped = remap_bilinear(img, x_pr, y_pr, border="reflect")
        warped = warped.at[..., 3].set(warped[..., 3] * (~mask))
        return warped, mask

    # named scope: the trace reduction (benchmarks/device_profile.py)
    # sums the warp's gather kernels under this name
    with jax.named_scope(WARP_SCOPE):
        return jax.vmap(one)(imgs, projs, bottoms.astype(jnp.float32),
                             shapes.astype(jnp.float32),
                             wins.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Blenders (stitcher.py:160-248)
# ---------------------------------------------------------------------------

def _paste_loop(init, bottoms, win_shape, fn, n):
    """Sequential read-modify-write of patch windows at ``bottoms[k]``,
    rolled as a ``fori_loop`` so the HLO stays one loop body regardless
    of the patch count (python-unrolled pastes made the blenders'
    compiles scale with N — 75+ dynamic-slice passes at 15 views
    dominated cold-start time). ``fn(k, cur) -> new``."""
    def body(k, mos):
        zero = jnp.zeros((), bottoms.dtype)
        start = (bottoms[k, 1], bottoms[k, 0]) + (zero,) * (mos.ndim - 2)
        cur = jax.lax.dynamic_slice(mos, start,
                                    win_shape + mos.shape[len(win_shape):])
        return jax.lax.dynamic_update_slice(mos, fn(k, cur), start)

    return jax.lax.fori_loop(0, n, body, init)


# Periodic (wrap-around) canvases: when the mosaic spans the full
# azimuth circle, patch windows may cross the seam. Pastes then run on a
# canvas x-extended by pw (so every window fits contiguously) and the
# spilled strip [period, period + pw) is FOLDED back onto [0, pw) with
# the blender's own reduction: + for weighted accumulators, weight-max
# for the seam assignment, last-writer for the sequential paste. The
# warp samples fold columns at their final-column azimuth
# (``backward_warp_all`` period arg), so the fold is exact.

def _ext(shape: Tuple[int, int], period: Optional[int], pw: int):
    """Paste-canvas shape: x-extended past the full turn when periodic.

    ``period`` can exceed the canvas width by a couple of pixels (the
    reference's border-sampled extent undershoots 2*pi slightly), so the
    extension is anchored at max(width, period)."""
    if period is None:
        return shape
    return (shape[0], max(shape[1], period) + pw)


def _fold_add(acc, shape, period: Optional[int], pw: int):
    if period is None:
        return acc
    marg = acc[:, period:period + pw]
    return acc[:, :shape[1]].at[:, :pw].add(marg)


@functools.partial(jax.jit, static_argnames=("shape", "period"))
def blend_none(patches, masks, bottoms, shape: Tuple[int, int],
               period: Optional[int] = None):
    """Sequential paste without blending (stitcher.py:160-168)."""
    n, ph, pw = patches.shape[:3]
    if period is None:
        mosaic = _paste_loop(
            jnp.zeros(shape + (3,), jnp.float32), bottoms, (ph, pw),
            lambda k, cur: jnp.where(masks[k][..., None], cur,
                                     patches[k][..., :3]), n)
    else:
        # channel 3 tracks the writer (k+1): overwrite = LAST writer
        # wins, and the paste loop ascends, so the fold takes whichever
        # side holds the higher index
        def fn(k, cur):
            kf = jnp.broadcast_to((k + 1).astype(jnp.float32),
                                  (ph, pw, 1))
            tile = jnp.concatenate([patches[k][..., :3], kf], axis=-1)
            return jnp.where(masks[k][..., None], cur, tile)

        acc = _paste_loop(jnp.zeros(_ext(shape, period, pw) + (4,),
                                    jnp.float32), bottoms, (ph, pw), fn, n)
        marg = acc[:, period:period + pw]
        main = acc[:, :shape[1]]
        take = (marg[..., 3] > main[:, :pw, 3])[..., None]
        mosaic = main.at[:, :pw].set(
            jnp.where(take, marg, main[:, :pw]))[..., :3]
    return jnp.clip(mosaic * 255, 0, 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("shape", "period"))
def blend_linear(patches, masks, bottoms, shape: Tuple[int, int],
                 period: Optional[int] = None):
    """Alpha-weighted average (stitcher.py:171-183)."""
    n, ph, pw = patches.shape[:3]

    def fn(k, cur):
        p = patches[k]
        tile = jnp.where(masks[k][..., None], 0.0, p[..., :3])
        return cur + jnp.concatenate([tile * p[..., 3:], p[..., 3:]],
                                     axis=-1)

    acc = _paste_loop(jnp.zeros(_ext(shape, period, pw) + (4,),
                                jnp.float32), bottoms, (ph, pw), fn, n)
    acc = _fold_add(acc, shape, period, pw)
    wsum = jnp.where(acc[..., 3] == 0, 1.0, acc[..., 3])
    mosaic = acc[..., :3] / wsum[..., None]
    return jnp.clip(mosaic * 255, 0, 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("shape", "n_levels",
                                             "period"))
def blend_multiband(patches, masks, bottoms, shape: Tuple[int, int],
                    n_levels: int = 5, period: Optional[int] = None):
    """Multi-band blending (stitcher.py:186-241), bands from DoGs of each
    patch with sigma = sqrt(2l+1)*4, sharp argmax-weight seams."""
    n, ph, pw = patches.shape[:3]
    ext = _ext(shape, period, pw)

    # 1) argmax-weight seam assignment (stitcher.py:196-204)
    def seam_fn(k, cur):
        w_cur, i_cur = cur[..., 0], cur[..., 1]
        w_new = patches[k][..., 3]
        take = w_new > w_cur
        return jnp.stack([jnp.where(take, w_new, w_cur),
                          jnp.where(take, k.astype(jnp.float32), i_cur)],
                         axis=-1)

    packed = _paste_loop(
        jnp.concatenate([jnp.zeros(ext + (1,), jnp.float32),
                         jnp.full(ext + (1,), -1.0, jnp.float32)],
                        axis=-1), bottoms, (ph, pw), seam_fn, n)
    if period is not None:
        # weight-max fold, then periodic re-extension so window reads at
        # columns >= period see the folded winners
        marg = packed[:, period:period + pw]
        main = packed[:, :shape[1]]
        take = (marg[..., 0] > main[:, :pw, 0])[..., None]
        folded = main.at[:, :pw].set(jnp.where(take, marg, main[:, :pw]))
        if period > shape[1]:
            # the canvas undershoots a full turn (border-sampled extent,
            # see _ext): columns [shape[1], period) hold winners past the
            # crop edge that seam windows can still read — keep them, or
            # the re-extension below is shifted by period - shape[1] px
            folded = jnp.concatenate(
                [folded, packed[:, shape[1]:period]], axis=1)
        packed = jnp.concatenate(
            [folded[:, :period], folded[:, :ext[1] - period]], axis=1)
    best_i = packed[..., 1].astype(jnp.int32)

    # sharp masks: alpha := (argmax == k) (stitcher.py:207-209)
    def sharp_one(k, patch, bottom):
        win = jax.lax.dynamic_slice(best_i, (bottom[1], bottom[0]),
                                    (ph, pw))
        return patch.at[..., 3].set((win == k).astype(jnp.float32))

    patches = jax.vmap(sharp_one)(jnp.arange(n, dtype=jnp.int32),
                                  patches, bottoms)

    # allmask: union of valid pixels (stitcher.py:212,233-236)
    allmask = _paste_loop(
        jnp.zeros(ext, bool), bottoms, (ph, pw),
        lambda k, cur: cur | ~masks[k], n)
    if period is not None:
        marg = allmask[:, period:period + pw]
        allmask = allmask[:, :shape[1]].at[:, :pw].set(
            allmask[:, :pw] | marg)

    mosaic = jnp.zeros(shape + (3,), jnp.float32)
    prevs = patches
    for lvl in range(n_levels):
        sigma = float(np.sqrt(2 * lvl + 1.0) * 4)
        is_last = lvl == n_levels - 1
        if not is_last:
            blurred = gaussian_blur(patches, sigma)
            tiles_rgb = prevs[..., :3] - blurred[..., :3]
            tiles_a = blurred[..., 3]
        else:
            tiles_rgb = prevs[..., :3]
            tiles_a = prevs[..., 3]

        def acc_fn(k, cur, tiles_rgb=tiles_rgb, tiles_a=tiles_a):
            return cur + jnp.concatenate(
                [tiles_rgb[k] * tiles_a[k][..., None],
                 tiles_a[k][..., None]], axis=-1)

        acc = _paste_loop(jnp.zeros(ext + (4,), jnp.float32), bottoms,
                          (ph, pw), acc_fn, n)
        acc = _fold_add(acc, shape, period, pw)

        layer = jnp.where(allmask[..., None], acc[..., :3], 0.0)
        wsum = jnp.where(acc[..., 3] == 0, 1.0, acc[..., 3])
        mosaic = mosaic + layer / wsum[..., None]
        if not is_last:
            prevs = blurred

    mosaic = jnp.clip(mosaic, 0.0, 1.0)
    return (mosaic * 255).astype(jnp.uint8)


BLENDERS = {
    "none": blend_none,
    "linear": blend_linear,
    "multiband": blend_multiband,
}


@functools.partial(jax.jit, static_argnames=("ph", "pw", "projection",
                                             "blender", "shape",
                                             "period"))
def _warp_and_blend(imgs, gains, projs, bottoms, resolution, range_min,
                    ph: int, pw: int, shape: Tuple[int, int],
                    blender: str, projection=geo.SphProj, shapes=None,
                    wins=None, period: Optional[int] = None):
    """Weights + (gains) + backward warp + blend in ONE dispatch.

    ``imgs``: (N, H, W, 3) float BGR in [0, 1]; the hat-ramp alpha and
    the optional exposure gains are computed inside the program so the
    240-MB rgba stack never round-trips device memory between dispatches
    (and the host saves the extra dispatch latency). ``gains``: optional (N,)
    exposure gains from ``estimate_gains``."""
    imgs_rgba = add_weights(imgs, shapes)
    if gains is not None:
        imgs_rgba = apply_gains(imgs_rgba, gains)
    patches, invalid = backward_warp_all(
        imgs_rgba, projs, bottoms, resolution, range_min, ph, pw,
        projection, shapes, wins, period)
    return (BLENDERS[blender](patches, invalid, bottoms, shape,
                              period=period), invalid)


def _packed_take_combine(parts):
    """Ordered combine of per-device packed (key, payload...) canvases:
    strictly-greater key wins, scanning devices in ascending order —
    exactly the sequential paste loop's first-wins (seam) / last-wins
    (ascending writer ids) tie rules, since each device holds a
    contiguous ascending patch range."""
    def body(d, cur):
        take = (parts[d, ..., 0] > cur[..., 0])[..., None]
        return jnp.where(take, parts[d], cur)

    return jax.lax.fori_loop(1, parts.shape[0], body, parts[0])


def _blend_sharded(blender: str, patches, masks, bottoms, shape,
                   period: Optional[int], axis_name: str):
    """Patch-sharded blenders for the mesh path.

    The replicated mesh blend (round 3) all-gathered every patch and
    replayed the full O(N) sequential paste on every device, so blend
    cost did not shard at all. Here each device pastes only its LOCAL
    patch shard (``patches``/``masks``/``bottoms`` are shard_map shards)
    into its own canvas accumulator, and the accumulators combine across
    the mesh with the blender's own associative reduction:

    - ``linear`` / ``multiband`` band sums: ordered per-device partial
      sums (all_gather + ascending sum — deterministic, same grouped-
      reduction idea as register._group_reduce);
    - ``multiband`` seam assignment: strictly-greater weight-max over
      ascending device order (= the sequential loop's first-wins rule);
    - ``none``: last-writer-wins via ascending writer ids;
    - validity union: OR.

    Multiband's per-level Gaussian blurs — the dominant blend cost —
    run on the local patch shard, so they shard perfectly. Padded
    regions (mesh-multiple padding) carry all-invalid masks and zero
    alpha, so they contribute nothing to any reduction. The combined
    canvas math past the reduction runs replicated (a few mosaic-sized
    elementwise passes). Returns the uint8 mosaic (replicated).
    """
    n_local, ph, pw = patches.shape[:3]
    ext = _ext(shape, period, pw)
    k0 = jax.lax.axis_index(axis_name) * n_local  # global id of slot 0
    gather = functools.partial(jax.lax.all_gather, axis_name=axis_name,
                               tiled=False)

    def reduce_sum(local):
        return jnp.sum(gather(local), axis=0)

    if blender == "none":
        # channel 3 = writer id (global k+1); combine keeps the max id
        def fn(k, cur):
            kf = jnp.broadcast_to((k0 + k + 1).astype(jnp.float32),
                                  (ph, pw, 1))
            tile = jnp.concatenate([patches[k][..., :3], kf], axis=-1)
            return jnp.where(masks[k][..., None], cur, tile)

        acc = _paste_loop(jnp.zeros(ext + (4,), jnp.float32), bottoms,
                          (ph, pw), fn, n_local)
        # move the writer id into the leading "key" slot for the combine
        acc = _packed_take_combine(gather(acc[..., (3, 0, 1, 2)]))
        if period is not None:
            marg = acc[:, period:period + pw]
            main = acc[:, :shape[1]]
            take = (marg[..., 0] > main[:, :pw, 0])[..., None]
            acc = main.at[:, :pw].set(jnp.where(take, marg,
                                                main[:, :pw]))
        mosaic = acc[:, :shape[1], 1:]
        return jnp.clip(mosaic * 255, 0, 255).astype(jnp.uint8)

    if blender == "linear":
        def fn(k, cur):
            p = patches[k]
            tile = jnp.where(masks[k][..., None], 0.0, p[..., :3])
            return cur + jnp.concatenate([tile * p[..., 3:], p[..., 3:]],
                                         axis=-1)

        acc = reduce_sum(_paste_loop(jnp.zeros(ext + (4,), jnp.float32),
                                     bottoms, (ph, pw), fn, n_local))
        acc = _fold_add(acc, shape, period, pw)
        wsum = jnp.where(acc[..., 3] == 0, 1.0, acc[..., 3])
        mosaic = acc[..., :3] / wsum[..., None]
        return jnp.clip(mosaic * 255, 0, 255).astype(jnp.uint8)

    assert blender == "multiband", blender
    n_levels = 5

    # 1) seam assignment: local weight-max paste, cross-device combine
    def seam_fn(k, cur):
        w_new = patches[k][..., 3]
        take = w_new > cur[..., 0]
        kf = (k0 + k).astype(jnp.float32)
        return jnp.stack([jnp.where(take, w_new, cur[..., 0]),
                          jnp.where(take, kf, cur[..., 1])], axis=-1)

    packed = _paste_loop(
        jnp.concatenate([jnp.zeros(ext + (1,), jnp.float32),
                         jnp.full(ext + (1,), -1.0, jnp.float32)],
                        axis=-1), bottoms, (ph, pw), seam_fn, n_local)
    packed = _packed_take_combine(gather(packed))
    if period is not None:
        marg = packed[:, period:period + pw]
        main = packed[:, :shape[1]]
        take = (marg[..., 0] > main[:, :pw, 0])[..., None]
        folded = main.at[:, :pw].set(jnp.where(take, marg, main[:, :pw]))
        if period > shape[1]:
            folded = jnp.concatenate(
                [folded, packed[:, shape[1]:period]], axis=1)
        packed = jnp.concatenate(
            [folded[:, :period], folded[:, :ext[1] - period]], axis=1)
    best_i = packed[..., 1].astype(jnp.int32)

    def sharp_one(k, patch, bottom):
        win = jax.lax.dynamic_slice(best_i, (bottom[1], bottom[0]),
                                    (ph, pw))
        return patch.at[..., 3].set((win == k0 + k).astype(jnp.float32))

    patches = jax.vmap(sharp_one)(jnp.arange(n_local, dtype=jnp.int32),
                                  patches, bottoms)

    allmask = _paste_loop(
        jnp.zeros(ext, bool), bottoms, (ph, pw),
        lambda k, cur: cur | ~masks[k], n_local)
    allmask = jnp.any(gather(allmask), axis=0)
    if period is not None:
        marg = allmask[:, period:period + pw]
        allmask = allmask[:, :shape[1]].at[:, :pw].set(
            allmask[:, :pw] | marg)

    mosaic = jnp.zeros(shape + (3,), jnp.float32)
    prevs = patches
    for lvl in range(n_levels):
        sigma = float(np.sqrt(2 * lvl + 1.0) * 4)
        is_last = lvl == n_levels - 1
        if not is_last:
            blurred = gaussian_blur(patches, sigma)   # local shard only
            tiles_rgb = prevs[..., :3] - blurred[..., :3]
            tiles_a = blurred[..., 3]
        else:
            tiles_rgb = prevs[..., :3]
            tiles_a = prevs[..., 3]

        def acc_fn(k, cur, tiles_rgb=tiles_rgb, tiles_a=tiles_a):
            return cur + jnp.concatenate(
                [tiles_rgb[k] * tiles_a[k][..., None],
                 tiles_a[k][..., None]], axis=-1)

        acc = reduce_sum(_paste_loop(jnp.zeros(ext + (4,), jnp.float32),
                                     bottoms, (ph, pw), acc_fn, n_local))
        acc = _fold_add(acc, shape, period, pw)

        layer = jnp.where(allmask[..., None], acc[..., :3], 0.0)
        wsum = jnp.where(acc[..., 3] == 0, 1.0, acc[..., 3])
        mosaic = mosaic + layer / wsum[..., None]
        if not is_last:
            prevs = blurred

    mosaic = jnp.clip(mosaic, 0.0, 1.0)
    return (mosaic * 255).astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _warp_and_blend_mesh_fn(mesh, ph: int, pw: int,
                            shape: Tuple[int, int], blender: str,
                            projection, n_true: int,
                            period: Optional[int] = None):
    """Region-sharded warp AND blend over a device mesh.

    The backward warp — the FLOP/bandwidth-heavy stage — runs on each
    device's region shard, and the blend shards over the patch axis too
    (``_blend_sharded``): each device pastes its local shard into its
    own canvas and the canvases combine across the mesh with the blender's
    associative reduction, so neither the patches nor the per-level
    multiband blurs replicate. Only the validity masks all-gather (for
    crop). Region arrays must be padded to a mesh multiple; the padding
    carries all-invalid windows so it contributes nothing; ``n_true``
    slices it off the returned masks.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(imgs, gains, projs, bottoms_sh, resolution,
              range_min, shapes_sh, wins_sh):
        imgs_rgba = add_weights(imgs, shapes_sh)
        if gains is not None:
            imgs_rgba = apply_gains(imgs_rgba, gains)
        patches, invalid = backward_warp_all(
            imgs_rgba, projs, bottoms_sh, resolution, range_min, ph, pw,
            projection, shapes_sh, wins_sh, period)
        mosaic = _blend_sharded(blender, patches, invalid, bottoms_sh,
                                shape, period, "data")
        invalid = jax.lax.all_gather(invalid, axis_name="data",
                                     tiled=True)[:n_true]
        return mosaic, invalid

    sm = shard_map(local, mesh=mesh,
                   in_specs=(P("data"), P("data"), P("data"), P("data"),
                             P(), P(), P("data"), P("data")),
                   out_specs=(P(), P()), check_vma=False)
    return jax.jit(sm)


def _crop_valid(invalid: np.ndarray, bottoms: np.ndarray, ph: int,
                pw: int, shape: Tuple[int, int],
                period: Optional[int]) -> np.ndarray:
    """Union of valid patch pixels on the canvas (host, for crop).

    With a periodic canvas the spilled strip folds back like the
    blenders' pastes do.
    """
    # mirror _ext: pastes land at x0 up to period-1, so the extended
    # canvas must anchor at max(width, period) or periodic scenes whose
    # canvas undershoots the full turn (period > shape[1]) overflow
    ext_w = shape[1] if period is None else max(shape[1], period) + pw
    valid = np.zeros((shape[0], ext_w), bool)
    for k in range(invalid.shape[0]):
        x0, y0 = bottoms[k]
        valid[y0:y0 + ph, x0:x0 + pw] |= ~invalid[k]
    if period is not None:
        valid[:, :pw] |= valid[:, period:period + pw]
    return valid[:, :shape[1]]


class MosaicLayout(NamedTuple):
    """Canvas + patch-window geometry shared by stitch() and the warp
    benchmarks (host-side plan; see ``plan_layout``)."""

    shape: Tuple[int, int]      # padded canvas (H, W) for the blenders
    out_hw: Tuple[int, int]     # true output (H, W) sliced at the end
    bottoms: np.ndarray         # (N, 2) int patch origins [x, y]
    wins: np.ndarray            # (N, 4) true windows [lo_x, lo_y, hi_x, hi_y)
    ph: int                     # shared patch height
    pw: int                     # shared patch width
    period: Optional[int]       # full-turn width when periodic, else None
    resolution: np.ndarray      # (2,) rad/px
    im_range: Tuple[np.ndarray, np.ndarray]


def plan_layout(regions: List[PanoImage], ranges: np.ndarray,
                blender: str, max_resolution: int,
                proj=geo.SphProj) -> MosaicLayout:
    """Canvas shape, patch windows and periodicity for a render.

    ``ranges``: the (4, N, 2) [rmin, rmax, uw_min, uw_max] array from
    ``proj_img_range_border(unwrapped=True)``; ``regions[k].range`` must
    already hold the wrapped range (canvas/resolution parity with the
    reference, stitcher.py:142-157). Seam-crossing views get windows
    from their UNWRAPPED ranges and paste modulo the full-turn width
    ``period`` (see the blender fold logic).
    """
    n = len(regions)
    rmin, rmax, uw_min, uw_max = np.asarray(ranges, np.float64)
    resolution, im_range = estimate_resolution(regions, max_resolution,
                                               proj)
    target = (im_range[1] - im_range[0]) / resolution
    shape = tuple(int(t) for t in np.round(target))[::-1]  # (H, W)

    # Periodic canvas: a view crossing the azimuth seam has a wrapped
    # range degenerating to ~[-pi, pi] (full canvas width); its UNWRAPPED
    # range keeps the true footprint, with the patch pasted modulo the
    # full-turn width ``period`` (canvas/resolution stay on the wrapped
    # ranges for reference parity; see the fold logic in the blenders).
    period = int(round(2 * np.pi / resolution[0]))
    # half-pixel threshold: the unwrap mod-chain carries a few f32 ULPs
    # of rounding (~1e-6 rad), so a too-tight epsilon flags non-crossing
    # views on every scene; crossings below half a pixel don't need the
    # periodic path anyway
    eps = 0.5 * float(resolution[0])
    crossing = ((uw_min[:, 0] < im_range[0][0] - eps)
                | (uw_max[:, 0] > im_range[1][0] + eps))
    # the canvas spans (just under) the full turn whenever any view
    # crosses the seam — its wrapped range forces ~[-pi, pi], with the
    # border sampling undershooting the exact extremes by a few pixels;
    # period < width would mean a canvas wider than one turn (impossible
    # for wrapped ranges, guarded for degenerate resolutions)
    use_wrap = bool(crossing.any()) and period + 1 >= shape[1]

    lo_r = np.where(crossing[:, None], uw_min, rmin) if use_wrap else rmin
    hi_r = np.where(crossing[:, None], uw_max, rmax) if use_wrap else rmax
    bottoms, tops = [], []
    for k in range(n):
        bottom = np.round((lo_r[k] - im_range[0]) / resolution)
        top = np.round((hi_r[k] - im_range[0]) / resolution)
        bottom, top = bottom.astype(np.int64), top.astype(np.int64)
        if blender == "multiband":   # pad to avoid sharp edges
            bottom, top = bottom - 10, top + 10
            bottom[1] = max(bottom[1], 0)           # y: canvas-clamped
            top[1] = min(top[1], int(target[1]))
            if not use_wrap:                        # x: only if aperiodic
                bottom[0] = max(bottom[0], 0)
                top[0] = min(top[0], int(target[0]))
        bottoms.append(bottom)
        tops.append(top)
    bottoms = np.stack(bottoms)
    tops = np.stack(tops)
    if use_wrap and int((tops[:, 0] - bottoms[:, 0]).max()) > period:
        # a single window wider than the full turn (degenerate): fall
        # back to the non-periodic full-width path
        use_wrap = False
        bottoms = np.round((rmin - im_range[0]) / resolution).astype(np.int64)
        tops = np.round((rmax - im_range[0]) / resolution).astype(np.int64)
        if blender == "multiband":
            bottoms = np.maximum(bottoms - 10, 0)
            tops = np.minimum(tops + 10, target.astype(np.int64))

    # one padded patch shape for all regions (static under jit)
    ph = int((tops[:, 1] - bottoms[:, 1]).max())
    pw = int((tops[:, 0] - bottoms[:, 0]).max())
    # compile-shape bucketing: the mosaic canvas is padded to 64-px
    # multiples and the patch windows to 32-px multiples (the canvas
    # padding is sliced off after blending). The true extent bounds
    # every region's projection, so the padding never receives content;
    # in exchange, runs whose scene spread differs slightly (same rig,
    # different scene) reuse one warp+blend program instead of
    # recompiling per mosaic shape. Canvas padding costs only a few
    # mosaic-sized elementwise passes; patch padding costs warp+blur area, hence
    # the finer 32-px grain (<=16% overhead vs <=33% at 64).
    out_hw = shape
    if os.environ.get("P360_BUCKET_CANVAS", "1") == "1":
        shape = (-(-shape[0] // 64) * 64, -(-shape[1] // 64) * 64)
    if os.environ.get("P360_BUCKET_PATCH", "1") == "1":
        ph = -(-ph // 32) * 32
        pw = -(-pw // 32) * 32
    # true per-region windows [lo_x, lo_y, hi_x, hi_y): whenever padding
    # or the shared (ph, pw) enlarges a patch past its region's own bbox,
    # the warp masks the excess so it receives no content (the reference
    # renders strictly inside each bbox; without this, padded windows
    # paint real backward-projected content into mosaic rows/cols the
    # reference leaves empty — a 43 dB paste-parity regression).
    wins = np.concatenate([bottoms, tops], axis=1)
    # clamp: a patch window must fit inside the mosaic for dynamic slicing
    ph, pw = min(ph, shape[0]), min(pw, shape[1])
    if use_wrap:
        # periodic x: origins wrap into [0, period); the paste canvas is
        # x-extended by pw so every window fits contiguously, and wins
        # shift with their origin so the warp's unwrapped-coord masking
        # stays consistent
        x0 = bottoms[:, 0] % period
        shift = x0 - bottoms[:, 0]
        wins[:, 0] += shift
        wins[:, 2] += shift
        bottoms[:, 0] = x0
    else:
        bottoms[:, 0] = np.clip(bottoms[:, 0], 0, shape[1] - pw)
    bottoms[:, 1] = np.clip(bottoms[:, 1], 0, shape[0] - ph)
    return MosaicLayout(shape, out_hw, bottoms, wins, ph, pw,
                        period if use_wrap else None, resolution, im_range)


# ---------------------------------------------------------------------------
# Stitch orchestration (stitcher.py:274-327)
# ---------------------------------------------------------------------------

def stitch(regions: List[PanoImage], blender: str = "multiband",
           equalize: bool = False, crop: bool = False,
           dev_images=None,
           max_resolution: int = MAX_RESOLUTION,
           projection: str = "spherical", mesh=None) -> np.ndarray:
    """Full render: ranges -> weights -> (equalize) -> warp -> blend -> crop.

    ``regions[k].img``: uint8 BGR or float BGR in [0, 1]; mixed image
    shapes are zero-padded to the max shape with per-image true dims
    masking the padding. ``dev_images``: optional
    device-resident uint8 stack (from ``pipeline.to_device``) to skip the
    upload. ``projection``: "spherical" (the reference's main
    path) or "cylindrical" (the reference ships the model,
    stitcher.py:90-104, but never wires it; here it is a first-class
    output mode). ``mesh``: optional ``jax.sharding.Mesh`` ("data" axis)
    — the backward warp AND the blend shard over regions; per-device
    canvas accumulators combine across the mesh with each blender's
    associative reduction (``_blend_sharded``). Returns a uint8 BGR
    mosaic.

    Seam-crossing views (360-degree sweeps) render into their TRUE
    unwrapped footprint and paste modulo the full-turn width instead of
    forcing a canvas-wide patch window on every region (the wrapped
    extent of a crossing view degenerates to ~[-pi, pi]); see
    ``proj_img_range_border(unwrapped=True)`` and the blender fold
    logic. Measured ~6x less warp+blend work on the 15-view bench scene.
    """
    proj = geo.PROJECTIONS[projection]
    n = len(regions)
    shapes = np.array([r.img.shape[:2] for r in regions])
    uniform = bool((shapes == shapes[0]).all())
    h, w = int(shapes[:, 0].max()), int(shapes[:, 1].max())
    if dev_images is not None and hasattr(dev_images, "to_padded"):
        # BucketStacks from upload_extract (mixed shapes): the pixels are
        # already device-resident per bucket; zero-pad them to the max
        # shape ON DEVICE instead of re-uploading a host-padded stack
        dev_images = (dev_images.to_padded(h, w)
                      if dev_images.n == n else None)
    if dev_images is not None and dev_images.shape[0] == n:
        dev_imgs = dev_images.astype(jnp.float32) / 255.0
    elif uniform:
        imgs = np.stack([r.img for r in regions])
        # upload in the source dtype (uint8 is 4x smaller), convert on device
        dev_imgs = jnp.asarray(imgs)
        if imgs.dtype == np.uint8:
            dev_imgs = dev_imgs.astype(jnp.float32) / 255.0
    else:
        # mixed shapes (features.py:259-265 handles images independently):
        # zero-pad to the max shape; per-image true dims mask the padding
        # in the weights, warp bounds and equalization
        dtype = regions[0].img.dtype
        stack = np.zeros((n, h, w, 3), dtype)
        for k, r in enumerate(regions):
            hk, wk = r.img.shape[:2]
            stack[k, :hk, :wk] = r.img
        dev_imgs = jnp.asarray(stack)
        if dtype == np.uint8:
            dev_imgs = dev_imgs.astype(jnp.float32) / 255.0

    shapes_dev = None if uniform else jnp.asarray(shapes, jnp.float32)
    homs = np.stack([r.hom() for r in regions])
    ranges = np.asarray(proj_img_range_border(
        (h, w), jnp.asarray(homs), projection=proj, shapes=shapes_dev,
        unwrapped=True), np.float64)
    rmin, rmax, uw_min, uw_max = ranges
    for k, reg in enumerate(regions):
        reg.range = (rmin[k], rmax[k])

    dev_imgs = dev_imgs.astype(jnp.float32)
    gains = None
    if equalize:
        gains = estimate_gains(regions, add_weights(dev_imgs, shapes_dev),
                               None if uniform else shapes)
        gains = jnp.asarray(gains, jnp.float32)

    layout = plan_layout(regions, ranges, blender, max_resolution, proj)
    (shape, (out_h, out_w), bottoms, wins, ph, pw, wrap_period,
     resolution, im_range) = layout
    use_wrap = wrap_period is not None

    projs = np.stack([r.proj() for r in regions])
    if mesh is not None:
        nd = int(mesh.devices.size)
        npad = -(-n // nd) * nd
        imgs_pad = jnp.concatenate(
            [dev_imgs, jnp.zeros((npad - n,) + dev_imgs.shape[1:],
                                 dev_imgs.dtype)]) if npad > n \
            else dev_imgs
        gains_pad = jnp.ones((npad,), jnp.float32) if gains is None \
            else jnp.concatenate([gains,
                                  jnp.ones((npad - n,), jnp.float32)])
        projs_pad = np.concatenate(
            [projs, np.broadcast_to(np.eye(3), (npad - n, 3, 3))])
        bottoms_pad = np.concatenate(
            [bottoms, np.zeros((npad - n, 2), bottoms.dtype)])
        shapes_pad = np.concatenate(
            [shapes, np.broadcast_to(np.array([h, w]), (npad - n, 2))])
        wins_pad = np.concatenate(
            [wins, np.full((npad - n, 4), -1, wins.dtype)])
        fn = _warp_and_blend_mesh_fn(mesh, ph, pw, shape, blender, proj, n,
                                     wrap_period)
        mosaic, invalid = fn(
            imgs_pad, gains_pad, jnp.asarray(projs_pad, jnp.float32),
            jnp.asarray(bottoms_pad, jnp.int32),
            jnp.asarray(resolution, jnp.float32),
            jnp.asarray(im_range[0], jnp.float32),
            jnp.asarray(shapes_pad, jnp.float32),
            jnp.asarray(wins_pad, jnp.float32))
        mosaic = np.asarray(mosaic)[:out_h, :out_w]
        if crop:
            LOG.debug("Cropping...")
            from pano360.native import crop_mosaic
            valid = _crop_valid(np.asarray(invalid), bottoms, ph, pw,
                                shape, wrap_period)
            mosaic = crop_mosaic(mosaic, valid[:out_h, :out_w])
        return mosaic

    mosaic, invalid = _warp_and_blend(
        dev_imgs, gains, jnp.asarray(projs, jnp.float32),
        jnp.asarray(bottoms, jnp.int32),
        jnp.asarray(resolution, jnp.float32),
        jnp.asarray(im_range[0], jnp.float32), ph, pw, shape,
        blender, projection=proj, shapes=shapes_dev,
        wins=jnp.asarray(wins, jnp.float32), period=wrap_period)
    mosaic = np.asarray(mosaic)[:out_h, :out_w]

    if crop:
        LOG.debug("Cropping...")
        from pano360.native import crop_mosaic
        valid = _crop_valid(np.asarray(invalid), bottoms, ph, pw, shape,
                            wrap_period)
        mosaic = crop_mosaic(mosaic, valid[:out_h, :out_w])

    return mosaic


__all__ = [
    "MAX_RESOLUTION", "proj_img_range_border", "proj_img_range_corners",
    "estimate_resolution", "hat", "add_weights", "find_gains",
    "estimate_gains", "apply_gains", "equalize_gains",
    "backward_warp_all", "MosaicLayout", "plan_layout",
    "blend_none", "blend_linear", "blend_multiband", "BLENDERS", "stitch",
]
