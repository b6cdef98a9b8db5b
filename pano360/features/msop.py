"""MSOP (Multi-Scale Oriented Patches) detector.

Re-design of the reference's MSOP path (features.py:102-156, 204-212):
a 4-level Harris pyramid with 3x3 local maxima, SSC adaptive non-maximal
suppression (Bailo et al. 2018) for homogeneous keypoint coverage, and
oriented, blurred 8x8 patch descriptors.

Device work (Harris response, max filter, pyramid, patch warps) runs through
the ops library; the SSC binary search is inherently sequential host logic
(SURVEY.md §7 hard part #6) and stays in numpy.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pano360.ops.filters import (gaussian_blur, feature_ksize,
                                     harris_response, max_pool3x3, pyr_down,
                                     sobel)
from pano360.ops.color import bgr2gray

DSIZE = 8          # descriptor size (features.py:16)
MAX_FEAT = (5000, 100, 25, 10)   # per-level budgets (features.py:133)


# ---------------------------------------------------------------------------
# SSC adaptive non-maximal suppression (features.py:28-99 re-implementation)
# ---------------------------------------------------------------------------

def ssc(keypoints: np.ndarray, im_size: Tuple[int, int], n_points: int,
        tol: float = 0.1) -> np.ndarray:
    """Pick ~n_points spatially homogeneous keypoints (score-ordered input).

    Binary search over the suppression radius; each trial greedily keeps
    points whose grid cell is uncovered and covers a square of the current
    radius around them. Returns indices into ``keypoints``.
    """
    cols, rows = im_size
    n_kpts = len(keypoints)
    if n_kpts <= n_points:
        return np.arange(n_kpts)

    from pano360.native import ssc_select
    sel = ssc_select(keypoints, im_size, n_points, tol)
    if sel is not None:
        return sel

    # upper bound on the radius from the closed-form solution of
    # (rows+w)(cols+w) / (w/2)^2 = n_points
    exp1 = rows + cols + 2 * n_points
    exp2 = (4 * cols + 4 * n_points + 4 * rows * n_points + rows * rows
            + cols * cols - 2 * rows * cols + 4 * rows * cols * n_points)
    exp3 = math.sqrt(max(exp2, 0))
    exp4 = max(n_points - 1, 1)
    high = max(-round((exp1 + exp3) / exp4), -round((exp1 - exp3) / exp4))
    low = math.floor(math.sqrt(n_kpts / n_points))

    k_min = round(n_points - n_points * tol)
    k_max = round(n_points + n_points * tol)

    prev_width = -1
    result = np.arange(min(n_kpts, n_points))
    while True:
        width = low + (high - low) / 2
        if width == prev_width or low > high:
            break
        cgr = width / 2
        n_cc = int(cols / cgr)
        n_cr = int(rows / cgr)
        covered = np.zeros((n_cr + 1, n_cc + 1), bool)
        sel = []
        span = int(width / cgr)
        for i in range(n_kpts):
            row = int(keypoints[i, 1] / cgr)
            col = int(keypoints[i, 0] / cgr)
            if not covered[row, col]:
                sel.append(i)
                r0, r1 = max(row - span, 0), min(row + span, n_cr)
                c0, c1 = max(col - span, 0), min(col + span, n_cc)
                covered[r0:r1 + 1, c0:c1 + 1] = True
        if k_min <= len(sel) <= k_max:
            result = np.asarray(sel)
            break
        if len(sel) < k_min:
            high = width - 1
        else:
            low = width + 1
        prev_width = width
        result = np.asarray(sel)
    return np.asarray(result)


# ---------------------------------------------------------------------------
# Oriented patch descriptors
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap",))
def _msop_level(gray: jnp.ndarray, cap: int):
    """One pyramid level, device-fused: Harris + 3x3 maxima + top-``cap``
    candidates with their gradient orientations, plus the blurred map and
    the next level.

    Returns ``(score, rows, cols, theta, blurred, next_gray)`` with the
    candidate arrays (cap,) sorted by descending Harris response — the
    order SSC consumes. One host sync per level instead of full-map
    transfers + a python argsort.
    """
    h, w = gray.shape
    gx = gaussian_blur(sobel(gray, 1, 0), 1.0, feature_ksize(1.0))
    gy = gaussian_blur(sobel(gray, 0, 1), 1.0, feature_ksize(1.0))
    blurred = gaussian_blur(gray, 2.0, feature_ksize(2.0))
    hrs = harris_response(gray)
    locmax = max_pool3x3(hrs) == hrs

    score = jnp.where(locmax, hrs, -jnp.inf).reshape(-1)
    cap = min(cap, h * w)
    vals, idx = jax.lax.top_k(score, cap)
    rows = idx // w
    cols = idx % w
    theta = jnp.arctan2(gx.reshape(-1)[idx], gy.reshape(-1)[idx])
    return vals, rows, cols, theta, blurred, pyr_down(gray)


@jax.jit
def _oriented_descriptors(blurred: jnp.ndarray, rows: jnp.ndarray,
                          cols: jnp.ndarray, thetas: jnp.ndarray):
    """8x8 oriented patch descriptors for a batch of keypoints -> (N, 64).

    The reference (features.py:117-131) builds a 3x3 matrix per keypoint
    in a python loop and runs one cv2.warpPerspective per keypoint; here
    the warp's sampling positions are computed in closed form for ALL
    keypoints at once — patch pixel (u, v) samples the blurred image at
    ``center + R(theta)^T (u - 4, v - 4)`` — and fetched with a single
    batched bilinear gather.
    """
    h, w = blurred.shape
    g = jnp.arange(DSIZE, dtype=jnp.float32) - DSIZE / 2
    gu, gv = jnp.meshgrid(g, g, indexing="xy")            # (8, 8)
    sin = jnp.sin(thetas)[:, None, None]
    cos = jnp.cos(thetas)[:, None, None]
    # closed-form inverse of the reference's warp chain: with
    # T = rot_mat(theta, (r, c)) (features.py:102-106) and the +DSIZE/2
    # output shift, patch pixel (x, y) samples T @ (x - 4, y - 4, 1), i.e.
    # x_src = c + cos*u + sin*v, y_src = r - sin*u + cos*v
    sx = cols.astype(jnp.float32)[:, None, None] + cos * gu + sin * gv
    sy = rows.astype(jnp.float32)[:, None, None] - sin * gu + cos * gv

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 2)
    i00 = blurred[y0i, x0i]
    i01 = blurred[y0i, x0i + 1]
    i10 = blurred[y0i + 1, x0i]
    i11 = blurred[y0i + 1, x0i + 1]
    tile = ((i00 * (1 - fx) + i01 * fx) * (1 - fy)
            + (i10 * (1 - fx) + i11 * fx) * fy)
    tile = jnp.where(inb, tile, 0.0)                      # constant border

    desc = tile.reshape(tile.shape[0], -1)
    mean = jnp.mean(desc, axis=1, keepdims=True)
    std = jnp.std(desc, axis=1, keepdims=True)
    return (desc - mean) / (std + 1e-8)


@functools.partial(jax.jit, static_argnames=("cap",))
def _msop_level_batch(gray: jnp.ndarray, cap: int):
    """``_msop_level`` vmapped over a batch of same-shape images."""
    return jax.vmap(lambda g: _msop_level(g, cap))(gray)


@functools.partial(jax.jit, static_argnames=("w",))
def _pack_candidates(vals: jnp.ndarray, rows: jnp.ndarray,
                     cols: jnp.ndarray, w: int):
    """Candidate readback payload: flat codes (row*w+col, -1 when the
    top-k slot is unfilled) + per-image valid counts. One int32 array
    per level instead of four f32/int32 ones — the host only needs
    coordinates for SSC; scores are implicit in the top-k order and
    orientations stay on device for the descriptor gather."""
    finite = jnp.isfinite(vals)
    codes = jnp.where(finite, rows * w + cols, -1).astype(jnp.int32)
    return codes, jnp.sum(finite, axis=1).astype(jnp.int32)


@jax.jit
def _level_descriptors_device(blurred: jnp.ndarray, rows: jnp.ndarray,
                              cols: jnp.ndarray, theta: jnp.ndarray,
                              idx: jnp.ndarray, kcounts: jnp.ndarray,
                              scale: jnp.ndarray):
    """Gather the SSC-selected candidates ON DEVICE and compute their
    descriptors — the selected rows/cols/theta and the (n, cap, 64)
    descriptor block never leave the device."""
    r = jnp.take_along_axis(rows, idx, axis=1)
    c = jnp.take_along_axis(cols, idx, axis=1)
    t = jnp.take_along_axis(theta, idx, axis=1)
    desc = jax.vmap(_oriented_descriptors)(blurred, r, c, t)
    kp = jnp.stack([c.astype(jnp.float32) * scale,
                    r.astype(jnp.float32) * scale], axis=-1)
    valid = jnp.arange(idx.shape[1])[None, :] < kcounts[:, None]
    return kp, desc, valid


_oriented_descriptors_batch = jax.jit(jax.vmap(_oriented_descriptors))


@functools.lru_cache(maxsize=None)
def _msop_level_mesh_fn(mesh, cap: int):
    """``_msop_level_batch`` with the image axis sharded over the mesh
    (per-image programs are independent, so outputs shard too)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(gray):
        return jax.vmap(lambda g: _msop_level(g, cap))(gray)

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=P("data"),
        out_specs=(P("data"),) * 6, check_vma=False))


@functools.lru_cache(maxsize=None)
def _oriented_descriptors_mesh_fn(mesh):
    """Image-sharded ``_oriented_descriptors_batch``."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    return jax.jit(shard_map(
        jax.vmap(_oriented_descriptors), mesh=mesh,
        in_specs=(P("data"),) * 4, out_specs=P("data"),
        check_vma=False))


@jax.jit
def _msop_gray(stack_u8: jnp.ndarray) -> jnp.ndarray:
    """(N, H, W, 3) uint8 BGR -> (N, H, W) float gray in 0..255."""
    return bgr2gray(stack_u8.astype(jnp.float32))


def msop_extract_batch(imgs_bgr: Sequence[np.ndarray],
                       max_feat: Sequence[int] = MAX_FEAT, mesh=None):
    """Extract MSOP keypoints + descriptors for a same-shape image batch.

    Per-image host loops pay a device sync per image per level (the
    reference loops too, features.py:133-156), so N images x L levels of
    syncs would dominate the MSOP configs. Here every pyramid level runs ONE
    vmapped candidate dispatch and ONE vmapped descriptor dispatch for
    the whole batch; all four levels' candidate programs are enqueued
    back-to-back before the first host sync, so the device pipelines
    levels while the host runs SSC. Only SSC (sequential greedy
    suppression, C++-accelerated) touches the host.

    ``mesh``: optional ``jax.sharding.Mesh`` ("data" axis) — the
    candidate and descriptor dispatches shard over the image axis
    (padded by repeating the last image; per-image programs are
    independent so features are identical to the single-device path).

    Returns per-image ``(kpts (N_i, 2) float32 (x, y), desc (N_i, 64))``
    lists.
    """
    n = len(imgs_bgr)
    n_run = n
    stack = np.stack(imgs_bgr)
    if mesh is not None:
        nd = int(mesh.devices.size)
        n_run = -(-n // nd) * nd
        if n_run > n:
            stack = np.concatenate(
                [stack, stack[-1:].repeat(n_run - n, axis=0)])
    cur = _msop_gray(jnp.asarray(stack))
    # enqueue every level's candidate program before any host sync
    levels = []
    for maxf in max_feat:
        if mesh is not None:
            vals, rows, cols, theta, blurred, nxt = _msop_level_mesh_fn(
                mesh, maxf * 20)(cur)
        else:
            vals, rows, cols, theta, blurred, nxt = _msop_level_batch(
                cur, maxf * 20)
        levels.append((vals, rows, cols, theta, blurred, cur.shape[1:]))
        cur = nxt

    points = [[] for _ in range(n)]
    descs = [[] for _ in range(n)]
    for lvl, (maxf, (vals_d, rows_d, cols_d, theta_d, blurred, hw)) in \
            enumerate(zip(max_feat, levels)):
        h, w = hw
        vals = np.asarray(vals_d)
        rows_a, cols_a = np.asarray(rows_d), np.asarray(cols_d)
        theta_a = np.asarray(theta_d)
        sel_rows, sel_cols, sel_theta = [], [], []
        for i in range(n):
            valid = np.isfinite(vals[i])
            rows = rows_a[i][valid]
            cols = cols_a[i][valid]
            thetas = theta_a[i][valid]
            sel = ssc(np.stack([cols, rows], axis=1).astype(np.float32),
                      (w, h), maxf)
            sel_rows.append(rows[sel])
            sel_cols.append(cols[sel])
            sel_theta.append(thetas[sel])

        # one shared pow2 capacity for the whole batch: distinct counts
        # would recompile the descriptor program per image
        top = max((len(r) for r in sel_rows), default=0)
        if top == 0:
            continue
        cap = max(64, 1 << (top - 1).bit_length())
        rows_b = np.zeros((n_run, cap), rows_a.dtype)
        cols_b = np.zeros((n_run, cap), cols_a.dtype)
        theta_b = np.zeros((n_run, cap), np.float32)
        for i in range(n):
            k = len(sel_rows[i])
            rows_b[i, :k] = sel_rows[i]
            cols_b[i, :k] = sel_cols[i]
            theta_b[i, :k] = sel_theta[i]
        desc_fn = (_oriented_descriptors_batch if mesh is None
                   else _oriented_descriptors_mesh_fn(mesh))
        desc = np.asarray(desc_fn(
            blurred, jnp.asarray(rows_b), jnp.asarray(cols_b),
            jnp.asarray(theta_b)))
        scale = 2.0 ** lvl
        for i in range(n):
            k = len(sel_rows[i])
            if k:
                descs[i].append(desc[i, :k])
                points[i].append(np.stack(
                    [sel_cols[i] * scale, sel_rows[i] * scale],
                    axis=1).astype(np.float32))

    out = []
    for i in range(n):
        if points[i]:
            out.append((np.concatenate(points[i]),
                        np.concatenate(descs[i])))
        else:
            out.append((np.zeros((0, 2), np.float32),
                        np.zeros((0, 64), np.float32)))
    return out


def msop_extract_device(imgs_bgr: Sequence[np.ndarray],
                        max_feat: Sequence[int] = MAX_FEAT):
    """Device-resident MSOP extraction for the matching fast path.

    ``msop_extract_batch`` pays two host round trips the matcher does
    not need: the (n, cap)-sized candidate readback (4 arrays x 4
    levels = 16 sequential pulls) and the descriptor pull, which
    ``pipeline.matching`` immediately re-uploads
    (benchmarks/profile_msop.py times both paths). Here the candidate
    readback is ONE
    packed int32 pull (flat codes + per-image counts; orientations stay
    on device), SSC runs on the host coordinates as before
    (features.py:28-99 semantics), and the selected candidates are
    gathered + described on device, so keypoint/descriptor buffers are
    returned device-resident in the level-major order the host keypoint
    list uses.

    Returns ``(kpts_host, kp_dev (n, C, 2), ds_dev (n, C, 64),
    va_dev (n, C), counts (n,) int32)`` where ``kpts_host`` is the
    per-image full-res (x, y) float32 list (level-major, SSC order —
    the same order the device buffers hold their valid rows in, so
    match indices index it directly after valid-first compaction).
    """
    n = len(imgs_bgr)
    cur = _msop_gray(jnp.asarray(np.stack(imgs_bgr)))
    levels, packs, counts_l = [], [], []
    for maxf in max_feat:
        vals, rows, cols, theta, blurred, nxt = _msop_level_batch(
            cur, maxf * 20)
        codes, cnt = _pack_candidates(vals, rows, cols, w=cur.shape[2])
        levels.append((rows, cols, theta, blurred, cur.shape[1:]))
        packs.append(codes)
        counts_l.append(cnt)
        cur = nxt
    # ONE pull for every level's codes AND counts: one host sync instead
    # of one per array
    packed = np.asarray(jnp.concatenate(
        packs + [jnp.stack(counts_l, axis=1)], axis=1))
    counts_np = packed[:, -len(max_feat):]

    kp_parts, ds_parts, va_parts = [], [], []
    kpts_host = [[] for _ in range(n)]
    total = np.zeros(n, np.int32)
    off = 0
    for lvl, (maxf, (rows_d, cols_d, theta_d, blurred, hw)) in \
            enumerate(zip(max_feat, levels)):
        h, w = hw
        cap_l = packs[lvl].shape[1]
        codes = packed[:, off:off + cap_l]
        off += cap_l
        scale = 2.0 ** lvl
        sels = []
        for i in range(n):
            k = int(counts_np[i, lvl])
            cs = codes[i, :k]
            cc = (cs % w).astype(np.float32)
            rr = (cs // w).astype(np.float32)
            sel = ssc(np.stack([cc, rr], axis=1), (w, h), maxf)
            sels.append(np.asarray(sel, np.int32))
            kpts_host[i].append(np.stack(
                [cc[sel] * scale, rr[sel] * scale], axis=1
            ).astype(np.float32))
        top = max((len(s) for s in sels), default=0)
        if top == 0:
            continue
        capd = max(64, 1 << (top - 1).bit_length())
        idx_b = np.zeros((n, capd), np.int32)
        kcnt = np.zeros(n, np.int32)
        for i in range(n):
            idx_b[i, :len(sels[i])] = sels[i]
            kcnt[i] = len(sels[i])
        kp, desc, valid = _level_descriptors_device(
            blurred, rows_d, cols_d, theta_d, jnp.asarray(idx_b),
            jnp.asarray(kcnt), jnp.float32(scale))
        kp_parts.append(kp)
        ds_parts.append(desc)
        va_parts.append(valid)
        total += kcnt

    kpts_out = [np.concatenate(kpts_host[i]) if kpts_host[i]
                else np.zeros((0, 2), np.float32) for i in range(n)]
    if not kp_parts:
        z = jnp.zeros((n, 64, 2), jnp.float32)
        return (kpts_out, z, jnp.zeros((n, 64, 64), jnp.float32),
                jnp.zeros((n, 64), bool), total)
    return (kpts_out,
            jnp.concatenate(kp_parts, axis=1),
            jnp.concatenate(ds_parts, axis=1),
            jnp.concatenate(va_parts, axis=1), total)


def msop_extract_host(img_bgr: np.ndarray,
                      max_feat: Sequence[int] = MAX_FEAT):
    """Extract MSOP keypoints + 64-d descriptors for one image.

    Returns ``(kpts (N, 2) float32 full-res (x, y), desc (N, 64))``.
    Single-image wrapper over ``msop_extract_batch``.
    """
    return msop_extract_batch([img_bgr], max_feat)[0]


__all__ = ["DSIZE", "MAX_FEAT", "ssc", "msop_extract_host",
           "msop_extract_batch", "msop_extract_device"]
