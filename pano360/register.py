"""Panorama registration: traverse + incremental LM bundle adjustment.

Batched device re-design of the reference's ``bundle_adj.py:288-395``:

- the *graph* logic (best-first heap walk over the match graph, camera
  seeding, edge gating) stays on the host — it is tiny, data-dependent
  control flow (SURVEY.md §7 hard part #6);
- the *numerics* (residuals, Jacobians, J^T J / J^T r accumulation) run as
  one jitted, vmapped device program per LM iteration. Jacobian blocks come
  from forward-mode AD of the per-point residual (replacing the reference's
  ~100-line hand-derived ``_jacobian_symbolic``, bundle_adj.py:186-258),
  which is exact, and batched over all match points at once;
- problem sizes are padded to power-of-two buckets (cameras, edges, matches
  per edge) so incremental BA triggers only O(log N) recompiles
  (SURVEY.md §7 hard part #5). Inactive padding cameras are held fixed by
  the LM damping term.

The LM schedule matches the reference exactly: fixed lambda=5, at most 100
iterations, accept a step only if the RMSE improves by 1e-3, stop after 5
consecutive non-improvements (bundle_adj.py:311-345); edges whose initial
RMSE exceeds 150 are rejected as mismatches (bundle_adj.py:15,304).
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pano360 import geometry as geo

# bundle adjustment parameters (bundle_adj.py:8-15)
PARAMS_PER_CAMERA = 6
LM_LAMBDA = 5.0
LM_MAX_ITER = 100
LM_MIN_IMPROVE = 1e-3
LM_MAX_STALLS = 5
MIN_MATCH_ERROR = 150.0

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class PanoImage:
    """Host-side registered image (mirrors the reference's ``Image``
    dataclass, bundle_adj.py:18-33, for cache-structure parity)."""

    img: Optional[np.ndarray]
    rot: np.ndarray
    intr: np.ndarray
    range: tuple = (np.zeros(2), np.zeros(2))

    def hom(self) -> np.ndarray:
        """Pixel -> world-ray homography R^T K^-1."""
        return self.rot.T.dot(np.linalg.inv(self.intr))

    def proj(self) -> np.ndarray:
        """World-ray -> pixel projection K R."""
        return self.intr.dot(self.rot)


def _np_log_so3(rot: np.ndarray) -> np.ndarray:
    """Host Rodrigues log (f64): a device call per camera would cost a
    dispatch and a host sync each inside incremental BA."""
    rad = np.array([rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0],
                    rot[1, 0] - rot[0, 1]])
    mod = np.linalg.norm(rad)
    if mod < 1e-7:
        return np.zeros(3)
    theta = np.arccos(np.clip((np.trace(rot) - 1) / 2, -1, 1))
    return rad * (theta / mod)


def _np_exp_so3(rad: np.ndarray) -> np.ndarray:
    """Host Rodrigues exp (f64)."""
    ang = np.linalg.norm(rad)
    if ang < 1e-12:
        return np.eye(3)
    x, y, z = rad / ang
    cross = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + np.sin(ang) * cross + (1 - np.cos(ang)) * cross @ cross


def _np_params_from_camera(cam: PanoImage) -> np.ndarray:
    intr = cam.intr
    lead = np.array([intr[0, 0], intr[0, 2], intr[1, 2]])
    return np.concatenate([lead, _np_log_so3(cam.rot)])


def _np_camera_from_params(p: np.ndarray) -> PanoImage:
    rot = _np_exp_so3(p[3:6])
    intr = np.array([[p[0], 0, p[1]], [0, p[0], p[2]], [0, 0, 1.0]])
    return PanoImage(None, rot, intr)


def _edge_rmse(cam1: PanoImage, cam2: PanoImage, match: np.ndarray) -> float:
    """Initial RMSE of an edge (host, f64) for the mismatch gate."""
    hom = cam1.intr @ cam1.rot @ cam2.rot.T @ np.linalg.inv(cam2.intr)
    tr = match[:, 3:6] @ hom.T
    res = match[:, :2] - tr[:, :2] / tr[:, 2:3]
    return float(np.sqrt(np.mean(np.square(res))))


# ---------------------------------------------------------------------------
# Device LM kernel
# ---------------------------------------------------------------------------

def _psum(x, axis_name):
    """psum over the mesh axis when running SPMD (edge-sharded), no-op
    single-device. All LM reductions route through this so the same kernel
    serves both the single-chip and the ``shard_map`` production paths."""
    return jax.lax.psum(x, axis_name) if axis_name else x


# Deterministic two-stage reduction: the edge axis is always reduced as
# EDGE_GROUPS ordered partial sums (see _group_reduce). Meshes of any
# device count work: the group axis is padded to the next multiple of
# the device count with all-masked groups (see incremental_register).
EDGE_GROUPS = 16


def _group_reduce(parts, axis_name):
    """Ordered hierarchical sum of per-group partial LM stats.

    ``parts``: pytree of ``(g, ...)`` per-group partials — ``g ==
    EDGE_GROUPS`` single-device, ``EDGE_GROUPS/n_devices`` per device
    under ``shard_map`` (contiguous groups, matching the P("data") shard
    order). The mesh path all-gathers the partials (deterministic,
    device-ordered) so every device — and the single-device program —
    performs THE SAME ordered (EDGE_GROUPS, ...) -> (...) sum.

    This replaces ``psum`` for the bundle adjuster: psum's cross-device
    reduction order is unspecified, and the f32 rounding difference,
    amplified through the LM accept/reject trajectory, left the mesh and
    single-chip runs at measurably different optima (~1.5e-4 relative
    focal ==> ~48 dB mosaic disagreement at dryrun scale). The ordered
    reduction removes that order; the per-group partials still come from
    programs of other shapes (16 groups in one program vs 16/n per
    device), so the two paths agree closely but not bit for bit
    (test_parallel's bars: rotations 5e-5, focal 1e-4).

    The sum is an EXPLICIT left fold (not ``jnp.sum``, whose reduction
    tree is the compiler's choice and may differ between programs with
    different group counts): device counts that do not divide
    EDGE_GROUPS pad with trailing all-zero groups (see ``traverse``),
    and a left fold makes appending zeros a bit-exact no-op, so the
    padding adds no rounding of its own."""
    if axis_name:
        gather = functools.partial(jax.lax.all_gather,
                                   axis_name=axis_name, tiled=True)
        parts = jax.tree_util.tree_map(gather, parts)
    leaves, treedef = jax.tree_util.tree_flatten(parts)
    g = leaves[0].shape[0]
    if g == 1:
        return jax.tree_util.tree_unflatten(treedef,
                                            [lf[0] for lf in leaves])

    def body(i, accs):
        return tuple(a + lf[i] for a, lf in zip(accs, leaves))

    accs = jax.lax.fori_loop(1, g, body, tuple(lf[0] for lf in leaves))
    return jax.tree_util.tree_unflatten(treedef, list(accs))


def _grouped(body, cam1_idx, cam2_idx, pts, mask, gsize):
    """vmap ``body`` over contiguous edge groups of static size ``gsize``."""
    g = cam1_idx.shape[0] // gsize
    return jax.vmap(body)(cam1_idx.reshape(g, gsize),
                          cam2_idx.reshape(g, gsize),
                          pts.reshape((g, gsize) + pts.shape[1:]),
                          mask.reshape((g, gsize) + mask.shape[1:]))


def _point_residual(pa: jnp.ndarray, pb: jnp.ndarray, pt: jnp.ndarray):
    """Residual of one match point w.r.t. the two cameras' 6-params.

    ``pa``: params of the camera whose pixels are pt[:3] (edge cam1);
    ``pb``: params of the camera whose pixels are pt[3:6] (edge cam2).
    Matches ``get_diff`` (bundle_adj.py:145-149).
    """
    ca = geo.params_to_camera(pa)
    cb = geo.params_to_camera(pb)
    hom = geo.hom_to_from(ca, cb)
    # pinned precision: the bf16 matmul default adds ~px-scale noise to
    # every residual at +-500px coordinates
    tr = jnp.matmul(hom, pt[3:6], precision=geo.PRECISION)
    # guarded divide: padded match rows would otherwise produce 0/0 NaNs
    # that survive multiplication by the mask
    z = jnp.where(jnp.abs(tr[2]) > 1e-12, tr[2], 1.0)
    return pt[:2] - tr[:2] / z


_point_jac = jax.jacfwd(_point_residual, argnums=(0, 1))


def _lm_stats_local(params, cam1_idx, cam2_idx, pts, mask, axis_name=None,
                    gsize=None):
    """One LM linearization: loss stats + normal equations.

    params: (C, 6); cam1_idx/cam2_idx: (E,) int32; pts: (E, M, 6);
    mask: (E, M) float. Returns (sq_sum, n_terms, jtj (6C, 6C), jtr (6C,)).
    ``gsize`` (static): edges per reduction group — the edge axis is
    reduced as ordered per-group partial sums (``_group_reduce``) so the
    mesh-sharded and single-device programs accumulate in the same order.
    With ``axis_name`` the edge inputs are a ``shard_map`` shard and the
    partials are all-gathered over the mesh before the ordered sum
    (distributed Gauss-Newton across the mesh).
    """
    c = params.shape[0]

    def body(c1, c2, ptsg, maskg):
        pa = params[c1]                             # (e, 6)
        pb = params[c2]
        res = jax.vmap(jax.vmap(_point_residual, in_axes=(None, None, 0)),
                       in_axes=(0, 0, 0))(pa, pb, ptsg)      # (e, M, 2)
        ja, jb = jax.vmap(jax.vmap(_point_jac, in_axes=(None, None, 0)),
                          in_axes=(0, 0, 0))(pa, pb, ptsg)   # (e, M, 2, 6)

        res = res * maskg[..., None]
        ja = ja * maskg[..., None, None]
        jb = jb * maskg[..., None, None]

        sq_sum = jnp.sum(res * res)
        n_terms = 2.0 * jnp.sum(maskg)

        prec = jax.lax.Precision.HIGHEST
        jaa = jnp.einsum("emri,emrj->eij", ja, ja, precision=prec)
        jbb = jnp.einsum("emri,emrj->eij", jb, jb, precision=prec)
        jab = jnp.einsum("emri,emrj->eij", ja, jb, precision=prec)
        ra = jnp.einsum("emri,emr->ei", ja, res, precision=prec)   # (e, 6)
        rb = jnp.einsum("emri,emr->ei", jb, res, precision=prec)

        jtj = jnp.zeros((c, c, 6, 6), params.dtype)
        jtj = jtj.at[c1, c1].add(jaa)
        jtj = jtj.at[c2, c2].add(jbb)
        jtj = jtj.at[c1, c2].add(jab)
        jtj = jtj.at[c2, c1].add(jnp.swapaxes(jab, -1, -2))
        jtj = jnp.transpose(jtj, (0, 2, 1, 3)).reshape(6 * c, 6 * c)

        jtr = jnp.zeros((c, 6), params.dtype)
        jtr = jtr.at[c1].add(ra)
        jtr = jtr.at[c2].add(rb)
        return sq_sum, n_terms, jtj, jtr.reshape(-1)

    e = cam1_idx.shape[0]
    if gsize is None or gsize >= e:
        gsize = e                  # one group (exact legacy reduction)
    parts = _grouped(body, cam1_idx, cam2_idx, pts, mask, gsize)
    return _group_reduce(parts, axis_name)


_lm_stats = functools.partial(
    jax.jit, static_argnames=("axis_name", "gsize"))(_lm_stats_local)


def _loss_stats_local(params, cam1_idx, cam2_idx, pts, mask, axis_name=None,
                      gsize=None):
    def body(c1, c2, ptsg, maskg):
        pa = params[c1]
        pb = params[c2]
        res = jax.vmap(jax.vmap(_point_residual, in_axes=(None, None, 0)),
                       in_axes=(0, 0, 0))(pa, pb, ptsg)
        res = res * maskg[..., None]
        return jnp.sum(res * res), 2.0 * jnp.sum(maskg)

    e = cam1_idx.shape[0]
    if gsize is None or gsize >= e:
        gsize = e
    parts = _grouped(body, cam1_idx, cam2_idx, pts, mask, gsize)
    return _group_reduce(parts, axis_name)


_loss_stats = functools.partial(
    jax.jit, static_argnames=("axis_name", "gsize"))(_loss_stats_local)


def _lm_core(params0, cam1_idx, cam2_idx, pts, mask,
             max_iter: int = LM_MAX_ITER, axis_name=None, gsize=None):
    """Full LM loop fused on device (traceable; see ``_lm_optimize``).

    The host-loop variant pays a device round-trip per iteration — with
    incremental BA that is thousands of dispatches and host syncs per
    panorama. The solve runs in f32
    with Jacobi (diagonal) preconditioning, which keeps the damped normal
    equations well-conditioned despite focal-scale entries (~1e9).

    Schedule identical to the reference (bundle_adj.py:311-345): fixed
    lambda, accept-if-improves-by-1e-3, stop after 5 stalls or max_iter.
    Returns (best_params, best_err).
    """
    nc6 = params0.shape[0] * 6

    def loss_of(p):
        sq, n = _loss_stats_local(p, cam1_idx, cam2_idx, pts, mask,
                                  axis_name, gsize)
        return jnp.sqrt(sq / jnp.maximum(n, 1.0))

    def cond(state):
        it, stalls, *_ = state
        # With fixed lambda and rollback-on-reject, the state after a
        # rejection is frozen: the next linearization (at the rolled-back
        # point) reproduces the same step and the same rejection, so the
        # reference's 5 further stall iterations (bundle_adj.py:341-343)
        # are identical no-ops. Exiting at the first rejection returns
        # bit-identical (best, best_err) while skipping ~6 wasted
        # iterations per optimize().
        return (it < max_iter) & (stalls < 1)

    def body(state):
        it, stalls, cur, best, best_err = state
        sq, n, jtj, jtr = _lm_stats_local(cur, cam1_idx, cam2_idx, pts,
                                          mask, axis_name, gsize)
        jtj = jtj + LM_LAMBDA * jnp.eye(nc6, dtype=jtj.dtype)
        d = jax.lax.rsqrt(jnp.diagonal(jtj) + 1e-12)
        a = jtj * d[:, None] * d[None, :]
        b = jtr * d
        delta = (jnp.linalg.solve(a, b) * d).reshape(cur.shape)
        trial = cur - delta
        err = loss_of(trial)
        improved = err < best_err - LM_MIN_IMPROVE
        best = jnp.where(improved, trial, best)
        best_err = jnp.where(improved, err, best_err)
        # cumulative (non-resetting) stall count, like the reference's
        # n_not_improved (bundle_adj.py:341-343): exit after 6 total misses
        stalls = stalls + jnp.where(improved, 0, 1)
        # reject -> roll back to the last accepted point and re-linearize
        # there (bundle_adj.py:330-343); with fixed lambda the rejected
        # step then repeats until the stall budget runs out, exactly as in
        # the reference
        cur = jnp.where(improved, trial, best)
        return it + 1, stalls, cur, best, best_err

    err0 = loss_of(params0)
    state = (jnp.int32(0), jnp.int32(0), params0, params0, err0)
    _, _, _, best, best_err = jax.lax.while_loop(cond, body, state)
    return best, best_err, err0


_lm_optimize = functools.partial(
    jax.jit, static_argnames=("max_iter", "axis_name", "gsize"))(_lm_core)


def _lm_polish(params0, cam1_idx, cam2_idx, pts, mask, max_iter: int = 150,
               axis_name=None, gsize=None):
    """Adaptive-damping LM polish past the reference's fixed-lambda stop.

    The reference's schedule (lambda=5 fixed, stop when a step improves by
    <1e-3) leaves the solution measurably short of the optimum of its own
    objective: at benchmark scale the reference's cameras fit OUR match
    set better than our fixed-lambda result did (RMSE 0.3186 vs 0.3195),
    because near convergence the over-damped steps' improvements collapse
    below the threshold while real residual remains. A classic
    lambda-adaptive phase (halve on accept, 4x on reject, stop after 12
    consecutive rejects) converges the rest of the way — measured: focal
    error +0.072% -> +0.005%, mean relative-rotation error 0.055 deg ->
    0.032 deg vs ground truth, matching the CPU reference's registration
    accuracy. Runs once on the final problem, inside the same dispatch.
    The long reject budget and the 1e-5 lambda floor push to the
    f32 stationary point. (Mesh/single-device agreement does NOT rely on
    this: it comes from the ordered ``_group_reduce`` accumulation.)
    """
    nc6 = params0.shape[0] * 6

    def loss_of(p):
        sq, n = _loss_stats_local(p, cam1_idx, cam2_idx, pts, mask,
                                  axis_name, gsize)
        return jnp.sqrt(sq / jnp.maximum(n, 1.0))

    def cond(state):
        it, rejects, *_ = state
        return (it < max_iter) & (rejects < 12)

    def body(state):
        it, rejects, lam, cur, best, best_err = state
        _, _, jtj, jtr = _lm_stats_local(cur, cam1_idx, cam2_idx, pts,
                                         mask, axis_name, gsize)
        a = jtj + lam * jnp.eye(nc6, dtype=jtj.dtype)
        d = jax.lax.rsqrt(jnp.diagonal(a) + 1e-12)
        delta = (jnp.linalg.solve(a * d[:, None] * d[None, :], jtr * d)
                 * d).reshape(cur.shape)
        trial = cur - delta
        err = loss_of(trial)
        improved = err < best_err
        best = jnp.where(improved, trial, best)
        best_err = jnp.where(improved, err, best_err)
        lam = jnp.clip(jnp.where(improved, lam * 0.5, lam * 4.0),
                       1e-5, 1e6)
        rejects = jnp.where(improved, 0, rejects + 1)
        return it + 1, rejects, lam, best, best, best_err

    err0 = loss_of(params0)
    state = (jnp.int32(0), jnp.int32(0), jnp.float32(LM_LAMBDA),
             params0, params0, err0)
    _, _, _, _, best, _ = jax.lax.while_loop(cond, body, state)
    return best


def _traverse_impl(params0, seed_idx, place_dst, place_src, homs,
                   homs_all, placed_idx, cam1_idx, cam2_idx, pts, mask,
                   edge_add, mode: str, use_straighten: bool = True,
                   max_iter: int = LM_MAX_ITER, polish: bool = True,
                   axis_name=None, gsize=None):
    """The ENTIRE incremental registration schedule in one dispatch.

    The reference's traverse (bundle_adj.py:348-395) interleaves host graph
    logic with numeric work per added camera; run that way each per-add
    ``optimize()`` costs a dispatch and a host sync while its device
    compute is tiny, so registration is latency-bound. The *order* of
    adds is fixed by the match scores alone (host-computable upfront), so
    everything value-dependent — seeding the new camera's rotation from the
    pair homography, gating its edges by initial RMSE (<150,
    bundle_adj.py:15,304), and the per-add LM optimize — runs as one
    ``lax.scan`` over the precomputed schedule.

    params0: (C, 6) with the seed camera's rotation row zeroed (its
    focal triple is overwritten here); place_dst/place_src: (A,) int32
    camera indices per add; homs: (A, 3, 3) pair homographies (src <-
    dst pixels); homs_all: (P, 3, 3) every pair homography — the shared
    K is the median Szeliski-Shum focal over them (bundle_adj.py:354),
    computed on-device so traverse pays no extra round trip;
    placed_idx: indices of the cameras the walk places (host-known),
    used for the final straightening (bundle_adj.py:390-393). Edge
    tensors as in ``_lm_stats``; ``edge_add[e]`` = the add index that
    gates edge e. No-op padding adds must route place_dst/place_src to
    a scratch camera row. Returns (params, enabled, focal).

    ``polish=False`` stops exactly where the reference's fixed-lambda
    schedule stops (bundle_adj.py:311-345) — the trajectory-parity mode;
    the default continues with ``_lm_polish``. With ``axis_name`` the
    edge-dimension inputs are shards of a ``shard_map`` over the mesh;
    per-edge state (gating, masks) stays local to its shard and every
    loss/normal-equation reduction all-gathers ordered per-group
    partials (``_group_reduce``, ``gsize`` edges per group) so the SPMD
    trajectory follows the single-device one closely (not bit for bit).
    """
    focal = _median_focal(homs_all)
    intr = geo.intrinsics(focal).astype(params0.dtype)
    kinv = geo.inv3x3(intr)
    lead = jnp.stack([intr[0, 0], intr[0, 2], intr[1, 2]]
                     ).astype(params0.dtype)
    # seed camera: identity rotation with the shared focal
    params0 = params0.at[seed_idx, :3].set(lead)

    def edge_rmse(params):
        pa = params[cam1_idx]
        pb = params[cam2_idx]
        res = jax.vmap(jax.vmap(_point_residual, in_axes=(None, None, 0)),
                       in_axes=(0, 0, 0))(pa, pb, pts)
        res = res * mask[..., None]
        sq = jnp.sum(res * res, axis=(1, 2))
        n = 2.0 * jnp.sum(mask, axis=1)
        return jnp.sqrt(sq / jnp.maximum(n, 1.0))

    def add_step(carry, xs):
        params, enabled = carry
        k, dst, src, hom = xs
        # seed: rot = to_rotation(K^-1 H K) @ rot_src (bundle_adj.py:370-372)
        # (geo.mm pins full f32 matmul precision: a reduced-precision
        # product corrupts the conjugation by ~1 degree at focal-scale K
        # entries)
        r_src = geo.exp_so3(params[src, 3:6])
        r_rel = geo.nearest_rotation(geo.mm(geo.mm(kinv, hom), intr))
        newp = jnp.concatenate([lead, geo.log_so3(geo.mm(r_rel, r_src))])
        params = params.at[dst].set(newp)
        # gate this add's edges by initial RMSE against current cameras
        rmse = edge_rmse(params)
        enabled = enabled | ((edge_add == k) & (rmse < MIN_MATCH_ERROR))
        if mode == "incr":
            params, _, _ = _lm_core(params, cam1_idx, cam2_idx, pts,
                                    mask * enabled[:, None], max_iter,
                                    axis_name, gsize)
        return (params, enabled), None

    a = place_dst.shape[0]
    enabled0 = jnp.zeros(edge_add.shape, bool)
    xs = (jnp.arange(a, dtype=edge_add.dtype), place_dst, place_src, homs)
    (params, enabled), _ = jax.lax.scan(add_step, (params0, enabled0), xs)
    if mode == "last":
        params, _, _ = _lm_core(params, cam1_idx, cam2_idx, pts,
                                mask * enabled[:, None], max_iter,
                                axis_name, gsize)
    if polish and mode != "none":
        # converge past the reference's fixed-lambda stopping point
        params = _lm_polish(params, cam1_idx, cam2_idx, pts,
                            mask * enabled[:, None], axis_name=axis_name,
                            gsize=gsize)
    if use_straighten:
        rots = geo.exp_so3(params[placed_idx, 3:6])
        rads = geo.log_so3(geo.straighten(rots))
        params = params.at[placed_idx, 3:6].set(rads.astype(params.dtype))
    return params, enabled, focal


_traverse_kernel = functools.partial(
    jax.jit, static_argnames=("mode", "use_straighten", "max_iter",
                              "polish", "axis_name", "gsize"))(_traverse_impl)


@functools.lru_cache(maxsize=None)
def _traverse_mesh_fn(mesh, mode: str, use_straighten: bool,
                      max_iter: int, polish: bool, gsize: int):
    """shard_map'd traverse kernel: edge tensors sharded over the mesh's
    data axis, everything else replicated. The SAME ``_traverse_impl``
    runs SPMD — per-edge gating stays shard-local; LM reductions
    all-gather ordered per-group partials (``_group_reduce``), which
    keeps the mesh trajectory close to the single-device one."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    fn = functools.partial(_traverse_impl, mode=mode,
                           use_straighten=use_straighten,
                           max_iter=max_iter, polish=polish,
                           axis_name="data", gsize=gsize)
    rep, sh = P(), P("data")
    sm = shard_map(fn, mesh=mesh,
                   in_specs=(rep, rep, rep, rep, rep, rep, rep,
                             sh, sh, sh, sh, sh),
                   out_specs=(rep, sh, rep), check_vma=False)
    return jax.jit(sm)


def _median_focal(homs_all: jnp.ndarray) -> jnp.ndarray:
    """Median Szeliski-Shum focal over all pair homographies
    (bundle_adj.py:354)."""
    return jnp.median(geo.focal_from_hom(homs_all))


def _next_pow2(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _write_edges(pts_buf, mask_buf, new_pts, new_mask, e0):
    """Append edge rows into the device-resident problem buffers."""
    pts_buf = jax.lax.dynamic_update_slice(pts_buf, new_pts, (e0, 0, 0))
    mask_buf = jax.lax.dynamic_update_slice(mask_buf, new_mask, (e0, 0))
    return pts_buf, mask_buf


class BundleAdjuster:
    """Incremental bundle adjustment (IncrementalBundleAdjuster parity).

    The match-point tensors live on device and are appended to as cameras
    arrive, so each ``optimize()`` is one dispatch with kilobyte-scale
    transfers (params/indices up, solution down) instead of re-uploading
    the whole problem. ``edge_cap``/``match_cap`` hints fix the padded
    problem shape up front (one XLA compile for the whole incremental
    schedule); without hints the buffers grow by doubling.
    """

    def __init__(self, n_cameras: int, mode: str = "incr",
                 dtype=np.float32, edge_cap: Optional[int] = None,
                 match_cap: Optional[int] = None):
        self.cameras: List[Optional[PanoImage]] = [None] * n_cameras
        self.matches: List[Tuple[int, int, np.ndarray]] = []
        self.mode = mode
        self.dtype = dtype
        self._cp = _next_pow2(n_cameras, 4)
        self._ep = _next_pow2(edge_cap, 4) if edge_cap else 4
        self._mp = _next_pow2(match_cap, 64) if match_cap else 64
        self._pts = None        # device (EP, MP, 6)
        self._mask = None       # device (EP, MP)
        self._n_dev = 0         # edges uploaded so far

    def add(self, idx: int, camera: PanoImage, matches: Dict) -> None:
        """Add a camera and its valid edges (bundle_adj.py:297-309)."""
        self.cameras[idx] = camera
        for new, cam in enumerate(self.cameras):
            if cam is None or new not in matches[idx]:
                continue
            match = matches[idx][new][0]
            if _edge_rmse(camera, cam, match) > MIN_MATCH_ERROR:
                continue
            self.matches.append((new, idx, match))

        if self.mode == "incr":
            self.optimize()

    # -- device-resident problem buffers --------------------------------

    def _benign_rows(self, k: int) -> np.ndarray:
        rows = np.zeros((k, self._mp, 6), self.dtype)
        rows[..., 2] = 1.0   # benign homogeneous padding (no 0/0 under AD)
        rows[..., 5] = 1.0
        return rows

    def _sync_device(self) -> None:
        """Upload edges added since the last sync (grow buffers if needed)."""
        need_mp = max((len(m) for _, _, m in self.matches), default=1)
        grow = need_mp > self._mp
        while self._mp < need_mp:
            self._mp *= 2
        while self._ep < len(self.matches):
            self._ep *= 2
            grow = True
        if self._pts is None or grow or self._pts.shape[0] != self._ep:
            self._pts = None    # full rebuild at the new capacity
            self._n_dev = 0

        if self._pts is None:
            self._pts = jnp.asarray(self._benign_rows(self._ep))
            self._mask = jnp.zeros((self._ep, self._mp), self.dtype)

        new = self.matches[self._n_dev:]
        if not new:
            return
        rows = self._benign_rows(len(new))
        mrows = np.zeros((len(new), self._mp), self.dtype)
        for e, (_, _, m) in enumerate(new):
            rows[e, : len(m)] = m
            mrows[e, : len(m)] = 1.0
        self._pts, self._mask = _write_edges(
            self._pts, self._mask, jnp.asarray(rows), jnp.asarray(mrows),
            self._n_dev)
        self._n_dev = len(self.matches)

    # -- padded problem assembly --------------------------------------

    def _assemble(self):
        idx = [i for i, c in enumerate(self.cameras) if c is not None]
        pos = {c: k for k, c in enumerate(idx)}
        cp = _next_pow2(len(idx), 4)
        ep = _next_pow2(max(len(self.matches), 1), 4)
        mp = _next_pow2(max((len(m) for _, _, m in self.matches),
                            default=1), 64)

        params = np.zeros((cp, 6), self.dtype)
        params[:, 0] = 1.0  # benign focal for padding cameras
        for k, i in enumerate(idx):
            params[k] = _np_params_from_camera(self.cameras[i])

        cam1 = np.zeros(ep, np.int32)
        cam2 = np.zeros(ep, np.int32)
        pts = np.zeros((ep, mp, 6), self.dtype)
        pts[..., 2] = 1.0   # benign homogeneous padding (no 0/0 under AD)
        pts[..., 5] = 1.0
        mask = np.zeros((ep, mp), self.dtype)
        for e, (i_new, j_idx, m) in enumerate(self.matches):
            cam1[e] = pos[j_idx]   # get_diff(cameras[j], cameras[i], m)
            cam2[e] = pos[i_new]
            pts[e, : len(m)] = m
            mask[e, : len(m)] = 1.0
        return idx, params, cam1, cam2, pts, mask

    # -- optimization --------------------------------------------------

    def optimize(self) -> None:
        if not self.matches:
            return
        self._sync_device()
        idx = [i for i, c in enumerate(self.cameras) if c is not None]
        LOG.debug("Optimizing %d cameras", len(idx))

        params = np.zeros((self._cp, 6), self.dtype)
        params[:, 0] = 1.0  # benign focal for unplaced cameras
        for i in idx:
            params[i] = _np_params_from_camera(self.cameras[i])
        cam1 = np.zeros(self._ep, np.int32)
        cam2 = np.zeros(self._ep, np.int32)
        for e, (i_new, j_idx, _) in enumerate(self.matches):
            cam1[e] = j_idx    # get_diff(cameras[j], cameras[i], m)
            cam2[e] = i_new

        best, best_err, err0 = _lm_optimize(
            jnp.asarray(params), jnp.asarray(cam1), jnp.asarray(cam2),
            self._pts, self._mask)
        best = np.asarray(best, np.float64)
        if LOG.isEnabledFor(logging.DEBUG):   # float() forces a transfer
            LOG.debug("Initial error: %s", float(err0))
            LOG.debug("Final error: %s", float(best_err))

        for i in idx:
            cam = _np_camera_from_params(best[i])
            cam.img = self.cameras[i].img
            self.cameras[i] = cam


def jacobian_numeric(params: np.ndarray, cam1_idx, cam2_idx, pts, mask,
                     step: float = 1e-6):
    """Finite-difference Jacobian check (bundle_adj.py:261-285 equivalent).

    Debug utility: returns (J^T J, J^T r) via symmetric differences of the
    device residuals, for validating the AD path on small problems.
    """
    params = np.asarray(params, np.float64)

    def res_vec(p):
        pa = p[np.asarray(cam1_idx)]
        pb = p[np.asarray(cam2_idx)]
        out = jax.vmap(jax.vmap(_point_residual, in_axes=(None, None, 0)),
                       in_axes=(0, 0, 0))(jnp.asarray(pa), jnp.asarray(pb),
                                          jnp.asarray(pts))
        return (np.asarray(out) * np.asarray(mask)[..., None]).ravel()

    base = res_vec(params)
    cols = []
    for i in range(params.shape[0]):
        for j in range(6):
            dp = params.copy()
            dp[i, j] += step
            rp = res_vec(dp)
            dp[i, j] -= 2 * step
            rm = res_vec(dp)
            cols.append((rp - rm) / (2 * step))
    jac = np.stack(cols, axis=1)
    return jac.T @ jac, jac.T @ base


# ---------------------------------------------------------------------------
# Traverse (panorama discovery)
# ---------------------------------------------------------------------------

def traverse(imgs: List[np.ndarray], matches: Dict, badjust: str = "incr",
             use_straighten: bool = True, polish: bool = True,
             mesh=None) -> List[PanoImage]:
    """Best-first expansion over the match graph (bundle_adj.py:348-395).

    ``matches[i][j] = (kpt_pairs (M, 6), hom, n_inliers)`` in the
    reference's rehydrated format. ``polish=False`` reproduces the
    reference's exact fixed-lambda LM trajectory (no adaptive polish).
    ``mesh``: optional ``jax.sharding.Mesh`` with a "data" axis — the
    edge dimension of the bundle-adjustment problem is sharded over it
    and the normal equations psum-reduce across the mesh.
    """
    pair_list = [(i, matches[i][j][1], matches[i][j][2])
                 for i in matches.keys() for j in matches[i].keys()]
    if not pair_list:
        return []
    ids, homs_all, scores = zip(*pair_list)
    src = ids[int(np.argmax(scores))]

    # the heap-walk ORDER depends only on the (host-known) match scores, so
    # the whole schedule — which camera is added when, seeded from which
    # pair homography, gating which edges — is computed here; every
    # value-dependent number (seeds, RMSE gates, LM) runs in ONE device
    # dispatch (_traverse_kernel) instead of a round trip per added camera
    placed = {src}
    adds: List[Tuple[int, int, np.ndarray]] = []     # (dst, src_i, hom)
    edges: List[Tuple[int, int, np.ndarray, int]] = []  # (c1, c2, pts, add)
    qq = [(-matches[src][j][2], src, j) for j in matches[src].keys()]
    heapq.heapify(qq)
    while qq:
        _, src_i, dst = heapq.heappop(qq)
        if dst in placed:
            continue
        k = len(adds)
        adds.append((dst, src_i, matches[src_i][dst][1]))
        for other in range(len(imgs)):   # add() scans cameras in index order
            if other in placed and other in matches.get(dst, {}):
                edges.append((dst, other, matches[dst][other][0], k))
        placed.add(dst)
        for new in matches[dst].keys():
            heapq.heappush(qq, (-matches[dst][new][2], dst, new))

    n = len(imgs)
    cp = _next_pow2(n + 1, 4)      # +1 scratch row for no-op padding adds
    scratch = cp - 1
    # pow2 schedule length: padding adds place the scratch camera and
    # gate nothing, so their _lm_core calls exit after one rejected step
    # (~2 linearizations each); in exchange nearby view counts share one
    # traverse compile (e.g. 10 and 12 views both run ap=16)
    ap = _next_pow2(max(n - 1, 1), 4)
    # EDGE_GROUPS-aligned edge padding: the edge axis always reduces as
    # EDGE_GROUPS ordered partials (_group_reduce), so a pow2 count >= 16
    # is both the compile-shape bucket and the deterministic grouping
    ep = _next_pow2(max(len(edges), 1), EDGE_GROUPS)
    gsize = ep // EDGE_GROUPS
    if mesh is not None:
        # every device needs an equal edge shard: pad the GROUP count up
        # to a device multiple with trailing all-masked groups. Real
        # edges keep the exact single-device 16-group layout and the
        # left-fold reduction makes the zero groups bit-exact no-ops, so
        # ANY device count reproduces the single-device trajectory
        # bit-for-bit.
        nd = int(mesh.devices.size)
        ep = gsize * nd * (-(-EDGE_GROUPS // nd))
    mp = _next_pow2(max((m.shape[0] for _, _, m, _ in edges), default=1), 64)

    dtype = np.float32
    params0 = np.zeros((cp, 6), dtype)
    params0[:, 0] = 1.0
    params0[src] = 0.0   # focal triple set in-kernel from the median

    place_dst = np.full(ap, scratch, np.int32)
    place_src = np.full(ap, scratch, np.int32)
    homs = np.broadcast_to(np.eye(3, dtype=dtype), (ap, 3, 3)).copy()
    for k, (dst, src_i, hom) in enumerate(adds):
        place_dst[k], place_src[k] = dst, src_i
        homs[k] = hom
    cam1 = np.zeros(ep, np.int32)
    cam2 = np.zeros(ep, np.int32)
    pts = np.zeros((ep, mp, 6), dtype)
    pts[..., 2] = 1.0   # benign homogeneous padding (no 0/0 under AD)
    pts[..., 5] = 1.0
    mask = np.zeros((ep, mp), dtype)
    edge_add = np.full(ep, -1, np.int32)   # padded edges are never gated in
    for e, (c1, c2, m, k) in enumerate(edges):
        cam1[e], cam2[e], edge_add[e] = c1, c2, k
        pts[e, : len(m)] = m
        mask[e, : len(m)] = 1.0

    placed_idx = np.asarray(sorted(placed), np.int32)
    operands = (
        jnp.asarray(params0), jnp.int32(src), jnp.asarray(place_dst),
        jnp.asarray(place_src), jnp.asarray(homs),
        jnp.asarray(np.stack(homs_all).astype(dtype)),
        jnp.asarray(placed_idx), jnp.asarray(cam1), jnp.asarray(cam2),
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(edge_add))
    straighten = bool(use_straighten and placed)
    if mesh is not None:
        fn = _traverse_mesh_fn(mesh, badjust, straighten, LM_MAX_ITER,
                               bool(polish), gsize)
        params, _, _ = fn(*operands)
    else:
        params, _, _ = _traverse_kernel(
            *operands, mode=badjust, use_straighten=straighten,
            polish=bool(polish), gsize=gsize)
    params = np.asarray(params, np.float64)

    cameras: List[Optional[PanoImage]] = [None] * n
    for i in sorted(placed):
        cam = _np_camera_from_params(params[i])
        cam.img = imgs[i]
        cameras[i] = cam
    return [c for c in cameras if c is not None]


__all__ = [
    "PanoImage", "BundleAdjuster", "traverse",
    "LM_LAMBDA", "LM_MAX_ITER", "MIN_MATCH_ERROR",
]
