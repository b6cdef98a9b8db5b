"""Descriptor matching and robust homography estimation on device.

Batched device replacement for the reference's FLANN KD-tree matching
(features.py:223-232) and ``cv2.findHomography(RANSAC)`` (features.py:244):

- Matching is exact brute-force top-2 by L2 distance, computed as one
  descriptor matmul. At panorama scale (<= a few thousand
  descriptors per image) this is faster than any tree and exact, so the
  Lowe ratio test (0.7, features.py:232) behaves as in the reference.
- RANSAC is a fixed-iteration, fully parallel hypothesis kernel: K random
  4-point samples -> batched normalized DLT solves -> batched inlier
  counts -> argmax, then a masked least-squares refit on the winning
  inlier set. No data-dependent control flow; deterministic under an
  explicit PRNG key.

Everything is static-shape: keypoint/descriptor buffers are padded to a
capacity with a validity mask (SURVEY.md §7 "static shapes vs variable
keypoint counts").
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pano360.geometry import inv3x3

LOWE_RATIO = 0.7        # features.py:232
N_MIN_MATCH = 8         # features.py:17
RANSAC_THRESH = 3.0     # cv2.findHomography default reprojection threshold
# Parallel hypothesis budget. cv2's adaptive search at its default 0.995
# confidence needs ~1354 iterations at a 25% inlier ratio (cap 2000);
# 1024 fixed hypotheses left a ~2% miss probability there (observed as a
# catastrophic miss in the low-inlier stress test), 2048 brings
# P(no clean sample) to ~4e-4 — below cv2's own residual risk.
RANSAC_ITERS = 2048

# every product here runs at full f32 precision (no TF32 on the GPU)
_HIGHEST = jax.lax.Precision.HIGHEST


class PairMatch(NamedTuple):
    """Result of matching one ordered image pair (static shapes)."""

    idx: jnp.ndarray        # (M, 2) int32 indices into (kpts1, kpts2)
    inlier: jnp.ndarray     # (M,) bool: ratio-test pass AND RANSAC inlier
    hom: jnp.ndarray        # (3, 3) homography kpts1 -> kpts2
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray         # () bool: >= N_MIN_MATCH ratio matches and valid H


# ---------------------------------------------------------------------------
# Brute-force top-2 matching
# ---------------------------------------------------------------------------

def knn2_matches(desc1: jnp.ndarray, desc2: jnp.ndarray,
                 valid1: jnp.ndarray, valid2: jnp.ndarray,
                 ratio: float = LOWE_RATIO):
    """Top-2 L2 matches of each desc1 row against desc2, with ratio test.

    Returns ``(best_idx (M,), good (M,))`` where ``good`` marks queries that
    are valid and pass Lowe's ratio test against the second-best neighbour.
    """
    d1 = desc1.astype(jnp.float32)
    d2 = desc2.astype(jnp.float32)
    # squared L2 distances via one matmul
    sq1 = jnp.sum(d1 * d1, axis=1, keepdims=True)
    sq2 = jnp.sum(d2 * d2, axis=1)
    cross = jnp.dot(d1, d2.T, precision=_HIGHEST)
    dist2 = sq1 + sq2[None, :] - 2.0 * cross
    dist2 = jnp.maximum(dist2, 0.0)
    dist2 = jnp.where(valid2[None, :], dist2, jnp.inf)

    # top-2 smallest along axis 1 via two min-reductions over the
    # distance matrix instead of a per-row top-k
    best_idx = jnp.argmin(dist2, axis=1)
    d1min = jnp.min(dist2, axis=1)   # == dist2[i, best_idx[i]], no gather
    cols = jnp.arange(dist2.shape[1])[None, :]
    masked = jnp.where(cols == best_idx[:, None], jnp.inf, dist2)
    d2min = jnp.min(masked, axis=1)
    best = jnp.sqrt(d1min)
    second = jnp.sqrt(d2min)

    good = valid1 & (best < ratio * second) & jnp.isfinite(second)
    return best_idx, good


# ---------------------------------------------------------------------------
# Homography estimation
# ---------------------------------------------------------------------------

def _normalization(pts: jnp.ndarray, w: jnp.ndarray):
    """Hartley similarity normalization from weighted point moments.

    Returns T (3,3) mapping pts so the (weighted) centroid is 0 and mean
    distance is sqrt(2).
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-8)
    mean = jnp.sum(pts * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=1))
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / wsum, 1e-8)
    t = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                  dtype=pts.dtype)
    t = t.at[0, 0].set(scale).at[1, 1].set(scale)
    t = t.at[0, 2].set(-scale * mean[0]).at[1, 2].set(-scale * mean[1])
    return t


def _dlt_rows(p1: jnp.ndarray, p2: jnp.ndarray):
    """Two DLT constraint rows per correspondence. p1, p2: (N, 2)."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=1)
    r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], axis=1)
    return jnp.concatenate([r1, r2], axis=0)  # (2N, 9)


def _quad_to_basis(q: jnp.ndarray) -> jnp.ndarray:
    """3x3 map sending the projective basis e1,e2,e3,(1,1,1) to quad ``q``.

    ``q``: (4, 2) points. Columns are the first three (homogeneous) points
    scaled so their sum hits the fourth — the classic closed-form
    construction of a projective frame from 4 points.
    """
    qh = jnp.concatenate([q, jnp.ones((4, 1), q.dtype)], axis=1)   # (4, 3)
    m = qh[:3].T                                                   # (3, 3)
    # full f32 precision: a reduced-precision matmul (TF32 on the GPU)
    # at +-300-px coordinates corrupts the homography by O(1)
    c = jnp.dot(inv3x3(m), qh[3], precision=_HIGHEST)                  # (3,)
    return m * c[None, :]


def hom_from_4pts(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 correspondences, closed form.

    ``H = B A^{-1}`` with A/B the projective-basis frames of the two
    quads — pure 3x3 adjugate inverses and matmuls, which vectorize over
    RANSAC hypotheses as elementwise math instead of the batched pivoted
    8x8 LU the normalized-DLT formulation needs. Degenerate (collinear)
    samples hit a zero determinant and yield inf/NaN entries, which
    downstream inlier counting scores as zero.
    """
    a = _quad_to_basis(p1)
    b = _quad_to_basis(p2)
    hom = jnp.dot(b, inv3x3(a), precision=_HIGHEST)
    z = hom[2, 2]
    z = jnp.where(jnp.abs(z) > 1e-20, z, jnp.inf)
    return hom / z


def _reproj_errors(hom: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray):
    """Squared forward reprojection error |proj(H p1) - p2|^2 per point."""
    u = hom[0, 0] * p1[:, 0] + hom[0, 1] * p1[:, 1] + hom[0, 2]
    v = hom[1, 0] * p1[:, 0] + hom[1, 1] * p1[:, 1] + hom[1, 2]
    w = hom[2, 0] * p1[:, 0] + hom[2, 1] * p1[:, 1] + hom[2, 2]
    inv_w = jnp.where(jnp.abs(w) > 1e-12, 1.0 / w, 0.0)
    du = u * inv_w - p2[:, 0]
    dv = v * inv_w - p2[:, 1]
    err = du * du + dv * dv
    # points mapped behind / to infinity are never inliers
    return jnp.where(jnp.abs(w) > 1e-12, err, jnp.inf)


def refit_homography(p1: jnp.ndarray, p2: jnp.ndarray, w: jnp.ndarray,
                     gn_iters: int = 3) -> jnp.ndarray:
    """Weighted DLT refit + Gauss-Newton polish on the inlier set.

    Mirrors cv2.findHomography's final least-squares/LM refinement over
    RANSAC inliers. ``w``: (M,) weights (inlier mask as float).
    """
    t1 = _normalization(p1, w)
    t2 = _normalization(p2, w)
    n1 = p1 * t1[0, 0] + t1[:2, 2][None, :]
    n2 = p2 * t2[0, 0] + t2[:2, 2][None, :]
    rows = _dlt_rows(n1, n2)                       # (2M, 9)
    ww = jnp.concatenate([w, w])[:, None]
    ata = jnp.dot(rows.T, rows * ww, precision=_HIGHEST)
    # smallest eigenvector of A^T A
    evals, evecs = jnp.linalg.eigh(ata)
    h = evecs[:, 0].reshape(3, 3)
    hom = jnp.dot(jnp.dot(inv3x3(t2), h, precision=_HIGHEST), t1,
                  precision=_HIGHEST)
    hom = hom / hom[2, 2]

    def gn_step(hom, _):
        # Gauss-Newton on forward reprojection residuals, h33 fixed
        def residual(hvec):
            hm = jnp.concatenate(
                [hvec, jnp.ones((1,), hvec.dtype)]).reshape(3, 3)
            u = (jnp.dot(p1, hm[:2, :2].T, precision=_HIGHEST)
                 + hm[:2, 2][None, :])
            z = jnp.dot(p1, hm[2, :2][:, None], precision=_HIGHEST) + 1.0
            r = (u / z - p2) * w[:, None]
            return r.reshape(-1)

        hvec = (hom / hom[2, 2]).reshape(-1)[:8]
        jac = jax.jacfwd(residual)(hvec)
        r = residual(hvec)
        jtj = jnp.dot(jac.T, jac, precision=_HIGHEST)
        jtj = jtj + 1e-6 * jnp.eye(8, dtype=jtj.dtype)
        delta = jnp.linalg.solve(
            jtj, jnp.dot(jac.T, r, precision=_HIGHEST))
        new = hvec - delta
        newh = jnp.concatenate(
            [new, jnp.ones((1,), new.dtype)]).reshape(3, 3)
        # accept only finite updates
        okh = jnp.all(jnp.isfinite(newh))
        return jnp.where(okh, newh, hom), None

    hom, _ = jax.lax.scan(gn_step, hom, None, length=gn_iters)
    return hom


def ransac_homography(p1: jnp.ndarray, p2: jnp.ndarray, valid: jnp.ndarray,
                      key: jax.Array, n_iters: int = RANSAC_ITERS,
                      thresh: float = RANSAC_THRESH):
    """Parallel-hypothesis RANSAC homography.

    ``p1``, ``p2``: (M, 2) padded correspondences; ``valid``: (M,) mask.
    Returns ``(hom, inlier_mask, n_inliers)``.
    """
    m = p1.shape[0]
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)

    # sample 4 valid indices per hypothesis: draw u ~ U[0, n_valid) and map
    # ranks to row indices through a scatter-built rank map (valid row with
    # 1-based rank r scatters its index to slot r-1; invalid rows scatter
    # out of bounds and drop). A jnp.searchsorted binary search per draw
    # computes the same map but measured 119 ms of the 187 ms match
    # dispatch (63% of the whole matcher) vs ~0 for the scatter+gather
    # form; draws with >= 1 valid entry are bit-identical either way.
    cum = jnp.cumsum(valid.astype(jnp.int32))          # 1-based ranks
    pos = jnp.where(valid, cum - 1, m)
    rank_map = jnp.zeros((m,), jnp.int32).at[pos].set(
        jnp.arange(m, dtype=jnp.int32), mode="drop")
    draws = jax.random.randint(key, (n_iters, 4), 0, n_valid)
    sample_idx = rank_map[draws]                       # (K, 4) into [0, M)

    s1 = p1[sample_idx]                                # (K, 4, 2)
    s2 = p2[sample_idx]
    homs = jax.vmap(hom_from_4pts)(s1, s2)             # (K, 3, 3)

    errs = jax.vmap(lambda h: _reproj_errors(h, p1, p2))(homs)  # (K, M)
    inl = (errs < thresh * thresh) & valid[None, :]
    finite = jnp.all(jnp.isfinite(homs.reshape(n_iters, 9)), axis=1)
    counts = jnp.where(finite, jnp.sum(inl, axis=1), 0)

    best = jnp.argmax(counts)
    best_inl = inl[best]
    hom = refit_homography(p1, p2, best_inl.astype(p1.dtype))
    # recompute inliers under the refit homography (cv2 reports the mask of
    # the RANSAC model; we report the refined model's, which is >= as good)
    final_err = _reproj_errors(hom, p1, p2)
    final_inl = (final_err < thresh * thresh) & valid
    # guard: if the refit went degenerate, fall back to the RANSAC model
    ok = jnp.all(jnp.isfinite(hom))
    hom = jnp.where(ok, hom, homs[best])
    final_inl = jnp.where(ok, final_inl, best_inl)
    return hom, final_inl, jnp.sum(final_inl.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Fused pair matching
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_iters", "ratio", "thresh"))
def match_pair(kpts1, desc1, valid1, kpts2, desc2, valid2, key,
               ratio: float = LOWE_RATIO, n_iters: int = RANSAC_ITERS,
               thresh: float = RANSAC_THRESH) -> PairMatch:
    """Full per-pair pipeline: top-2 matmul -> ratio -> RANSAC -> inliers.

    All inputs padded/masked; returns static-shape ``PairMatch`` where
    ``idx[i] = (i, best_idx[i])`` for each query keypoint ``i``.
    """
    best_idx, good = knn2_matches(desc1, desc2, valid1, valid2, ratio)
    m = kpts1.shape[0]
    p1 = kpts1.astype(jnp.float32)
    p2 = kpts2[best_idx].astype(jnp.float32)

    n_good = jnp.sum(good.astype(jnp.int32))
    hom, inl, n_inl = ransac_homography(p1, p2, good, key, n_iters, thresh)
    ok = (n_good >= N_MIN_MATCH) & jnp.all(jnp.isfinite(hom)) & (n_inl >= 4)

    idx = jnp.stack([jnp.arange(m, dtype=jnp.int32),
                     best_idx.astype(jnp.int32)], axis=1)
    return PairMatch(idx=idx, inlier=inl & good, hom=hom,
                     n_inliers=n_inl, ok=ok)


@functools.partial(jax.jit, static_argnames=("n_iters", "ratio", "thresh"))
def match_pairs_batch(kpts, desc, valid, pair_a, pair_b, keys,
                      ratio: float = LOWE_RATIO,
                      n_iters: int = RANSAC_ITERS,
                      thresh: float = RANSAC_THRESH) -> PairMatch:
    """Vectorized ``match_pair`` over a chunk of image pairs.

    kpts/desc/valid: replicated (N, K, ...) feature buffers; pair_a/pair_b:
    (P,) image indices. One device dispatch for the whole chunk — the
    sequential per-pair loop pays a host round-trip per pair.
    """
    def one(a, b, k):
        return match_pair(kpts[a], desc[a], valid[a],
                          kpts[b], desc[b], valid[b], k,
                          ratio=ratio, n_iters=n_iters, thresh=thresh)

    return jax.vmap(one)(pair_a, pair_b, keys)


@functools.partial(jax.jit, static_argnames=("batch_size", "n_iters",
                                             "ratio", "thresh"))
def match_all_pairs(kpts, desc, valid, pair_a, pair_b, keys,
                    batch_size: int = 16,
                    ratio: float = LOWE_RATIO,
                    n_iters: int = RANSAC_ITERS,
                    thresh: float = RANSAC_THRESH) -> PairMatch:
    """P pairs in one device dispatch.

    ``lax.map`` with ``batch_size`` runs vmapped chunks inside a scan, so
    peak memory stays at one chunk's distance matrices.
    ``pipeline.matching`` calls it on chunks of ``batch_size`` pairs, so
    every chunk runs one compiled program on whichever device it lands.
    """
    def one(args):
        a, b, k = args
        return match_pair(kpts[a], desc[a], valid[a],
                          kpts[b], desc[b], valid[b], k,
                          ratio=ratio, n_iters=n_iters, thresh=thresh)

    return jax.lax.map(one, (pair_a, pair_b, keys), batch_size=batch_size)


__all__ = [
    "PairMatch", "knn2_matches", "hom_from_4pts", "refit_homography",
    "ransac_homography", "match_pair", "match_pairs_batch",
    "match_all_pairs",
    "LOWE_RATIO", "N_MIN_MATCH", "RANSAC_THRESH", "RANSAC_ITERS",
]
