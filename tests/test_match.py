"""Tests for descriptor matching and parallel RANSAC homography."""
import cv2
import numpy as np
import numpy.testing as npt
import jax
import jax.numpy as jnp
import pytest

from pano360 import match as pm

RNG = np.random.default_rng(11)


def pad_to(arr, n, fill=0.0):
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class TestKnn2:
    def test_matches_bruteforce(self):
        d1 = RNG.random((50, 32)).astype(np.float32)
        d2 = RNG.random((60, 32)).astype(np.float32)
        v1 = np.ones(50, bool)
        v2 = np.ones(60, bool)
        best, good = pm.knn2_matches(jnp.asarray(d1), jnp.asarray(d2),
                                     jnp.asarray(v1), jnp.asarray(v2))
        dists = np.linalg.norm(d1[:, None] - d2[None], axis=2)
        npt.assert_array_equal(np.asarray(best), dists.argmin(1))
        srt = np.sort(dists, axis=1)
        exp_good = srt[:, 0] < 0.7 * srt[:, 1]
        npt.assert_array_equal(np.asarray(good), exp_good)

    def test_matches_cv2_bfmatcher(self):
        d1 = RNG.random((40, 64)).astype(np.float32)
        d2 = RNG.random((55, 64)).astype(np.float32)
        best, good = pm.knn2_matches(
            jnp.asarray(d1), jnp.asarray(d2),
            jnp.ones(40, bool), jnp.ones(55, bool))
        bf = cv2.BFMatcher()
        pairs = bf.knnMatch(d1, d2, k=2)
        cv_good = {m.queryIdx: m.trainIdx
                   for m, n in pairs if m.distance < 0.7 * n.distance}
        ours = {int(q): int(t) for q, (t, g) in
                enumerate(zip(np.asarray(best), np.asarray(good))) if g}
        assert ours == cv_good

    def test_padding_masked(self):
        d1 = RNG.random((10, 16)).astype(np.float32)
        d2 = RNG.random((12, 16)).astype(np.float32)
        b0, g0 = pm.knn2_matches(jnp.asarray(d1), jnp.asarray(d2),
                                 jnp.ones(10, bool), jnp.ones(12, bool))
        d1p, d2p = pad_to(d1, 32), pad_to(d2, 32)
        v1 = np.arange(32) < 10
        v2 = np.arange(32) < 12
        b1, g1 = pm.knn2_matches(jnp.asarray(d1p), jnp.asarray(d2p),
                                 jnp.asarray(v1), jnp.asarray(v2))
        npt.assert_array_equal(np.asarray(b1)[:10], np.asarray(b0))
        npt.assert_array_equal(np.asarray(g1)[:10], np.asarray(g0))
        assert not np.asarray(g1)[10:].any()


def reproj_rms(h_est, h_true, extent=300.0):
    """RMS disagreement of two homographies over a grid of points."""
    g = np.linspace(-extent, extent, 7)
    pts = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    ph = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    a = ph @ h_est.T
    b = ph @ h_true.T
    a = a[:, :2] / a[:, 2:]
    b = b[:, :2] / b[:, 2:]
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


def synthetic_correspondences(n_in=120, n_out=40, noise=0.4, seed=5):
    rng = np.random.default_rng(seed)
    hom = np.array([[1.05, 0.08, 30.0],
                    [-0.06, 0.97, -12.0],
                    [1.2e-4, -8e-5, 1.0]])
    p1 = rng.uniform(-300, 300, (n_in + n_out, 2))
    ph = np.concatenate([p1, np.ones((len(p1), 1))], axis=1) @ hom.T
    p2 = ph[:, :2] / ph[:, 2:]
    p2[:n_in] += rng.normal(0, noise, (n_in, 2))
    p2[n_in:] = rng.uniform(-300, 300, (n_out, 2))  # outliers
    return p1.astype(np.float32), p2.astype(np.float32), hom


class TestRansac:
    def test_recovers_homography(self):
        p1, p2, hom = synthetic_correspondences()
        valid = np.ones(len(p1), bool)
        est, inl, n = pm.ransac_homography(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
            jax.random.key(0))
        est = np.asarray(est)
        assert reproj_rms(est / est[2, 2], hom) < 0.25
        inl = np.asarray(inl)
        assert inl[:120].mean() > 0.95      # finds the true inliers
        assert inl[120:].mean() < 0.05      # rejects the outliers
        assert 110 <= int(n) <= 125

    def test_matches_cv2_quality(self):
        p1, p2, hom = synthetic_correspondences(seed=9)
        cv_h, cv_mask = cv2.findHomography(p1, p2, cv2.RANSAC)
        est, inl, n = pm.ransac_homography(
            jnp.asarray(p1), jnp.asarray(p2), jnp.ones(len(p1), bool),
            jax.random.key(1))
        # both should explain at least as many inliers as cv2 found
        assert int(n) >= int(cv_mask.sum()) - 3
        npt.assert_allclose(np.asarray(est), cv_h / cv_h[2, 2], atol=3e-2)

    def test_low_inlier_ratio_matches_cv2(self):
        """~25% inliers: cv2 runs adaptive-iteration LO-RANSAC; our fixed
        hypothesis budget must still recover the homography with
        comparable accuracy. 1024 hypotheses left P(no clean sample)
        ~= 2% here — observed as a catastrophic miss at one seed — so the
        budget is 2048 (P ~= 4e-4). Checked over several seeds."""
        wins = 0
        for seed in (3, 17, 29, 41):
            p1, p2, hom = synthetic_correspondences(
                n_in=60, n_out=180, seed=seed)
            est, inl, n = pm.ransac_homography(
                jnp.asarray(p1), jnp.asarray(p2),
                jnp.ones(len(p1), bool), jax.random.key(seed))
            est = np.asarray(est)
            ours_rms = reproj_rms(est / est[2, 2], hom)
            cv_h, cv_mask = cv2.findHomography(p1, p2, cv2.RANSAC)
            cv_rms = (reproj_rms(cv_h / cv_h[2, 2], hom)
                      if cv_h is not None else np.inf)
            assert ours_rms < 1.0, (seed, ours_rms)
            assert int(n) >= 0.8 * int(cv_mask.sum())
            if ours_rms <= cv_rms + 0.05:
                wins += 1
        assert wins >= 3     # at least as accurate as cv2 nearly always

    def test_respects_validity_mask(self):
        p1, p2, hom = synthetic_correspondences()
        # corrupt the padded tail; mark it invalid
        p1p, p2p = pad_to(p1, 256, -1e6), pad_to(p2, 256, 1e6)
        valid = np.arange(256) < len(p1)
        est, inl, n = pm.ransac_homography(
            jnp.asarray(p1p), jnp.asarray(p2p), jnp.asarray(valid),
            jax.random.key(0))
        assert not np.asarray(inl)[len(p1):].any()
        est = np.asarray(est)
        assert reproj_rms(est / est[2, 2], hom) < 0.25

    def test_rank_map_equals_searchsorted_sampling(self):
        # the scatter-built rank map (match.py::ransac_homography) must
        # reproduce the rank -> row-index mapping of the searchsorted
        # formulation it replaced, for arbitrary validity masks
        rng = np.random.default_rng(11)
        for frac in (0.03, 0.3, 0.9, 1.0):
            m = 256
            valid = rng.random(m) < frac
            valid[0] = True                     # >= 1 survivor
            n_valid = int(valid.sum())
            cum = np.cumsum(valid.astype(np.int32))
            draws = rng.integers(0, n_valid, (512, 4))
            via_search = np.searchsorted(cum, draws + 1)
            pos = np.where(valid, cum - 1, m)
            rank_map = np.zeros(m, np.int32)
            ok = pos < m
            rank_map[pos[ok]] = np.arange(m)[ok]
            npt.assert_array_equal(rank_map[draws], via_search)

    def test_deterministic(self):
        p1, p2, _ = synthetic_correspondences()
        v = jnp.ones(len(p1), bool)
        r1 = pm.ransac_homography(jnp.asarray(p1), jnp.asarray(p2), v,
                                  jax.random.key(3))
        r2 = pm.ransac_homography(jnp.asarray(p1), jnp.asarray(p2), v,
                                  jax.random.key(3))
        npt.assert_array_equal(np.asarray(r1[0]), np.asarray(r2[0]))


class TestMatchPair:
    def _make_pair(self, n=80, cap=128, dim=32, seed=2):
        """Two keypoint/descriptor sets related by a known homography."""
        rng = np.random.default_rng(seed)
        hom = np.array([[1.0, 0.05, 20.0], [-0.04, 1.02, -8.0],
                        [5e-5, -4e-5, 1.0]])
        k1 = rng.uniform(-200, 200, (n, 2)).astype(np.float32)
        ph = np.concatenate([k1, np.ones((n, 1))], 1) @ hom.T
        k2 = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
        desc = rng.random((n, dim)).astype(np.float32) * 10
        perm = rng.permutation(n)
        k2, desc2 = k2[perm], desc[perm] + rng.normal(0, .01, (n, dim))
        v = np.arange(cap) < n
        return (pad_to(k1, cap), pad_to(desc, cap), v,
                pad_to(k2, cap), pad_to(desc2.astype(np.float32), cap), v,
                hom, perm)

    def test_end_to_end(self):
        k1, d1, v1, k2, d2, v2, hom, perm = self._make_pair()
        res = pm.match_pair(jnp.asarray(k1), jnp.asarray(d1), jnp.asarray(v1),
                            jnp.asarray(k2), jnp.asarray(d2), jnp.asarray(v2),
                            jax.random.key(0))
        assert bool(res.ok)
        assert int(res.n_inliers) >= 75
        est = np.asarray(res.hom)
        npt.assert_allclose(est / est[2, 2], hom, atol=2e-2)
        # matched indices follow the permutation
        idx = np.asarray(res.idx)[np.asarray(res.inlier)]
        npt.assert_array_equal(perm[idx[:, 1]], idx[:, 0])

    def test_rejects_unrelated(self):
        rng = np.random.default_rng(4)
        cap = 64
        k1 = rng.uniform(-100, 100, (cap, 2)).astype(np.float32)
        k2 = rng.uniform(-100, 100, (cap, 2)).astype(np.float32)
        d1 = rng.random((cap, 16)).astype(np.float32)
        d2 = rng.random((cap, 16)).astype(np.float32)
        v = np.ones(cap, bool)
        res = pm.match_pair(*map(jnp.asarray, (k1, d1, v, k2, d2, v)),
                            jax.random.key(0))
        # random descriptors: almost nothing passes the ratio test
        assert int(jnp.sum(res.inlier)) < pm.N_MIN_MATCH or not bool(res.ok)

    def test_too_few_matches_not_ok(self):
        k1, d1, v1, k2, d2, v2, *_ = self._make_pair(n=5, cap=16)
        res = pm.match_pair(jnp.asarray(k1), jnp.asarray(d1), jnp.asarray(v1),
                            jnp.asarray(k2), jnp.asarray(d2), jnp.asarray(v2),
                            jax.random.key(0))
        assert not bool(res.ok)


class TestPackedReadback:
    """The compressed match-result blob (pipeline._pack_match_results)
    must round-trip PairMatch exactly: int16-packed best indices,
    bitpacked inlier mask, bitcast homographies."""

    def test_roundtrip_exact(self):
        from pano360.pipeline import (_pack_match_results,
                                          _unpack_match_results)
        rng = np.random.default_rng(11)
        p, m = 7, 64
        best = rng.integers(0, m, (p, m)).astype(np.int32)
        idx = np.stack([np.broadcast_to(np.arange(m, dtype=np.int32), (p, m)),
                        best], axis=-1)
        inlier = rng.random((p, m)) < 0.3
        # exercise the sign bit of every packed word
        inlier[:, 31] = True
        inlier[:, 63] = True
        hom = rng.normal(size=(p, 3, 3)).astype(np.float32)
        res = pm.PairMatch(idx=jnp.asarray(idx), inlier=jnp.asarray(inlier),
                           hom=jnp.asarray(hom),
                           n_inliers=jnp.asarray(inlier.sum(1), jnp.int32),
                           ok=jnp.asarray(inlier.sum(1) > 4))
        out = _unpack_match_results(
            np.asarray(_pack_match_results(res)), m)
        npt.assert_array_equal(out.idx, idx)
        npt.assert_array_equal(out.inlier, inlier)
        npt.assert_array_equal(out.hom, hom)
        npt.assert_array_equal(out.n_inliers, inlier.sum(1))
        npt.assert_array_equal(out.ok, inlier.sum(1) > 4)
