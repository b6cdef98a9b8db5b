"""SIFT extraction tests.

Keypoint parity with cv2 is defined *downstream* (SURVEY.md §7 hard part #1):
match-graph inlier counts, recovered focal and relative rotation — not raw
keypoint sets. Images are kept small to bound XLA compile time on CPU.
"""
import dataclasses

import cv2
import numpy as np
import numpy.testing as npt
import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow  # compile-heavy; fast subset: -m 'not slow'

from pano360 import synth
from pano360 import match as pm
from pano360.features import sift as S
from pano360.geometry import focal_from_hom

CFG = S.SiftConfig(max_kpts=1024)
SHAPE = (180, 240)


@pytest.fixture(scope="module")
def pair():
    imgs, rots, focal = synth.make_views(n_views=2, shape=SHAPE,
                                         overlap=0.5, seed=1)
    u8s = [(np.asarray(im) * 255).astype(np.uint8) for im in imgs]
    grays = np.stack([
        cv2.cvtColor(u, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255
        for u in u8s])
    return imgs, u8s, grays, rots, focal


@pytest.fixture(scope="module")
def feats(pair):
    _, _, grays, _, _ = pair
    return S.sift_extract(jnp.asarray(grays), CFG)


class TestExtract:
    def test_finds_keypoints(self, feats):
        v = np.asarray(feats.valid)
        assert v.sum(axis=1).min() > 150

    def test_coords_in_bounds(self, feats):
        v = np.asarray(feats.valid)
        xy = np.asarray(feats.xy)[v]
        h, w = SHAPE
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] <= w - 1).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] <= h - 1).all()

    def test_descriptors_unit_norm(self, feats):
        v = np.asarray(feats.valid)
        d = np.asarray(feats.desc)[v]
        npt.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)
        assert (d >= 0).all()

    def test_rootsift_unit_l2(self, feats):
        v = np.asarray(feats.valid)
        r = np.asarray(S.root_sift(feats.desc))[v]
        npt.assert_allclose(np.linalg.norm(r, axis=1), 1.0, atol=1e-3)

    def test_batch_independence(self, pair, feats):
        """Batched extraction must equal per-image extraction (regression:
        a blur layout bug once convolved across the batch axis)."""
        _, _, grays, _, _ = pair
        solo = S.sift_extract(jnp.asarray(grays[1:]), CFG)
        npt.assert_allclose(np.asarray(feats.xy)[1],
                            np.asarray(solo.xy)[0], atol=1e-4)
        npt.assert_array_equal(np.asarray(feats.valid)[1],
                               np.asarray(solo.valid)[0])

    def test_keypoint_count_near_cv2(self, pair, feats):
        _, u8s, _, _, _ = pair
        cv_n = len(cv2.SIFT_create().detect(u8s[0], None))
        ours = int(np.asarray(feats.valid)[0].sum())
        assert ours > 0.6 * cv_n, f"ours {ours} vs cv2 {cv_n}"


class TestGaussianStackDirect:
    """The two-dispatch direct Gaussian stack must reproduce the
    incremental cv2-parity chain (Gaussians compose: blur(base,
    sqrt(sig_i^2 - sig_0^2)) == chain of per-layer blurs, up to kernel
    truncation + f32 composition-order rounding)."""

    def test_matches_incremental_chain(self, pair):
        _, _, grays, _, _ = pair
        base = S._base_image(jnp.asarray(grays), CFG)
        inc = np.asarray(S._gaussian_stack(base, CFG))
        drc = np.asarray(S._gaussian_stack_direct(base, CFG))
        assert inc.shape == drc.shape
        # interior: tight (truncation tails only)
        m = 24  # > largest half-kernel of the chain
        npt.assert_allclose(drc[:, :, m:-m, m:-m], inc[:, :, m:-m, m:-m],
                            atol=2e-4)
        # borders: reflect-pad composition order differs; still close
        npt.assert_allclose(drc, inc, atol=5e-3)

    def test_downstream_keypoints_agree(self, pair):
        """Keypoints from gauss_mode='direct' overlap the incremental
        set almost completely (sub-threshold DoG wobble only)."""
        _, _, grays, _, _ = pair
        f_inc = S.sift_extract(jnp.asarray(grays), CFG)
        cfg_d = S.SiftConfig(max_kpts=CFG.max_kpts, gauss_mode="direct")
        f_drc = S.sift_extract(jnp.asarray(grays), cfg_d)
        for b in range(grays.shape[0]):
            a = np.asarray(f_inc.xy)[b][np.asarray(f_inc.valid)[b]]
            c = np.asarray(f_drc.xy)[b][np.asarray(f_drc.valid)[b]]
            # fraction of incremental kpts with a direct kpt within 0.5px
            d2 = ((a[:, None] - c[None]) ** 2).sum(-1).min(1)
            frac = float((d2 < 0.25).mean())
            assert frac > 0.97, f"batch {b}: only {frac:.3f} matched"


class TestPatchDtypeBf16:
    """patch_dtype='bfloat16' (an opt-in; float32 is the default after
    the real-texture A/B, benchmarks/ab_real_quality.py)
    quantizes the gradient patches and the one-hot sampling GEMMs
    (f32 accumulate); positions are untouched and descriptors must
    stay within a few ulps-of-bf16 of the f32 reference path."""

    def test_descriptors_close_positions_exact(self, pair, feats):
        _, _, grays, _, _ = pair
        cfg32 = S.SiftConfig(max_kpts=CFG.max_kpts,
                             patch_dtype="float32")
        feats = S.sift_extract(jnp.asarray(grays), cfg32)
        cfg_b = S.SiftConfig(max_kpts=CFG.max_kpts,
                             patch_dtype="bfloat16")
        f_b = S.sift_extract(jnp.asarray(grays), cfg_b)
        # keypoint geometry is computed BEFORE the cast, so every
        # keypoint matches by exact position; a validity flip (an
        # orientation peak straddling the 0.8*max threshold under bf16
        # histogram wobble) reshuffles the global top-k slot order, so
        # align by position rather than by slot.
        matched = 0
        total = 0
        cos_min = 1.0
        for b in range(np.asarray(feats.valid).shape[0]):
            v32 = np.asarray(feats.valid)[b]
            v16 = np.asarray(f_b.valid)[b]
            key32 = np.asarray(feats.xy)[b][v32]
            key16 = np.asarray(f_b.xy)[b][v16]
            a32 = np.asarray(feats.angle)[b][v32]
            a16 = np.asarray(f_b.angle)[b][v16]
            d32 = np.asarray(feats.desc)[b][v32]
            d16 = np.asarray(f_b.desc)[b][v16]
            idx = {}
            for i, p in enumerate(key16):
                idx.setdefault((round(float(p[0]), 3),
                                round(float(p[1]), 3)), []).append(i)
            total += len(key32)
            for i, (p, a) in enumerate(zip(key32, a32)):
                cands = idx.get((round(float(p[0]), 3),
                                 round(float(p[1]), 3)), [])
                # same position; pick the closest angle (duplicate
                # orientations share positions)
                best, bd = None, 0.05
                for j in cands:
                    d = abs(float(a16[j]) - float(a)) % (2 * np.pi)
                    d = min(d, 2 * np.pi - d)
                    if d < bd:
                        best, bd = j, d
                if best is None:
                    continue
                matched += 1
                cos_min = min(cos_min, float((d32[i] * d16[best]).sum()))
        # same keypoint set up to rare threshold flips (~2% observed:
        # orientation peaks straddling 0.8*max under histogram wobble)
        assert matched / total > 0.96, (matched, total)
        # unit-norm descriptors: bf16 sampling moves entries by well
        # under the 0.2 clip threshold; cosine similarity stays ~1
        assert cos_min > 0.99, cos_min


class TestDownstreamParity:
    def _match(self, xy, desc, valid, shape):
        cent = jnp.asarray([shape[1] / 2, shape[0] / 2], jnp.float32)
        return pm.match_pair(xy[0] - cent, desc[0], valid[0],
                             xy[1] - cent, desc[1], valid[1],
                             jax.random.key(0))

    def test_registration_quality(self, pair, feats):
        """Our SIFT end-to-end: focal within 3%, rotation within 0.3 deg."""
        _, _, _, rots, focal = pair
        desc = S.root_sift(feats.desc)
        res = self._match(feats.xy, desc, feats.valid, SHAPE)
        assert bool(res.ok) and int(res.n_inliers) > 80

        est_f = float(focal_from_hom(res.hom))
        assert abs(est_f - focal) / focal < 0.03

        k = np.diag([focal, focal, 1.0])
        h = np.asarray(res.hom)
        r = np.linalg.inv(k) @ (h / h[2, 2]) @ k
        u, _, vt = np.linalg.svd(r)
        r = u @ vt
        dr = r @ (rots[1] @ rots[0].T).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))
        assert ang < 0.3, f"rotation error {ang} deg"

    def test_inliers_comparable_to_cv2_descriptors(self, pair, feats):
        """Inlier count with our SIFT >= 70% of cv2's SIFT descriptors fed
        through the same matcher."""
        _, u8s, _, _, _ = pair
        desc = S.root_sift(feats.desc)
        ours = self._match(feats.xy, desc, feats.valid, SHAPE)

        sift = cv2.SIFT_create()
        cap = CFG.max_kpts
        cent = np.array([SHAPE[1] / 2, SHAPE[0] / 2], np.float32)
        buf = dict(xy=[], desc=[], valid=[])
        for u in u8s:
            kp, des = sift.detectAndCompute(u, None)
            des = np.sqrt(des / (des.sum(1, keepdims=True) + 1e-7))
            pts = np.float32([p.pt for p in kp]) - cent
            n = min(len(pts), cap)
            xyp = np.zeros((cap, 2), np.float32)
            dsp = np.zeros((cap, des.shape[1]), np.float32)
            xyp[:n], dsp[:n] = pts[:n], des[:n]
            buf["xy"].append(xyp)
            buf["desc"].append(dsp)
            buf["valid"].append(np.arange(cap) < n)
        cvres = pm.match_pair(
            jnp.asarray(buf["xy"][0]), jnp.asarray(buf["desc"][0]),
            jnp.asarray(buf["valid"][0]),
            jnp.asarray(buf["xy"][1]), jnp.asarray(buf["desc"][1]),
            jnp.asarray(buf["valid"][1]), jax.random.key(0))
        assert int(ours.n_inliers) >= 0.7 * int(cvres.n_inliers), (
            f"ours {int(ours.n_inliers)} vs cv2-desc {int(cvres.n_inliers)}")



class TestDenseDescriptor:
    """descr_mode='dense' reproduces cv2's calcSIFTDescriptor exactly:
    every integer pixel in the rotated window around the ROUNDED center
    contributes its own central-difference gradient (no sampling
    interpolation). Pinned against a literal NumPy loop of the cv2
    semantics (sift.cpp; the reference runs it via features.py:192-201).
    """

    @staticmethod
    def _cv2_descriptor_loop(img, yf, xf, sig_oct, angle, d=4, nob=8):
        """Literal cv2 calcSIFTDescriptor in NumPy (float64 loop)."""
        h, w = img.shape
        pt_y, pt_x = int(round(yf)), int(round(xf))
        hist_width = 3.0 * sig_oct
        radius = int(round(hist_width * np.sqrt(2) * (d + 1) * 0.5))
        cos_t = np.cos(angle) / hist_width
        sin_t = np.sin(angle) / hist_width
        hist = np.zeros((d + 2, d + 2, nob))
        for i in range(-radius, radius + 1):
            for j in range(-radius, radius + 1):
                c_rot = j * cos_t - i * sin_t
                r_rot = j * sin_t + i * cos_t
                rbin = r_rot + d / 2 - 0.5
                cbin = c_rot + d / 2 - 0.5
                r, c = pt_y + i, pt_x + j
                if not (-1 < rbin < d and -1 < cbin < d
                        and 0 < r < h - 1 and 0 < c < w - 1):
                    continue
                dx = float(img[r, c + 1]) - float(img[r, c - 1])
                dy = float(img[r - 1, c]) - float(img[r + 1, c])
                mag = np.hypot(dx, dy)
                ori = np.mod(np.arctan2(dy, dx) - angle, 2 * np.pi)
                wgt = np.exp((c_rot ** 2 + r_rot ** 2) * (-1 / (d * d * 0.5)))
                obin = ori * (nob / (2 * np.pi))
                r0 = int(np.floor(rbin))
                c0 = int(np.floor(cbin))
                o0 = int(np.floor(obin))
                fr, fc, fo = rbin - r0, cbin - c0, obin - o0
                v = mag * wgt
                for dr, wr in ((0, 1 - fr), (1, fr)):
                    for dc, wc in ((0, 1 - fc), (1, fc)):
                        for do, wo in ((0, 1 - fo), (1, fo)):
                            hist[r0 + 1 + dr, c0 + 1 + dc,
                                 (o0 + do) % nob] += v * wr * wc * wo
        acc = hist[1:-1, 1:-1].reshape(-1)
        nrm = np.sqrt((acc ** 2).sum())
        acc = np.minimum(acc, 0.2 * max(nrm, 1e-12))
        nrm2 = np.sqrt((acc ** 2).sum())
        return acc / max(nrm2, 1e-12)

    def test_matches_cv2_loop(self):
        rng = np.random.default_rng(7)
        img = rng.random((160, 200), np.float32)
        img = np.asarray(cv2.GaussianBlur(img, (0, 0), 2.0))
        cfg = dataclasses.replace(CFG, descr_mode="dense")
        ps = 2 * cfg.patch_half + 2
        cases = [  # (yf, xf, sig_oct, angle)
            (80.3, 100.6, 1.9, 0.7),
            (79.9, 99.2, 3.55, -2.1),   # max-sigma window, 38-px reach
            (45.4, 60.8, 2.6, 2.9),
            (41.0, 161.5, 3.2, 0.0),    # near the window-truncation edge
        ]
        for yf, xf, sig, ang in cases:
            patch, cy, cx = S._extract_patch(
                jnp.asarray(img)[None], jnp.int32(0),
                jnp.int32(round(yf)), jnp.int32(round(xf)), ps, ps)
            gx, gy = S._patch_grads(patch)
            got = np.asarray(S._descriptor_from_patch_dense(
                gx, gy, jnp.float32(yf), jnp.float32(xf), cy, cx,
                jnp.float32(sig), jnp.float32(ang),
                img.shape[0], img.shape[1], cfg))
            want = self._cv2_descriptor_loop(img, yf, xf, sig, ang)
            npt.assert_allclose(got, want, atol=2e-5,
                                err_msg=f"kp {(yf, xf, sig, ang)}")

    def test_matches_cv2_loop_thin_image(self):
        """Non-square source thinner than the window along ONE dim: the
        patch must clip per-dimension (ps_y, ps_x), or in-bounds pixels
        along the LARGER dim silently read zero-padded gradients where
        cv2 contributes real ones."""
        rng = np.random.default_rng(11)
        img = rng.random((200, 64), np.float32)
        img = np.asarray(cv2.GaussianBlur(img, (0, 0), 2.0))
        cfg = dataclasses.replace(CFG, descr_mode="dense")
        ps_y = min(2 * cfg.patch_half + 2, img.shape[0])
        ps_x = min(2 * cfg.patch_half + 2, img.shape[1])
        cases = [  # max-sigma windows reach +-38 px: past the 64-px width
            (100.2, 32.4, 3.55, 0.7),
            (60.7, 30.9, 3.2, -2.0),
        ]
        for yf, xf, sig, ang in cases:
            patch, cy, cx = S._extract_patch(
                jnp.asarray(img)[None], jnp.int32(0),
                jnp.int32(round(yf)), jnp.int32(round(xf)), ps_y, ps_x)
            gx, gy = S._patch_grads(patch)
            psg = 2 * cfg.patch_half
            gx = jnp.pad(gx, [(0, psg - gx.shape[0]),
                              (0, psg - gx.shape[1])])
            gy = jnp.pad(gy, [(0, psg - gy.shape[0]),
                              (0, psg - gy.shape[1])])
            got = np.asarray(S._descriptor_from_patch_dense(
                gx, gy, jnp.float32(yf), jnp.float32(xf), cy, cx,
                jnp.float32(sig), jnp.float32(ang),
                img.shape[0], img.shape[1], cfg))
            want = self._cv2_descriptor_loop(img, yf, xf, sig, ang)
            npt.assert_allclose(got, want, atol=2e-5,
                                err_msg=f"kp {(yf, xf, sig, ang)}")

    def test_end_to_end_positions_match_grid(self, pair, feats):
        """Descriptor mode must not move keypoints: xy/size/angle/valid
        identical to the grid default; descriptors unit-norm."""
        _, _, grays, _, _ = pair
        dense = S.sift_extract(jnp.asarray(grays),
                               dataclasses.replace(CFG, descr_mode="dense"))
        npt.assert_array_equal(np.asarray(dense.valid),
                               np.asarray(feats.valid))
        npt.assert_array_equal(np.asarray(dense.xy), np.asarray(feats.xy))
        npt.assert_array_equal(np.asarray(dense.angle),
                               np.asarray(feats.angle))
        v = np.asarray(dense.valid)
        nrm = np.linalg.norm(np.asarray(dense.desc)[v], axis=1)
        npt.assert_allclose(nrm, 1.0, atol=1e-4)
