"""Geometry unit tests.

Ports the reference's property/round-trip tests (pano_tests.py:10-77) onto the
JAX geometry layer and adds direct numerical-parity checks against the
reference implementation's bundle_adj.py (pure numpy, loaded through the
``reference`` fixture for golden comparison — never copied).
"""
import numpy as np
import numpy.testing as npt
import jax
import jax.numpy as jnp
import pytest

from pano360 import geometry as geo
from pano360.synth import _exp_so3_np as rotation_to_mat

RNG = np.random.default_rng(42)


class TestSO3:
    def test_is_rotation(self):
        """exp map produces orthogonal matrices; log inverts (pano_tests.py:14-19)."""
        rad = RNG.standard_normal(3)
        rot = geo.exp_so3(jnp.asarray(rad))
        npt.assert_almost_equal(np.asarray(rot.T @ rot), np.eye(3))
        npt.assert_almost_equal(np.asarray(geo.log_so3(rot)), rad)

    def test_exp_matches_reference(self, reference):
        ref_ba = reference("bundle_adj")
        for _ in range(5):
            rad = RNG.standard_normal(3)
            npt.assert_almost_equal(np.asarray(geo.exp_so3(jnp.asarray(rad))),
                                    ref_ba.rotation_to_mat(rad))

    def test_log_matches_reference(self, reference):
        ref_ba = reference("bundle_adj")
        for _ in range(5):
            rot = ref_ba.rotation_to_mat(RNG.standard_normal(3))
            npt.assert_almost_equal(np.asarray(geo.log_so3(jnp.asarray(rot))),
                                    ref_ba.mat_to_angle(rot))

    def test_exp_zero(self):
        npt.assert_almost_equal(np.asarray(geo.exp_so3(jnp.zeros(3))),
                                np.eye(3))

    def test_exp_batched_and_jittable(self):
        rads = jnp.asarray(RNG.standard_normal((7, 3)))
        rots = jax.jit(geo.exp_so3)(rads)
        assert rots.shape == (7, 3, 3)
        back = jax.jit(geo.log_so3)(rots)
        npt.assert_almost_equal(np.asarray(back), np.asarray(rads))

    def test_nearest_rotation(self, reference):
        ref_ba = reference("bundle_adj")
        mat = RNG.standard_normal((3, 3))
        ours = np.asarray(geo.nearest_rotation(jnp.asarray(mat)))
        theirs = ref_ba.to_rotation(mat)
        npt.assert_almost_equal(ours, theirs)
        npt.assert_almost_equal(ours.T @ ours, np.eye(3))


class TestCamera:
    def test_camera_inverse(self):
        """hom() . proj() == I (pano_tests.py:29-33)."""
        cam = geo.Camera(rot=geo.exp_so3(jnp.asarray(RNG.standard_normal(3))),
                         intr=geo.intrinsics(1e3))
        npt.assert_almost_equal(np.asarray(cam.hom() @ cam.proj()), np.eye(3))

    def test_camera_params_roundtrip(self):
        """params -> camera -> params identity (pano_tests.py:48-53)."""
        params = RNG.standard_normal(6)
        cam = geo.params_to_camera(jnp.asarray(params))
        new_params = geo.camera_to_params(cam)
        npt.assert_almost_equal(np.asarray(new_params), params)

    def test_camera_params_matches_reference(self, reference):
        ref_ba = reference("bundle_adj")
        params = RNG.standard_normal(6)
        ours = geo.params_to_camera(jnp.asarray(params))
        theirs = ref_ba.params_to_camera(params)
        npt.assert_almost_equal(np.asarray(ours.rot), theirs.rot)
        npt.assert_almost_equal(np.asarray(ours.intr), theirs.intr)

    def test_hom_to_from_matches_reference(self, reference):
        ref_ba = reference("bundle_adj")
        p1, p2 = RNG.standard_normal(6), RNG.standard_normal(6)
        c1, c2 = geo.params_to_camera(jnp.asarray(p1)), \
            geo.params_to_camera(jnp.asarray(p2))
        ours = geo.hom_to_from(c1, c2)
        theirs = ref_ba._hom_to_from(ref_ba.params_to_camera(p1),
                                     ref_ba.params_to_camera(p2))
        npt.assert_almost_equal(np.asarray(ours), theirs)

    def test_params_batched(self):
        params = jnp.asarray(RNG.standard_normal((5, 6)))
        cams = geo.params_to_camera(params)
        assert cams.rot.shape == (5, 3, 3)
        npt.assert_almost_equal(np.asarray(geo.camera_to_params(cams)),
                                np.asarray(params))


class TestFocal:
    def test_focal(self):
        """Recovers f=1e3 from K R K^-1 and its inverse (pano_tests.py:21-27)."""
        kint = geo.intrinsics(1e3)
        rot = geo.exp_so3(jnp.asarray(RNG.standard_normal(3)))
        hom = kint @ rot @ jnp.linalg.inv(kint)
        assert np.asarray(geo.focal_from_hom(hom)) == pytest.approx(1e3)
        assert np.asarray(geo.focal_from_hom(jnp.linalg.inv(hom))) == \
            pytest.approx(1e3)

    def test_focal_matches_reference(self, reference):
        ref_ba = reference("bundle_adj")
        for _ in range(10):
            f = 10 ** RNG.uniform(2, 3.5)
            kint = ref_ba.intrinsics(f)
            hom = kint.dot(ref_ba.rotation_to_mat(
                0.3 * RNG.standard_normal(3)).dot(np.linalg.inv(kint)))
            ours = float(geo.focal_from_hom(jnp.asarray(hom)))
            theirs = ref_ba.get_focal(hom)
            npt.assert_allclose(ours, theirs, rtol=1e-6)

    def test_focal_batched(self):
        homs = []
        for _ in range(4):
            kint = np.diag([1e3, 1e3, 1.0])
            homs.append(kint.dot(rotation_to_mat(
                0.2 * RNG.standard_normal(3)).dot(np.linalg.inv(kint))))
        fs = np.asarray(jax.jit(geo.focal_from_hom)(jnp.asarray(homs)))
        npt.assert_allclose(fs, 1e3, rtol=1e-5)


class TestProjections:
    @pytest.mark.parametrize("proj", [geo.SphProj, geo.CylProj])
    def test_roundtrip(self, proj):
        """proj2hom(hom2proj(x)) == x up to scale (pano_tests.py:59-77)."""
        pts = RNG.standard_normal((10, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        new = np.array(proj.proj2hom(proj.hom2proj(jnp.asarray(pts))))
        new /= np.linalg.norm(new, axis=1, keepdims=True)
        npt.assert_almost_equal(new, pts)

    def test_spherical_matches_reference(self, reference):
        ref_st = reference("stitcher")
        pts = RNG.standard_normal((50, 3))
        ours = np.asarray(geo.SphProj.hom2proj(jnp.asarray(pts)))
        theirs = ref_st.SphProj.hom2proj(pts)
        npt.assert_almost_equal(ours, theirs)
        ours_b = np.asarray(geo.SphProj.proj2hom(jnp.asarray(theirs)))
        npt.assert_almost_equal(ours_b, ref_st.SphProj.proj2hom(theirs))


class TestStraighten:
    def test_straighten_recovers_vertical(self):
        """Tilted camera ring recovered up to sign (pano_tests.py:35-46)."""
        n_cams = 10
        step = np.array([0, 1, 0]) * 2 * np.pi / n_cams
        rots = np.stack([rotation_to_mat(step * i)
                         for i in range(n_cams)])
        tilt = rotation_to_mat(np.array([0.1, 0, 0]))
        new_rots = np.asarray(geo.straighten(jnp.asarray(rots @ tilt)))
        new_rots = new_rots @ np.diag([-1, -1, 1])  # orientation ambiguity
        try:
            npt.assert_almost_equal(new_rots, rots)
        except AssertionError:
            npt.assert_almost_equal(new_rots @ np.diag([-1, -1, 1]), rots)

    def test_straighten_matches_reference(self, reference):
        ref_ba = reference("bundle_adj")
        rots = np.stack([ref_ba.rotation_to_mat(0.4 * RNG.standard_normal(3))
                         for _ in range(8)])
        ours = np.asarray(geo.straighten(jnp.asarray(rots)))
        theirs = np.stack(ref_ba.straighten(list(rots)))
        # SVD sign conventions may differ between LAPACK calls; compare up to
        # the documented global orientation ambiguity.
        try:
            npt.assert_almost_equal(ours, theirs, decimal=6)
        except AssertionError:
            npt.assert_almost_equal(ours @ np.diag([-1, -1, 1]), theirs,
                                    decimal=6)
