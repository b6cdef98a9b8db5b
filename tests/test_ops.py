"""Numerical parity tests of the device image-op library against OpenCV.

cv2 is used here only as the golden oracle (it is what the reference calls
natively); the framework itself never imports it.
"""
import cv2
import numpy as np
import numpy.testing as npt
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi

from pano360 import ops

RNG = np.random.default_rng(7)


def rand_img(h, w, c=None):
    shape = (h, w) if c is None else (h, w, c)
    return RNG.random(shape).astype(np.float32)


class TestGaussian:
    @pytest.mark.parametrize("sigma", [0.8, 1.0, 2.0, 4.0])
    def test_matches_cv2_auto_ksize(self, sigma):
        img = rand_img(64, 56)
        ours = np.asarray(ops.gaussian_blur(jnp.asarray(img), sigma))
        theirs = cv2.GaussianBlur(img, (0, 0), sigma)
        npt.assert_allclose(ours, theirs, atol=1e-5)

    @pytest.mark.parametrize("sigma", [1.0, 2.0])
    def test_matches_cv2_feature_rule(self, sigma):
        """The features.py:20-24 kernel-size rule."""
        img = rand_img(48, 40)
        ksz = ops.feature_ksize(sigma)
        ours = np.asarray(ops.gaussian_blur(jnp.asarray(img), sigma, ksz))
        theirs = cv2.GaussianBlur(img, (ksz, ksz), sigma, sigma)
        npt.assert_allclose(ours, theirs, atol=1e-5)

    def test_multichannel(self):
        img = rand_img(32, 32, 4)
        ours = np.asarray(ops.gaussian_blur(jnp.asarray(img), 2.0))
        theirs = cv2.GaussianBlur(img, (0, 0), 2.0)
        npt.assert_allclose(ours, theirs, atol=1e-5)

    def test_big_sigma_multiband(self):
        """The multiband blender's sigma ladder (stitcher.py:226)."""
        img = rand_img(40, 40)
        sigma = float(np.sqrt(2 * 2 + 1.0) * 4)
        ours = np.asarray(ops.gaussian_blur(jnp.asarray(img), sigma))
        theirs = cv2.GaussianBlur(img, (0, 0), sigma)
        npt.assert_allclose(ours, theirs, atol=1e-5)


class TestDerivatives:
    def test_sobel_x(self):
        img = rand_img(40, 44)
        ours = np.asarray(ops.sobel(jnp.asarray(img), 1, 0))
        theirs = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3)
        npt.assert_allclose(ours, theirs, atol=1e-5)

    def test_sobel_y(self):
        img = rand_img(40, 44)
        ours = np.asarray(ops.sobel(jnp.asarray(img), 0, 1))
        theirs = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3)
        npt.assert_allclose(ours, theirs, atol=1e-5)

    def test_harris(self):
        """cv2.cornerHarris(blockSize=2, ksize=3, k=0.04) (features.py:140)."""
        img = rand_img(48, 48) * 255
        ours = np.asarray(ops.harris_response(jnp.asarray(img)))
        theirs = cv2.cornerHarris(img, blockSize=2, ksize=3, k=0.04)
        npt.assert_allclose(ours, theirs, atol=1e-2 * np.abs(theirs).max())

    def test_max_filter(self):
        img = rand_img(32, 36)
        ours = np.asarray(ops.max_pool3x3(jnp.asarray(img)))
        theirs = ndi.maximum_filter(img, size=3)
        npt.assert_allclose(ours, theirs)


class TestPyramids:
    @pytest.mark.parametrize("shape", [(64, 64), (63, 57)])
    def test_pyr_down(self, shape):
        img = rand_img(*shape)
        ours = np.asarray(ops.pyr_down(jnp.asarray(img)))
        theirs = cv2.pyrDown(img)
        assert ours.shape == theirs.shape
        # interiors must match exactly; cv2's border handling differs on the
        # last row/col for odd sizes
        npt.assert_allclose(ours[1:-1, 1:-1], theirs[1:-1, 1:-1], atol=1e-5)

    def test_pyr_up(self):
        img = rand_img(32, 32)
        ours = np.asarray(ops.pyr_up(jnp.asarray(img)))
        theirs = cv2.pyrUp(img)
        assert ours.shape == theirs.shape
        npt.assert_allclose(ours[2:-2, 2:-2], theirs[2:-2, 2:-2], atol=1e-5)


class TestRemap:
    def test_identity(self):
        img = rand_img(32, 40, 3)
        ys, xs = np.mgrid[0:32, 0:40].astype(np.float32)
        out = np.asarray(ops.remap_bilinear(jnp.asarray(img),
                                            jnp.asarray(xs), jnp.asarray(ys)))
        npt.assert_allclose(out, img, atol=1e-6)

    @pytest.mark.parametrize("border,cvb", [
        ("reflect", cv2.BORDER_REFLECT),
        ("reflect101", cv2.BORDER_REFLECT_101),
        ("replicate", cv2.BORDER_REPLICATE),
    ])
    def test_matches_cv2_borders(self, border, cvb):
        """In-range + far out-of-range queries under each border mode."""
        img = rand_img(24, 28, 3)
        mx = (RNG.random((16, 18), dtype=np.float32) * 60 - 15)
        my = (RNG.random((16, 18), dtype=np.float32) * 55 - 14)
        ours = np.asarray(ops.remap_bilinear(jnp.asarray(img),
                                             jnp.asarray(mx), jnp.asarray(my),
                                             border=border))
        theirs = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cvb)
        npt.assert_allclose(ours, theirs, atol=2e-4)

    def test_constant_border(self):
        img = rand_img(24, 28)
        mx = (RNG.random((10, 10), dtype=np.float32) * 60 - 15)
        my = (RNG.random((10, 10), dtype=np.float32) * 55 - 14)
        ours = np.asarray(ops.remap_bilinear(
            jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my),
            border="constant", cval=0.5))
        theirs = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_CONSTANT, borderValue=0.5)
        npt.assert_allclose(ours, theirs, atol=2e-4)


class TestWarpPerspective:
    def test_matches_cv2(self):
        img = rand_img(40, 50, 3)
        hom = np.array([[1.02, 0.03, -2.0],
                        [-0.01, 0.98, 1.5],
                        [1e-4, -5e-5, 1.0]], dtype=np.float64)
        ours = np.asarray(ops.warp_perspective(jnp.asarray(img),
                                               jnp.asarray(hom), (40, 50)))
        theirs = cv2.warpPerspective(img, hom, (50, 40))  # cv2 takes (w, h)
        # cv2 uses fixed-point coords internally; compare loosely and skip
        # the border seam where constant fill kicks in at slightly different
        # subpixel cutoffs.
        mask = (theirs.sum(-1) > 0) & (ours.sum(-1) > 0)
        diff = np.abs(ours - theirs)[mask]
        assert np.quantile(diff, 0.99) < 2e-2
        assert mask.mean() > 0.9

    def test_inverse_flag(self):
        img = rand_img(30, 30)
        hom = np.eye(3)
        hom[0, 2] = 3.0  # shift
        fwd = np.asarray(ops.warp_perspective(jnp.asarray(img),
                                              jnp.asarray(hom), (30, 30)))
        inv = np.asarray(ops.warp_perspective(
            jnp.asarray(img), jnp.asarray(np.linalg.inv(hom)), (30, 30),
            inverse=True))
        npt.assert_allclose(fwd, inv, atol=1e-5)


class TestResize:
    def test_bilinear_matches_cv2(self):
        img = rand_img(48, 64, 3)
        ours = np.asarray(ops.resize_bilinear(jnp.asarray(img), (24, 32)))
        theirs = cv2.resize(img, (32, 24), interpolation=cv2.INTER_LINEAR)
        npt.assert_allclose(ours, theirs, atol=1e-3)

    def test_upscale(self):
        img = rand_img(16, 16)
        ours = np.asarray(ops.resize_bilinear(jnp.asarray(img), (33, 31)))
        theirs = cv2.resize(img, (31, 33), interpolation=cv2.INTER_LINEAR)
        npt.assert_allclose(ours, theirs, atol=1e-3)

    def test_shrink_area(self):
        img = rand_img(32, 32, 3)
        ours = np.asarray(ops.shrink_area(jnp.asarray(img), 2))
        theirs = cv2.resize(img, (16, 16), interpolation=cv2.INTER_AREA)
        npt.assert_allclose(ours, theirs, atol=1e-6)


class TestColor:
    def test_bgr2gray(self):
        img = rand_img(20, 20, 3)
        ours = np.asarray(ops.bgr2gray(jnp.asarray(img)))
        theirs = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        npt.assert_allclose(ours, theirs, atol=1e-6)
