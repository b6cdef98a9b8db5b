"""Sanity checks for the synthetic dataset generator.

The critical property: rendered views must be consistent with the rotating-
camera model well enough that the *reference* CPU pipeline (SIFT + FLANN +
RANSAC + focal decomposition) can register them — that makes the generator a
valid stand-in for the missing CMU/UAV datasets in baselines and goldens.
"""
import pytest

pytestmark = pytest.mark.slow  # compile-heavy; fast subset: -m 'not slow'

import numpy as np
import numpy.testing as npt

from pano360 import synth


class TestSynth:
    def test_views_shapes_and_range(self):
        imgs, rots, focal = synth.make_views(n_views=3, shape=(120, 160),
                                             seed=3)
        assert len(imgs) == 3 and imgs[0].shape == (120, 160, 3)
        assert 0.0 <= imgs[0].min() and imgs[0].max() <= 1.0
        assert rots.shape == (3, 3, 3)
        npt.assert_almost_equal(rots[0] @ rots[0].T, np.eye(3), decimal=10)

    def test_reference_can_register(self, reference):
        """Reference SIFT+RANSAC finds the true inter-view homography."""
        ref_feat = reference("features")
        ref_ba = reference("bundle_adj")

        imgs, rots, focal = synth.make_views(n_views=2, shape=(240, 320),
                                             overlap=0.5, seed=1)
        u8 = [(im * 255).astype(np.uint8) for im in imgs]
        detect = ref_feat.sift_detector()
        kp, des = [], []
        for im in u8:
            k, d = detect(im)
            cent = np.array([im.shape[1], im.shape[0]]) / 2
            kp.append(np.float32([p.pt - cent for p in k]))
            des.append(d)
        match, hom = ref_feat._match_hom(kp[0], kp[1], des[0], des[1])
        assert hom is not None and len(match) >= 30

        # the homography should be K R01 K^-1 with the known focal
        est_f = ref_ba.get_focal(hom)
        assert abs(est_f - focal) / focal < 0.08

        kint = ref_ba.intrinsics(focal)
        r01 = np.linalg.inv(kint) @ hom @ kint
        r01 = ref_ba.to_rotation(r01)
        true_r01 = rots[1] @ rots[0].T   # maps cam0 rays to cam1 rays
        # compare rotation angle of the discrepancy
        dr = r01 @ true_r01.T
        ang = np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))
        assert ang < 1.0, f"rotation error {ang} deg"
