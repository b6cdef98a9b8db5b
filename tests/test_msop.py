"""MSOP detector tests (the reference's alternative feature path)."""
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy; fast subset: -m 'not slow'

from pano360 import synth
from pano360.features.msop import (msop_extract_batch,
                                       msop_extract_device,
                                       msop_extract_host, ssc)
from pano360.cli import build_parser, run


class TestMsop:
    def test_extract(self):
        imgs, _, _ = synth.make_views(n_views=1, shape=(160, 200), seed=31)
        kpts, desc = msop_extract_host((imgs[0] * 255).astype(np.uint8))
        assert len(kpts) > 200
        assert desc.shape == (len(kpts), 64)
        # normalized descriptors: zero mean, unit-ish std
        assert abs(float(desc.mean())) < 0.05
        h, w = 160, 200
        assert (kpts[:, 0] < w).all() and (kpts[:, 1] < h).all()

    def test_batch_matches_single(self):
        """The batched path (one vmapped dispatch per level for all
        images) must reproduce the per-image results."""
        imgs, _, _ = synth.make_views(n_views=3, shape=(160, 200), seed=7)
        imgs = [(im * 255).astype(np.uint8) for im in imgs]
        batch = msop_extract_batch(imgs)
        for im, (kb, db) in zip(imgs, batch):
            ks, ds = msop_extract_host(im)
            np.testing.assert_allclose(kb, ks, atol=1e-4)
            np.testing.assert_allclose(db, ds, atol=1e-4)

    def test_device_path_matches_host_path(self):
        """The device-resident extraction (packed candidate readback +
        on-device gather/describe, used by pipeline.matching) must
        reproduce the host path's keypoints and descriptors exactly,
        in the same level-major order, with the device buffers' valid
        rows equal to the host list."""
        imgs, _, _ = synth.make_views(n_views=3, shape=(160, 200), seed=7)
        imgs = [(im * 255).astype(np.uint8) for im in imgs]
        host = msop_extract_batch(imgs)
        kpts_dev, kp_d, ds_d, va_d, counts = msop_extract_device(imgs)
        kp_d, ds_d, va_d = (np.asarray(kp_d), np.asarray(ds_d),
                            np.asarray(va_d))
        for i, (kh, dh) in enumerate(host):
            assert counts[i] == len(kh)
            np.testing.assert_allclose(kpts_dev[i], kh, atol=1e-4)
            # device buffers: the valid rows hold the same keypoints/
            # descriptors in the same order (holes between level blocks
            # are masked out)
            np.testing.assert_allclose(kp_d[i][va_d[i]], kh, atol=1e-4)
            np.testing.assert_allclose(ds_d[i][va_d[i]], dh, atol=1e-4)

    def test_registration_against_ground_truth(self):
        """Absolute-fidelity check, independent of the batch/single code
        path (which share their implementation): MSOP keypoints and
        descriptors from two synthetic views must register to the KNOWN
        camera motion — a uniform corruption of coordinate scale,
        orientation, or descriptor math would fail here even though the
        batch-vs-single comparison cannot see it."""
        import jax
        import jax.numpy as jnp
        from pano360 import match as pm
        from pano360.geometry import focal_from_hom

        shape = (240, 320)
        imgs, rots, focal = synth.make_views(n_views=2, shape=shape,
                                             overlap=0.6, seed=9)
        u8 = [(im * 255).astype(np.uint8) for im in imgs]
        batch = msop_extract_batch(u8)

        cent = np.array([shape[1] / 2, shape[0] / 2], np.float32)
        top = max(len(k) for k, _ in batch)
        cap = max(64, 1 << (top - 1).bit_length())
        buf = []
        for k, d in batch:
            xyp = np.zeros((cap, 2), np.float32)
            dsp = np.zeros((cap, d.shape[1]), np.float32)
            xyp[: len(k)] = k - cent
            dsp[: len(k)] = d
            buf.append((jnp.asarray(xyp), jnp.asarray(dsp),
                        jnp.asarray(np.arange(cap) < len(k))))
        res = pm.match_pair(*buf[0], *buf[1], jax.random.key(0))
        assert bool(res.ok) and int(res.n_inliers) > 50

        # MSOP keypoints are integer-pixel (like the reference's,
        # features.py:142-147), so single-pair focal decomposition is
        # coarser than SIFT's subpixel path (~10% observed); the bounds
        # only need to catch uniform corruption, which is catastrophic
        est_f = float(focal_from_hom(res.hom))
        assert abs(est_f - focal) / focal < 0.2

        k = np.diag([focal, focal, 1.0])
        h = np.asarray(res.hom)
        r = np.linalg.inv(k) @ (h / h[2, 2]) @ k
        u, _, vt = np.linalg.svd(r)
        r = u @ vt
        dr = r @ (rots[1] @ rots[0].T).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))
        assert ang < 1.0, f"rotation error {ang} deg"

    def test_ssc_homogeneous(self):
        rng = np.random.default_rng(3)
        pts = rng.uniform(0, 200, (2000, 2)).astype(np.float32)
        sel = ssc(pts, (200, 200), 100)
        assert 80 <= len(sel) <= 120
        # coverage: selected points spread over all quadrants
        s = pts[sel]
        for qx in (0, 1):
            for qy in (0, 1):
                q = ((s[:, 0] >= qx * 100) & (s[:, 0] < (qx + 1) * 100)
                     & (s[:, 1] >= qy * 100) & (s[:, 1] < (qy + 1) * 100))
                assert q.sum() >= 10

    def test_cli_end_to_end(self, tmp_path):
        """BASELINE config #4: the MSOP extractor through the full CLI."""
        imgs, _, _ = synth.make_views(n_views=3, shape=(150, 200),
                                      overlap=0.5, seed=31)
        ds = tmp_path / "views"
        synth.write_dataset(str(ds), imgs)
        args = build_parser().parse_args(
            [str(ds), "-s", "1", "--detector", "msop", "--ba", "incr",
             "-b", "linear", "--cache-dir", str(tmp_path)])
        mosaic = run(args)
        assert mosaic.shape[1] > 1.5 * 200
        inner = mosaic[mosaic.shape[0] // 3: -mosaic.shape[0] // 3,
                       mosaic.shape[1] // 4: -mosaic.shape[1] // 4]
        assert (inner.sum(-1) > 0).mean() > 0.9
