"""Mesh-parallel paths vs their single-device equivalents (8 virtual CPUs)."""
import numpy as np
import numpy.testing as npt
import jax
import jax.numpy as jnp
import pytest

from pano360 import synth
from pano360 import register as R
from pano360.features import sift as S
from pano360.parallel import (make_mesh, sharded_extract,
                                  distributed_lm_stats)

pytestmark = [
    pytest.mark.skipif(len(jax.devices()) < 8,
                       reason="needs 8 virtual devices"),
    pytest.mark.slow,   # compile-heavy; fast subset: -m 'not slow'
]

CFG = S.SiftConfig(max_kpts=128, upscale=False)


@pytest.fixture(scope="module")
def gray8():
    imgs, _, _ = synth.make_views(n_views=8, shape=(64, 96), overlap=0.5,
                                  seed=0)
    return jnp.asarray(np.stack([im.mean(-1) for im in imgs]), jnp.float32)


class TestParallel:
    def test_sharded_extract_matches_local(self, gray8):
        mesh = make_mesh(8)
        sharded = sharded_extract(mesh, gray8, CFG)
        local = S.sift_extract(gray8, CFG)
        vs = np.asarray(sharded.valid)
        vl = np.asarray(local.valid)
        npt.assert_array_equal(vs, vl)
        both = vs & vl   # padded slots hold garbage; compare valid only
        npt.assert_allclose(np.asarray(sharded.xy)[both],
                            np.asarray(local.xy)[both], atol=1e-3)
        npt.assert_allclose(np.asarray(sharded.desc)[both],
                            np.asarray(local.desc)[both], atol=1e-3)

    def test_distributed_lm_matches_local(self):
        rng = np.random.default_rng(4)
        c, e, m = 4, 8, 64
        params = jnp.asarray(rng.standard_normal((c, 6)) * 0.1
                             + np.array([500, 0, 0, 0, 0, 0]), jnp.float32)
        cam1 = jnp.asarray(rng.integers(0, c, e), jnp.int32)
        cam2 = jnp.asarray((rng.integers(1, c, e) + np.asarray(cam1)) % c,
                           jnp.int32)
        pts = np.ones((e, m, 6), np.float32)
        pts[..., :2] = rng.uniform(-100, 100, (e, m, 2))
        pts[..., 3:5] = rng.uniform(-100, 100, (e, m, 2))
        pts = jnp.asarray(pts)
        mask = jnp.asarray(rng.random((e, m)) > 0.3, jnp.float32)

        mesh = make_mesh(8)
        d = distributed_lm_stats(mesh, params, cam1, cam2, pts, mask)
        l = R._lm_stats(params, cam1, cam2, pts, mask)
        npt.assert_allclose(float(d[0]), float(l[0]), rtol=1e-5)
        npt.assert_allclose(float(d[1]), float(l[1]), rtol=1e-6)
        npt.assert_allclose(np.asarray(d[2]), np.asarray(l[2]),
                            rtol=1e-4, atol=1e-2)
        npt.assert_allclose(np.asarray(d[3]), np.asarray(l[3]),
                            rtol=1e-4, atol=1e-2)

    def test_production_pipeline_mesh_parity(self):
        """matching -> traverse -> stitch over a 4-device mesh must match
        the single-device run of the SAME production functions (the
        ``--mesh`` CLI path; also exercised at 8 devices by
        ``__graft_entry__.dryrun_multichip`` every driver round)."""
        from pano360 import render, synth
        from pano360.pipeline import idx_to_keypoints, matching
        from pano360.register import traverse

        imgs, _, _ = synth.make_views(n_views=4, shape=(64, 96),
                                      overlap=0.5, seed=0)
        imgs = [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]
        mesh = make_mesh(4)

        kpts_m, matches_m = matching(imgs, max_kpts=256, seed=0, mesh=mesh)
        kpts_s, matches_s = matching(imgs, max_kpts=256, seed=0)
        # features and the match graph are bit-identical: every image
        # batch and pair chunk runs the same compiled program on its device
        for a, b in zip(kpts_m, kpts_s):
            npt.assert_array_equal(a, b)
        mm, ms = matches_m.item(), matches_s.item()
        assert set(mm) == set(ms)
        for i in mm:
            assert set(mm[i]) == set(ms[i])
            for j in mm[i]:
                npt.assert_array_equal(mm[i][j][0], ms[i][j][0])

        r_m = traverse(imgs, idx_to_keypoints(matches_m, kpts_m),
                       badjust="incr", mesh=mesh)
        r_s = traverse(imgs, idx_to_keypoints(matches_s, kpts_s),
                       badjust="incr")
        # bundle adjustment reduces edge partials in a deterministic
        # grouped order (register._group_reduce) so mesh/single agree far
        # below any registration-visible level (measured ~1e-5 rot,
        # ~3e-3 px focal — vs ~1.5e-2 px focal with psum's unspecified
        # cross-device order, which cost 25 dB of mosaic agreement)
        for a, b in zip(r_m, r_s):
            npt.assert_allclose(a.rot, b.rot, atol=5e-5)
            npt.assert_allclose(a.intr[0, 0], b.intr[0, 0], rtol=1e-4)

        m_m = render.stitch(r_m, blender="multiband", mesh=mesh)
        m_s = render.stitch(r_s, blender="multiband")
        assert m_m.shape == m_s.shape
        d = m_m.astype(np.float64) - m_s.astype(np.float64)
        mse = float(np.mean(d * d))
        psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        assert psnr >= 50.0, f"mesh mosaic diverged: {psnr:.1f} dB"

    def test_mesh_blend_wrap_parity(self):
        """_blend_sharded's periodic fold (render.py) on a SEAM-CROSSING
        sweep: the patch-sharded mesh blend must reproduce the
        single-device mosaic when given identical regions. 9 views x
        60 deg fov at 0.2 overlap span 444 deg > 360, so crossing
        patches exercise the modular fold under shard_map — the
        wrap x mesh interaction no other mesh test reaches."""
        from pano360 import render

        imgs, rots, focal = synth.make_views(
            n_views=9, shape=(120, 160), seed=5, fov_deg=60.0,
            overlap=0.2)
        intr = np.diag([focal, focal, 1.0])

        def regions():
            return [R.PanoImage((im * 255).astype(np.uint8), r.copy(),
                                intr.copy())
                    for im, r in zip(imgs, rots)]

        mesh = make_mesh(4)
        for blender in ("linear", "multiband"):
            m_s = render.stitch(regions(), blender=blender)
            m_m = render.stitch(regions(), blender=blender, mesh=mesh)
            assert m_m.shape == m_s.shape, (m_m.shape, m_s.shape)
            d = m_m.astype(np.float64) - m_s.astype(np.float64)
            mse = float(np.mean(d * d))
            psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
            assert psnr >= 50.0, f"{blender}: wrap mesh blend {psnr:.1f} dB"
            # every column a crossing view covers must get content
            assert (m_m.sum(axis=(0, 2)) > 0).all(), blender

    def test_mixed_shape_mesh_matching_parity(self):
        """Mixed image shapes shard per shape bucket; features and the
        match graph must be bit-identical to the single-device run."""
        from pano360.pipeline import matching

        imgs, _, _ = synth.make_views(n_views=4, shape=(64, 96),
                                      overlap=0.5, seed=2)
        imgs = [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]
        imgs[1] = imgs[1][:56, :80]   # second shape bucket
        imgs[3] = imgs[3][:56, :80]
        mesh = make_mesh(4)

        kpts_m, matches_m = matching(imgs, max_kpts=256, seed=0,
                                     mesh=mesh)
        kpts_s, matches_s = matching(imgs, max_kpts=256, seed=0)
        for a, b in zip(kpts_m, kpts_s):
            npt.assert_array_equal(a, b)
        mm, ms = matches_m.item(), matches_s.item()
        assert set(mm) == set(ms)
        for i in mm:
            assert set(mm[i]) == set(ms[i])
            for j in mm[i]:
                npt.assert_array_equal(mm[i][j][0], ms[i][j][0])

    def test_msop_mesh_matching_parity(self):
        """MSOP extraction shards its candidate/descriptor dispatches
        over the image axis; per-image programs are independent, so the
        mesh run must reproduce the single-device features."""
        from pano360.pipeline import matching

        imgs, _, _ = synth.make_views(n_views=4, shape=(64, 96),
                                      overlap=0.6, seed=3)
        imgs = [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]
        mesh = make_mesh(4)

        kpts_m, matches_m = matching(imgs, detector="msop", seed=0,
                                     mesh=mesh)
        kpts_s, matches_s = matching(imgs, detector="msop", seed=0)
        for a, b in zip(kpts_m, kpts_s):
            npt.assert_allclose(a, b, atol=1e-4)
        mm, ms = matches_m.item(), matches_s.item()
        assert set(mm) == set(ms)

    def test_traverse_nondividing_device_count(self):
        """Device counts that do not divide EDGE_GROUPS=16 pad with
        trailing all-masked groups; the left-fold reduction makes them
        bit-exact no-ops, so a 3-device traverse must reproduce the
        single-device trajectory."""
        from pano360.pipeline import idx_to_keypoints, matching
        from pano360.register import traverse

        imgs, _, _ = synth.make_views(n_views=4, shape=(64, 96),
                                      overlap=0.5, seed=0)
        imgs = [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]
        mesh = make_mesh(3)

        kpts, matches = matching(imgs, max_kpts=256, seed=0)
        r_m = traverse(imgs, idx_to_keypoints(matches, kpts),
                       badjust="incr", mesh=mesh)
        r_s = traverse(imgs, idx_to_keypoints(matches, kpts),
                       badjust="incr")
        for a, b in zip(r_m, r_s):
            npt.assert_allclose(a.rot, b.rot, atol=5e-5)
            npt.assert_allclose(a.intr[0, 0], b.intr[0, 0], rtol=1e-4)

    # NOTE: the 8-device version of the production pipeline is exercised
    # by __graft_entry__.dryrun_multichip (pano360.parallel.dryrun).
