"""End-to-end pipeline integration tests through the CLI surface."""
import os
import pickle

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy; fast subset: -m 'not slow'

from pano360 import synth
from pano360.cli import build_parser, run


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    ds = root / "views"
    imgs, rots, focal = synth.make_views(n_views=4, shape=(180, 240),
                                         overlap=0.5, seed=13)
    synth.write_dataset(str(ds), imgs)
    return str(ds), str(root), rots, focal


class TestEndToEnd:
    def test_full_pipeline(self, dataset):
        ds, root, rots, focal = dataset
        args = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", root])
        mosaic = run(args)

        assert mosaic.dtype == np.uint8 and mosaic.ndim == 3
        h, w = mosaic.shape[:2]
        assert w > 1.8 * 240 and h >= 170      # covers multiple views
        # interior should be filled
        inner = mosaic[h // 4: -h // 4, w // 4: -w // 4]
        assert (inner.sum(-1) > 0).mean() > 0.98

        # registration quality from the BA cache: all views placed,
        # focal within 3%, relative rotations within 0.5 deg (straighten
        # preserves relative rotations)
        with open(os.path.join(root, "ba_views_s1.0.pkl"), "rb") as fid:
            regions = pickle.load(fid)
        assert len(regions) == 4
        est_f = regions[0].intr[0, 0]
        assert abs(est_f - focal) / focal < 0.03
        for i in range(3):
            true_rel = rots[i + 1] @ rots[i].T
            est_rel = regions[i + 1].rot @ regions[i].rot.T
            dr = est_rel @ true_rel.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2,
                                               -1, 1)))
            assert ang < 0.5, f"edge {i}: {ang} deg"

    def test_cache_roundtrip_identical(self, dataset):
        """Second run must consume the caches and reproduce the mosaic."""
        ds, root, *_ = dataset
        args = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", root])
        m1 = run(args)
        m2 = run(args)
        np.testing.assert_array_equal(m1, m2)

    def test_cache_structure_matches_reference(self, dataset):
        """NPZ/PKL cache contents have the reference's exact structure."""
        ds, root, *_ = dataset
        arr = np.load(os.path.join(root, "matches_views_s1.0.npz"),
                      allow_pickle=True)
        kpts, matches = arr["kpts"], arr["matches"]
        assert kpts.dtype == object and len(kpts) == 4
        assert kpts[0].dtype == np.float32 and kpts[0].shape[1] == 2
        md = matches.item()
        some_src = next(iter(md))
        some_dst = next(iter(md[some_src]))
        m, hom = md[some_src][some_dst]
        assert m.dtype == np.int32 and m.shape[1] == 2
        assert hom.shape == (3, 3)
        # reverse edge present and consistent
        mr, homr = md[some_dst][some_src]
        np.testing.assert_array_equal(mr, np.fliplr(m))
        np.testing.assert_allclose(homr, np.linalg.inv(hom), rtol=1e-8)

    def test_flag_defaults_match_reference(self):
        """Same defaults as stitcher.py:392-409."""
        args = build_parser().parse_args(["some/path"])
        assert args.shrink == 2
        assert args.ba == "incr"
        assert args.blend == "multiband"
        assert not args.equalize and not args.crop

    def test_mixed_shape_pipeline(self, tmp_path):
        """Mixed image sizes stitch end-to-end (features.py:259-265
        processes images independently; we batch per shape bucket)."""
        tex = synth.world_texture(seed=3)
        focal = 240 / (2 * np.tan(np.radians(55) / 2))
        fov = 2 * np.arctan(240 / (2 * focal))
        step = fov * 0.5
        shapes = [(180, 240), (220, 200), (180, 240), (220, 200)]
        imgs = []
        for i, shp in enumerate(shapes):
            rot = synth._exp_so3_np(np.array([0.0, (i - 1.5) * step, 0.0]))
            imgs.append(synth.render_view(tex, rot, focal, shp))
        ds = tmp_path / "views"
        synth.write_dataset(str(ds), imgs)

        args = build_parser().parse_args(
            [str(ds), "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", str(tmp_path)])
        mosaic = run(args)
        assert mosaic.dtype == np.uint8 and mosaic.ndim == 3
        with open(tmp_path / "ba_views_s1.0.pkl", "rb") as fid:
            regions = pickle.load(fid)
        assert len(regions) == 4, "all mixed-shape views must register"
        est_f = regions[0].intr[0, 0]
        assert abs(est_f - focal) / focal < 0.05

    def test_cylindrical_projection(self, dataset, tmp_path):
        """--projection cylindrical renders through CylProj end-to-end
        (the reference ships the model but never wires it)."""
        ds, root, *_ = dataset
        args = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", root, "--projection", "cylindrical"])
        mosaic = run(args)
        assert mosaic.dtype == np.uint8 and mosaic.ndim == 3
        h, w = mosaic.shape[:2]
        assert w > 1.8 * 240 and h >= 150
        inner = mosaic[h // 4: -h // 4, w // 4: -w // 4]
        assert (inner.sum(-1) > 0).mean() > 0.95

    def test_mesh_flag_cli_parity(self, dataset, tmp_path):
        """--mesh 2 through the CLI (cli.py mesh wiring: device gate,
        make_mesh, mesh handed to every stage) reproduces the
        single-device mosaic. Fresh cache dir so the mesh run computes
        matching/traverse/stitch itself instead of consuming caches."""
        ds, root, *_ = dataset
        base = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", root])
        m_s = run(base)
        args = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", str(tmp_path), "--mesh", "2"])
        m_m = run(args)
        assert m_m.shape == m_s.shape
        d = m_m.astype(np.float64) - m_s.astype(np.float64)
        mse = float(np.mean(d * d))
        psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        assert psnr >= 50.0, f"--mesh mosaic diverged: {psnr:.1f} dB"

    def test_flag_combo_equalize_crop_warp_maxres(self, dataset):
        """CLI wiring for -e, -c, --seed and --max-resolution in one run
        (reference flags stitcher.py:390-410 + our extensions): reuses
        the fixture caches, so only the render stage recomputes."""
        ds, root, *_ = dataset
        args = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", root, "-e", "-c", "--seed", "5",
             "--max-resolution", "500"])
        mosaic = run(args)
        assert mosaic.dtype == np.uint8 and mosaic.ndim == 3
        # crop: every border row/column keeps some valid content
        assert (mosaic.sum(axis=(1, 2)) > 0).all()
        assert (mosaic.sum(axis=(0, 2)) > 0).all()
        # the cap must bound the canvas
        assert max(mosaic.shape[:2]) <= 500

    def test_two_image_minimum(self, tmp_path):
        """The smallest useful panorama: two overlapping views."""
        imgs, _, _ = synth.make_views(n_views=2, shape=(180, 240),
                                      overlap=0.5, seed=21)
        ds = tmp_path / "pair"
        synth.write_dataset(str(ds), imgs)
        args = build_parser().parse_args(
            [str(ds), "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", str(tmp_path)])
        mosaic = run(args)
        assert mosaic.ndim == 3 and mosaic.shape[1] > 240

    def test_unrelated_images_clean_exit(self, tmp_path):
        """Views with no overlap produce an empty match graph and a clean
        SystemExit, not a crash (cli.py empty-graph gate)."""
        a, _, _ = synth.make_views(n_views=1, shape=(180, 240), seed=31)
        b, _, _ = synth.make_views(n_views=1, shape=(180, 240), seed=77)
        ds = tmp_path / "unrelated"
        synth.write_dataset(str(ds), [a[0], b[0]])
        args = build_parser().parse_args(
            [str(ds), "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", str(tmp_path)])
        with pytest.raises(SystemExit, match="match graph is empty"):
            run(args)

    def test_features_cli_visualize(self, dataset, tmp_path, monkeypatch):
        """features_cli --visualize writes the match-overlay image (the
        reference's match_images one-shot check)."""
        ds, *_ = dataset
        monkeypatch.chdir(tmp_path)
        from pano360.features_cli import main as fmain
        fmain(["--path", ds, "--visualize", "0", "1"])
        name = os.path.basename(ds)
        assert os.path.exists(f"matches_{name}.npz")
        assert os.path.exists(f"matches_{name}_0_1.png")

    def test_profile_and_trace_flags(self, dataset, capsys, tmp_path):
        """--profile prints the cProfile + stage report; --trace-dir
        writes a jax.profiler trace (both consume the warm caches)."""
        ds, root, *_ = dataset
        trace = tmp_path / "trace"
        args = build_parser().parse_args(
            [ds, "-s", "1", "--ba", "incr", "-b", "linear",
             "--cache-dir", root, "--profile", "--trace-dir", str(trace)])
        from pano360.cli import main
        main([ds, "-s", "1", "--ba", "incr", "-b", "linear",
              "--cache-dir", root, "--profile", "--trace-dir", str(trace)])
        out = capsys.readouterr().out
        assert "cumulative" in out          # cProfile table
        assert "Built mosaic" in out        # stage report
        assert "total:" in out
        assert any(trace.rglob("*")), "trace directory is empty"
