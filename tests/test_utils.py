"""Host-utility coverage: viz drawing, profiling timers, image I/O.

These modules are the framework's equivalents of the reference's drawing
helpers (features.py:159-189, 286-299), cProfile wrapper (profiler.py:8-19)
and cv2 I/O call sites (stitcher.py:415-450); the tests pin the behavioral
contracts the CLI and benchmarks rely on.
"""
import logging
import os

import numpy as np
import pytest

from pano360 import imageio, profiling, viz


class TestViz:
    def test_plot_points_draws_and_preserves_input(self):
        img = np.zeros((64, 64, 3), np.uint8)
        pts = [(32.0, 32.0, 0.3, 1.5), (10.0, 50.0, -1.0, 0.5)]
        out = viz.plot_points(img, pts)
        assert out.shape == img.shape
        assert out.sum() > 0  # something was drawn
        assert img.sum() == 0  # input untouched (copy semantics)
        # drawn color is the reference's red-in-BGR box color
        ys, xs = np.nonzero(out[..., 2])
        assert len(ys) > 0
        assert np.all(out[ys, xs, 2] == 255)

    def test_plot_points_clips_out_of_bounds(self):
        img = np.zeros((32, 32, 3), np.uint8)
        # box far outside the canvas must not raise or wrap around
        out = viz.plot_points(img, [(1000.0, -500.0, 0.0, 4.0)])
        assert out.shape == img.shape

    def test_plot_descs_tiling_shape_and_range(self):
        rng = np.random.default_rng(0)
        descs = rng.normal(size=(30, 64)).astype(np.float32)
        out = viz.plot_descs(descs, side=5)
        # 5x5 tiles of 8x8 descriptors, upsampled 4x
        assert out.shape == (5 * 8 * 4, 5 * 8 * 4)
        assert out.dtype == np.uint8
        assert out.max() == 255 and out.min() == 0

    def test_plot_descs_pads_when_too_few(self):
        descs = np.ones((3, 64), np.float32)
        out = viz.plot_descs(descs, side=4)
        assert out.shape == (4 * 8 * 4, 4 * 8 * 4)

    def test_plot_descs_constant_input_no_divzero(self):
        descs = np.full((30, 64), 7.0, np.float32)
        out = viz.plot_descs(descs, side=5)
        assert np.isfinite(out).all()

    def test_match_images_lines_and_inlier_mask(self):
        img1 = np.zeros((40, 60, 3), np.uint8)
        img2 = np.zeros((50, 30, 3), np.uint8)
        pts1 = np.array([[5.0, 5.0], [20.0, 30.0]])
        pts2 = np.array([[10.0, 10.0], [15.0, 40.0]])
        out = viz.match_images(img1, img2, pts1, pts2)
        assert out.shape == (50, 90, 3)
        n_all = int((out[..., 1] == 255).sum())
        assert n_all > 0
        # masking the second match must draw strictly fewer pixels
        out1 = viz.match_images(img1, img2, pts1, pts2,
                                inliers=np.array([True, False]))
        assert int((out1[..., 1] == 255).sum()) < n_all


class TestProfiling:
    def test_stage_timer_accumulates_and_reports(self):
        t = profiling.StageTimer()
        with t.stage("keypoints"):
            pass
        with t.stage("keypoints"):
            pass
        with t.stage("matching"):
            pass
        assert set(t.stages) == {"keypoints", "matching"}
        assert all(v >= 0 for v in t.stages.values())
        rep = t.report()
        assert "keypoints" in rep and "total" in rep

    def test_stage_timer_records_on_exception(self):
        t = profiling.StageTimer()
        with pytest.raises(ValueError):
            with t.stage("boom"):
                raise ValueError("x")
        assert "boom" in t.stages

    def test_stage_timer_logs_reference_format(self, caplog):
        t = profiling.StageTimer()
        with caplog.at_level(logging.INFO, logger="pano360.profiling"):
            with t.stage("mosaic"):
                pass
        assert any("mosaic, time:" in r.getMessage() for r in caplog.records)

    def test_profile_returns_result_and_prints_stats(self, capsys):
        res = profiling.profile(sorted, [3, 1, 2])
        assert res == [1, 2, 3]
        assert "function calls" in capsys.readouterr().out

    def test_device_trace_none_is_noop(self):
        with profiling.device_trace(None):
            x = 1
        assert x == 1


class TestImageIO:
    def test_imwrite_imread_roundtrip_bgr(self, tmp_path):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
        p = str(tmp_path / "x.png")
        imageio.imwrite(p, img)
        back = imageio.imread(p)
        np.testing.assert_array_equal(back, img)

    def test_imwrite_clips_float_input(self, tmp_path):
        img = np.full((8, 8, 3), 300.0, np.float32)
        p = str(tmp_path / "y.png")
        imageio.imwrite(p, img)
        assert imageio.imread(p).max() == 255

    def test_list_images_sorted_and_filtered(self, tmp_path):
        for name in ("b.jpg", "a.png", "notes.txt", "c.BMP"):
            (tmp_path / name).write_bytes(b"")
        got = [os.path.basename(p)
               for p in imageio.list_images(str(tmp_path))]
        assert got == ["a.png", "b.jpg", "c.BMP"]
