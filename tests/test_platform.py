"""Device- and host-facing plumbing: compile-cache location, PPM image I/O,
the native library's build key, and the entry points that must not fall
back to the CPU when devices are missing."""
import builtins
import os

import jax
import numpy as np
import numpy.testing as npt
import pytest

import pano360
from pano360 import imageio, native, synth


class TestCompileCache:
    def test_env_dir_wins(self):
        env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
        assert pano360.compile_cache_dir(env) == "/some/where"

    def test_default_inside_checkout(self):
        got = pano360.compile_cache_dir({})
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            pano360.__file__)))
        assert got == pano360.DEFAULT_CACHE_DIR == os.path.join(
            root, ".jax_cache")

    def test_empty_env_value_means_unset(self):
        env = {"JAX_COMPILATION_CACHE_DIR": ""}
        assert pano360.compile_cache_dir(env) == pano360.DEFAULT_CACHE_DIR

    def test_tests_run_without_persistent_cache(self):
        assert jax.config.jax_enable_compilation_cache is False


class TestPPM:
    def test_roundtrip_bgr(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
        path = str(tmp_path / "a.ppm")
        imageio.imwrite(path, img)
        npt.assert_array_equal(imageio.imread(path), img)
        # on disk: RGB order, the P6 header, then the raw bytes
        raw = open(path, "rb").read()
        assert raw.startswith(b"P6\n11 7\n255\n")
        npt.assert_array_equal(imageio.read_ppm(path), img[..., ::-1])

    def test_float_input_is_clipped(self, tmp_path):
        path = str(tmp_path / "f.ppm")
        imageio.imwrite(path, np.full((2, 3, 3), 300.0))
        assert (imageio.imread(path) == 255).all()

    def test_header_comment_and_uppercase_ext(self, tmp_path):
        path = str(tmp_path / "c.PPM")
        pix = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
        with open(path, "wb") as fid:
            fid.write(b"P6\n# made by hand\n3 2\n255\n" + pix.tobytes())
        npt.assert_array_equal(imageio.imread(path), pix[..., ::-1])
        assert imageio.list_images(str(tmp_path)) == [path]

    def test_rejects_ascii_ppm(self, tmp_path):
        path = str(tmp_path / "p3.ppm")
        with open(path, "wb") as fid:
            fid.write(b"P3\n1 1\n255\n0 0 0\n")
        with pytest.raises(ValueError, match="binary 8-bit PPM"):
            imageio.imread(path)

    def test_clear_error_without_pillow(self, tmp_path, monkeypatch):
        real_import = builtins.__import__

        def no_pil(name, *args, **kwargs):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError("No module named 'PIL'")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_pil)
        img = np.zeros((2, 2, 3), np.uint8)
        with pytest.raises(ImportError, match="needs Pillow.*PPM"):
            imageio.imwrite(str(tmp_path / "x.png"), img)
        # PPM keeps working with Pillow gone
        imageio.imwrite(str(tmp_path / "x.ppm"), img)
        npt.assert_array_equal(imageio.imread(str(tmp_path / "x.ppm")), img)

    def test_write_dataset_is_ppm(self, tmp_path):
        imgs, _, _ = synth.make_views(n_views=2, shape=(12, 16), seed=0)
        files = synth.write_dataset(str(tmp_path / "v"), imgs)
        assert [os.path.basename(f) for f in files] == ["view00.ppm",
                                                        "view01.ppm"]
        back = imageio.imread(files[1])
        npt.assert_array_equal(back, (imgs[1] * 255).round())


class TestNativeBuildKey:
    def test_key_follows_source(self, tmp_path, monkeypatch):
        src = tmp_path / "crop.cpp"
        src.write_text("int f() { return 1; }\n")
        monkeypatch.setattr(native, "_SRC", str(src))
        monkeypatch.setattr(native, "_DIR", str(tmp_path))
        first = native.lib_path()
        assert first == native.lib_path()
        src.write_text("int f() { return 2; }\n")
        assert native.lib_path() != first
        assert os.path.dirname(first) == str(tmp_path)
        assert os.path.basename(first).startswith("libpanonative-")

    def test_loaded_library_is_keyed(self):
        valid = np.ones((3, 4), bool)
        assert native.largest_rectangle(valid) == (0, 0, 2, 3)
        assert os.path.exists(native.lib_path())


class TestNoSilentFallback:
    def test_dryrun_fails_without_enough_devices(self, monkeypatch):
        import __graft_entry__ as G
        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        with pytest.raises(RuntimeError, match="needs 64 devices"):
            G.dryrun_multichip(64)

    def test_provision_only_for_cpu_rehearsal(self, monkeypatch):
        from pano360.parallel import dryrun as D
        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        monkeypatch.setenv("XLA_FLAGS", "")
        D.provision(4)
        assert os.environ["XLA_FLAGS"] == ""
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        D.provision(4)
        assert "device_count=4" in os.environ["XLA_FLAGS"]

    def test_cli_mesh_needs_the_devices(self, tmp_path):
        from pano360 import cli
        ds = tmp_path / "views"
        imgs, _, _ = synth.make_views(n_views=2, shape=(24, 32), seed=0)
        synth.write_dataset(str(ds), imgs)
        n = len(jax.devices()) + 1
        with pytest.raises(SystemExit, match=f"--mesh {n} needs {n}"):
            cli.main([str(ds), "-s", "1", "--mesh", str(n),
                      "--cache-dir", str(tmp_path)])

    def test_cli_has_no_warp_flag(self):
        from pano360 import cli
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["d", "--warp", "xla"])

    def test_cli_rejects_nonpositive_focal(self, tmp_path, monkeypatch):
        """A registration whose median focal is not positive stops with a
        clear message instead of a singular-matrix crash in the render."""
        from pano360 import cli
        from pano360.register import PanoImage
        ds = tmp_path / "views"
        imgs, _, _ = synth.make_views(n_views=2, shape=(24, 32), seed=0)
        synth.write_dataset(str(ds), imgs)
        monkeypatch.setattr(cli, "matching", lambda *a, **k: (
            np.empty(2, object), np.array({}, object)))
        monkeypatch.setattr(cli, "idx_to_keypoints", lambda *a: {})
        monkeypatch.setattr(cli, "traverse", lambda imgs, *a, **k: [
            PanoImage(im, np.eye(3), np.zeros((3, 3))) for im in imgs])
        with pytest.raises(SystemExit, match="registration failed"):
            cli.main([str(ds), "-s", "1", "--cache-dir", str(tmp_path)])
