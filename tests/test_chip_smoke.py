"""chip_smoke.py rehearsed on the CPU at tiny sizes.

The script itself refuses to run without a GPU; these tests call its phase
functions directly (JAX's CPU backend stands in for the card, so the
GPU-vs-CPU comparisons compare the CPU with itself) and check the device
gate, the phase runner and the comparison helpers.
"""
import types

import jax
import numpy as np
import pytest

import chip_smoke as C
from pano360 import synth


@pytest.fixture(scope="module")
def tiny():
    """4 views of 240 x 320 as uint8 BGR (at 180 x 240 the MSOP path
    mis-registers: too few features per view)."""
    imgs, rots, focal = synth.make_views(n_views=4, shape=(240, 320),
                                         overlap=0.5, seed=13)
    return [(im * 255).round().astype(np.uint8) for im in imgs], rots, focal


def _dev(platform, kind="fake"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


class TestDeviceGate:
    def test_rejects_cpu(self):
        with pytest.raises(SystemExit, match="needs a GPU; JAX found cpu"):
            C.require_gpu(jax.devices())

    def test_rejects_too_few_gpus(self):
        with pytest.raises(SystemExit, match="needs 4 GPUs"):
            C.require_gpu([_dev("gpu")] * 2, count=4)

    def test_device_dict(self):
        got = C.require_gpu([_dev("gpu", "H100")] * 4, count=4)
        assert got == {"platform": "gpu", "kind": "H100", "count": 4}

    def test_main_prints_no_result_on_cpu(self, capsys):
        with pytest.raises(SystemExit):
            C.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestHelpers:
    def test_run_phases_reports_failures(self, capsys):
        def bad():
            raise C.PhaseError("boom")
        assert C.run_phases([("a", lambda: None), ("b", bad),
                             ("c", lambda: None)]) == ["b"]
        out = capsys.readouterr().out
        assert "phase b: FAILED" in out and "phase c: ok" in out

    def test_corner_displacement(self):
        shift = np.array([[1, 0, 0.25], [0, 1, 0], [0, 0, 1.0]])
        assert C.corner_displacement(np.eye(3), np.eye(3), (10, 20)) == 0
        assert C.corner_displacement(shift, np.eye(3), (10, 20)) == \
            pytest.approx(0.25)

    def test_compare_sift_identical(self):
        rng = np.random.default_rng(0)
        desc = rng.random((1, 6, 128)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        f = types.SimpleNamespace(
            xy=rng.uniform(0, 50, (1, 6, 2)).astype(np.float32),
            angle=rng.uniform(0, 6, (1, 6)).astype(np.float32),
            desc=desc, valid=np.array([[1, 1, 1, 1, 0, 0]], bool))
        counts, shares, cos = C.compare_sift(f, f)
        assert counts == [(4, 4)] and shares == [1.0]
        np.testing.assert_allclose(cos, 1.0, rtol=1e-6)

    def test_psnr(self):
        a = np.zeros((4, 4, 3), np.uint8)
        assert C.psnr(a, a) == 99.0
        assert C.psnr(a, a + 1) == pytest.approx(48.1308, abs=1e-3)


class TestPhasesTiny:
    def test_flagship(self, tiny, tmp_path):
        out = C.phase_flagship(str(tmp_path), "cpu rehearsal", tiny)
        assert out["placed"] == 4
        assert out["focal_rel_err"] < C.FOCAL_REL_ERR
        assert out["rot_err_deg"] < C.ROT_ERR_DEG
        assert out["render_psnr_db"] == 99.0     # CPU against itself
        assert set(out["stages"]) == {"Loaded images", "Matched features",
                                      "Image registration", "Built mosaic"}

    def test_cli_paths(self, tiny, tmp_path):
        out = C.phase_cli(str(tmp_path), tiny)
        assert set(out) == set(C.CLI_PATHS)
        assert all(v["placed"] == 4 for v in out.values())

    def test_numerics(self, tiny, tmp_path):
        out = C.phase_numerics(str(tmp_path), tiny, tiny,
                               pairs=((0, 1), (1, 2)))
        assert out["sift_pos_share"] == [1.0] * 4
        assert out["pipe_psnr_db"] == 99.0

    def test_mesh(self, tiny, tmp_path):
        out = C.phase_mesh(str(tmp_path), 4, tiny)
        assert out["psnr_db"] >= C.MESH_PSNR_DB
        assert len(out["peak_bytes_in_use"]) == 4


class TestTraceReduction:
    """benchmarks/device_profile.py's reduction on a small recorded CPU
    trace: a named scope is found through the fused HLO op_names."""

    def test_scope_attribution(self, tmp_path):
        import glob
        import jax.numpy as jnp
        from benchmarks import device_profile as DP

        @jax.jit
        def f(x):
            with jax.named_scope("my_scope"):
                y = jnp.sin(x) * 2
            return jnp.cos(y).sum()

        x = jnp.ones((512, 512), jnp.float32)
        module, fused, own = DP.hlo_op_names(
            f.lower(x).compile().as_text())
        assert module == "jit_f"
        assert any("my_scope" in o for ops in fused.values() for o in ops)
        hlo = {(module, DP._norm(n)): (ops, own[n])
               for n, ops in fused.items()}
        f(x).block_until_ready()
        jax.profiler.start_trace(str(tmp_path))
        f(x).block_until_ready()
        jax.profiler.stop_trace()
        path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"),
                         recursive=True)[0]
        red = DP.reduce_trace(path, ("my_scope", "absent"), hlo,
                              plane_prefix="/host:CPU")
        assert red["events"] > 0 and red["busy_ns"] > 0
        assert red["per_module_ns"]["jit_f"] > 0
        assert red["per_scope_ns"]["my_scope"]["any"] > 0
        assert red["per_scope_ns"]["absent"] == {}

    def test_kernel_name_lookup(self):
        from benchmarks import device_profile as DP
        hlo = {("m", "loop_add_fusion_3"): ({"a"}, "a"),
               ("m", "sort_15"): ({"b"}, "b")}
        assert DP._lookup(hlo, "m", "loop_add_fusion.3") == ({"a"}, "a")
        assert DP._lookup(hlo, "m", "sort_15_1__90") == ({"b"}, "b")
        assert DP._lookup(hlo, "m", "sort_15_1") == ({"b"}, "b")
        assert DP._lookup(hlo, "other", "sort_15") is None

    def test_interval_union(self):
        from benchmarks import device_profile as DP
        assert DP._union([(0, 10), (5, 15), (20, 30)]) == 25
        assert DP._union([]) == 0
