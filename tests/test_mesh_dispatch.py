"""``pipeline.matching`` over a mesh: image batches and pair chunks go to the
mesh's devices in turn, each through the same compiled program as the
one-device run, so features and the match graph are bit-identical."""
import numpy as np
import numpy.testing as npt
import jax
import pytest

from pano360 import synth
from pano360.parallel import make_mesh
from pano360.pipeline import matching, upload_extract


@pytest.fixture(scope="module")
def views():
    # 7 views: two extraction batches of 4 and 21 pairs (two chunks)
    imgs, _, _ = synth.make_views(n_views=7, shape=(64, 96), overlap=0.5,
                                  seed=0)
    return [np.clip(im * 255, 0, 255).astype(np.uint8) for im in imgs]


def test_upload_extract_batches_on_devices_in_turn(views):
    devs = jax.devices()[:4]
    stack_m, f_m = upload_extract(views, max_kpts=128, devices=devs)
    stack_s, f_s = upload_extract(views, max_kpts=128)
    assert stack_m.devices() == {devs[0]}
    assert f_m.xy.devices() == {devs[0]}
    npt.assert_array_equal(np.asarray(stack_m), np.asarray(stack_s))
    for a, b in zip(f_m, f_s):
        npt.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_matching_bit_identical(views):
    kpts_m, matches_m = matching(views, max_kpts=128, seed=0,
                                 mesh=make_mesh(4))
    kpts_s, matches_s = matching(views, max_kpts=128, seed=0)
    for a, b in zip(kpts_m, kpts_s):
        npt.assert_array_equal(a, b)
    mm, ms = matches_m.item(), matches_s.item()
    assert mm and set(mm) == set(ms)
    for i in mm:
        assert set(mm[i]) == set(ms[i])
        for j in mm[i]:
            npt.assert_array_equal(mm[i][j][0], ms[i][j][0])
            npt.assert_array_equal(mm[i][j][1], ms[i][j][1])
