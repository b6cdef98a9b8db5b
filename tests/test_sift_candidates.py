"""DoG candidate selection (sift._octave_candidates) on a small octave.

Selection is an exact ``lax.top_k`` over the dense extrema score. It must
equal a plain numpy score map, stably sorted in descending order and cut
at ``cap`` (ties resolve to the lower flat index) — the same selection
the earlier approximate selector's sort-based lowering made on the GPU
and the CPU.
"""
import numpy as np
import numpy.testing as npt
import jax.numpy as jnp
import pytest

from pano360 import synth
from pano360.features import sift as S

CFG = S.SiftConfig()


@pytest.fixture(scope="module")
def dog():
    imgs, _, _ = synth.make_views(n_views=2, shape=(48, 64), seed=3)
    gray = np.stack([im.mean(-1) for im in imgs]).astype(np.float32)
    base = S._base_image(jnp.asarray(gray), CFG)
    gauss = S._gaussian_stack(base, CFG)
    return gauss[:, 1:] - gauss[:, :-1]


def numpy_score(d, cfg=CFG):
    """Plain numpy dense extrema score: the 26-neighbour max/min test,
    contrast threshold, image border and the principal-curvature edge
    test at integer positions. (N, S+2, H, W) -> (N, S*H*W)."""
    n, nl, h, w = d.shape
    s = nl - 2
    c = d[:, 1:-1]
    mx = np.full(c.shape, -np.inf, np.float32)
    mn = np.full(c.shape, np.inf, np.float32)
    pmx = np.pad(d, ((0, 0), (0, 0), (1, 1), (1, 1)),
                 constant_values=-np.inf)
    pmn = np.pad(d, ((0, 0), (0, 0), (1, 1), (1, 1)),
                 constant_values=np.inf)
    for dl in range(3):
        for dy in range(3):
            for dx in range(3):
                mx = np.maximum(mx, pmx[:, dl:dl + s, dy:dy + h, dx:dx + w])
                mn = np.minimum(mn, pmn[:, dl:dl + s, dy:dy + h, dx:dx + w])
    thresh = np.float32(0.5 * cfg.contrast_thresh / s)
    is_ext = ((c >= mx) & (c > thresh)) | ((c <= mn) & (c < -thresh))
    b = cfg.img_border
    inside = np.zeros((h, w), bool)
    inside[b:h - b, b:w - b] = True
    dxx = np.zeros_like(c)
    dyy = np.zeros_like(c)
    dxy = np.zeros_like(c)
    dxx[..., :, 1:-1] = c[..., :, 2:] - 2 * c[..., :, 1:-1] + c[..., :, :-2]
    dyy[..., 1:-1, :] = c[..., 2:, :] - 2 * c[..., 1:-1, :] + c[..., :-2, :]
    dxy[..., 1:-1, 1:-1] = (c[..., 2:, 2:] - c[..., 2:, :-2]
                            - c[..., :-2, 2:] + c[..., :-2, :-2]) * 0.25
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = cfg.edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    keep = is_ext & inside & edge_ok
    return np.where(keep, np.abs(c), 0).astype(np.float32).reshape(n, -1)


@pytest.mark.parametrize("cap", [64, 256, 1000])
def test_matches_stable_sort(dog, cap):
    n, nl, h, w = dog.shape
    layer, y, x, ok = (np.asarray(a) for a in S._octave_candidates(
        dog, CFG, cap))
    scores = numpy_score(np.asarray(dog, np.float32))
    assert (scores > 0).sum(1).min() > 0
    for b in range(n):
        order = np.argsort(-scores[b], kind="stable")[:cap]
        npt.assert_array_equal(order // (h * w) + 1, layer[b])
        npt.assert_array_equal(order // w % h, y[b])
        npt.assert_array_equal(order % w, x[b])
        npt.assert_array_equal(scores[b][order] > 0, ok[b])


def test_candidates_are_extrema_inside_border(dog):
    n, nl, h, w = dog.shape
    layer, y, x, ok = (np.asarray(a) for a in S._octave_candidates(
        dog, CFG, 512))
    d = np.asarray(dog)
    b_ = CFG.img_border
    thresh = 0.5 * CFG.contrast_thresh / CFG.n_layers
    assert ok.any()
    for b in range(n):
        for l, yy, xx in zip(layer[b][ok[b]], y[b][ok[b]], x[b][ok[b]]):
            assert 1 <= l <= CFG.n_layers
            assert b_ <= yy < h - b_ and b_ <= xx < w - b_
            cube = d[b, l - 1:l + 2, yy - 1:yy + 2, xx - 1:xx + 2]
            c = d[b, l, yy, xx]
            assert abs(c) > thresh
            assert c == cube.max() or c == cube.min()


def test_gauss_mode_direct_selects_stack_and_unknown_raises():
    imgs, _, _ = synth.make_views(n_views=1, shape=(48, 64), seed=3)
    gray = jnp.asarray(imgs[0].mean(-1)[None], jnp.float32)
    base = S._base_image(gray, CFG)
    inc = np.asarray(S._gaussian_stack(base, CFG))
    drc = np.asarray(S._gaussian_stack(
        base, S.SiftConfig(gauss_mode="direct")))
    npt.assert_array_equal(
        drc, np.asarray(S._gaussian_stack_direct(base, CFG)))
    npt.assert_allclose(drc, inc, atol=5e-3)
    with pytest.raises(ValueError, match="gauss_mode"):
        S._gaussian_stack(base, S.SiftConfig(gauss_mode="pallas"))
