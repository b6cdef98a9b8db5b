"""Device-mesh parallelism for the stitching pipeline.

The reference is strictly single-process/single-thread (SURVEY.md §2c);
the honest device scale-out axes are:

- **data-parallel over images** for feature extraction and **over pairs**
  for matching: ``pipeline.matching`` sends its fixed-size image batches
  and pair chunks to the mesh's devices in turn, each through the same
  compiled program as the one-device run, so features and the match
  graph do not depend on the device count;
- **data-parallel over edges** for the bundle adjuster's normal
  equations — the classic distributed Gauss-Newton: every device computes
  J^T J / J^T r for its edge shard, the (6C)^2 system is reduced across
  the mesh and solved replicated. The production traverse reduces via
  ordered all-gathered partials (``register._group_reduce``), so the mesh
  run is deterministic; it is not bit-identical to the one-device run
  (other reduction shapes), and mesh-vs-one-device parity on GPUs is
  tracked in ROADMAP B1. The ``distributed_lm_stats`` building-block
  demo below shows the plain psum form;
- **data-parallel over regions** for the warp and blend
  (``render.stitch`` with a mesh).

The building blocks ride ``shard_map`` over a 1-D ``Mesh(("data",))``; on
GPUs the collectives lower to NCCL, and no multi-host machinery is
needed at panorama scale.
"""
from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from pano360.features import sift as S
from pano360 import match as pm
from pano360 import register as R


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D data mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    grid = mesh_utils.create_device_mesh((n_devices,),
                                         devices=devs[:n_devices])
    return Mesh(grid, ("data",))


def sharded_extract(mesh: Mesh, gray: jnp.ndarray, cfg: S.SiftConfig):
    """SIFT extraction with images sharded over the mesh's data axis.

    gray: (N, H, W) with N divisible by the mesh size. Features come back
    fully replicated (all-gathered) so the host can build the match graph.
    """
    def local(g):
        f = S.sift_extract(g, cfg)
        gather = functools.partial(jax.lax.all_gather, axis_name="data",
                                   tiled=True)
        return jax.tree_util.tree_map(gather, f)

    fn = shard_map(local, mesh=mesh, in_specs=(P("data"),),
                   out_specs=P(), check_vma=False)
    return fn(gray)


def sharded_pair_match(mesh: Mesh, kpts, desc, valid, pair_a, pair_b, keys):
    """RANSAC-match P pairs sharded over devices.

    kpts/desc/valid: replicated (N, K, ...) feature buffers; pair_a/pair_b:
    (P,) image indices per pair, P divisible by mesh size; keys: (P,) PRNG
    keys. Returns stacked PairMatch results, replicated.
    """
    def local(pa, pb, ks):
        def one(a, b, k):
            return pm.match_pair(kpts[a], desc[a], valid[a],
                                 kpts[b], desc[b], valid[b], k)
        res = jax.vmap(one)(pa, pb, ks)
        gather = functools.partial(jax.lax.all_gather, axis_name="data",
                                   tiled=True)
        return jax.tree_util.tree_map(gather, res)

    fn = shard_map(local, mesh=mesh, in_specs=(P("data"), P("data"),
                                               P("data")),
                   out_specs=P(), check_vma=False)
    return fn(pair_a, pair_b, keys)


def distributed_lm_stats(mesh: Mesh, params, cam1_idx, cam2_idx, pts, mask):
    """One LM linearization with edges sharded over devices.

    Each device accumulates J^T J / J^T r for its edge shard; results are
    psum-reduced across the mesh. params replicated (C, 6); edge arrays (E, ...)
    with E divisible by the mesh size.
    """
    def local(p, c1, c2, pt, mk):
        sq, n, jtj, jtr = R._lm_stats(p, c1, c2, pt, mk)
        sq = jax.lax.psum(sq, "data")
        n = jax.lax.psum(n, "data")
        jtj = jax.lax.psum(jtj, "data")
        jtr = jax.lax.psum(jtr, "data")
        return sq, n, jtj, jtr

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P("data"), P("data"), P("data"),
                             P("data")),
                   out_specs=(P(), P(), P(), P()), check_vma=False)
    return fn(params, cam1_idx, cam2_idx, pts, mask)


def distributed_step(mesh: Mesh, gray: jnp.ndarray, cfg: S.SiftConfig,
                     lm_lambda: float = R.LM_LAMBDA):
    """One full distributed pipeline step (the framework's 'training step').

    Extraction is data-parallel over images, matching over the ring of
    adjacent pairs, and one damped Gauss-Newton update of all camera
    parameters is computed from psum-reduced normal equations. Returns
    (updated params (N, 6), total inliers) — used by the multi-chip dryrun
    and as the template for real multi-chip deployments.
    """
    n = gray.shape[0]

    feats = sharded_extract(mesh, gray, cfg)
    desc = S.root_sift(feats.desc)

    pair_a = jnp.arange(n, dtype=jnp.int32)
    pair_b = jnp.asarray((jnp.arange(n) + 1) % n, jnp.int32)
    keys = jax.vmap(jax.random.key)(jnp.arange(n, dtype=jnp.uint32))
    res = sharded_pair_match(mesh, feats.xy, desc, feats.valid,
                             pair_a, pair_b, keys)

    # edges: ring pairs; build padded match-point tensors from PairMatch
    m = feats.xy.shape[1]
    ones = jnp.ones((n, m, 1), jnp.float32)
    p1 = jnp.concatenate([feats.xy[pair_a], ones], axis=-1)
    idx_b = res.idx[..., 1]
    p2 = jnp.take_along_axis(feats.xy[pair_b], idx_b[..., None], axis=1)
    p2 = jnp.concatenate([p2, ones], axis=-1)
    pts = jnp.concatenate([p1, p2], axis=-1)          # (E, M, 6)
    mask = res.inlier.astype(jnp.float32)

    # initial cameras: identity rotations, focal from image width
    focal = jnp.full((n,), gray.shape[2] * 1.2, jnp.float32)
    params = jnp.zeros((n, 6), jnp.float32)
    params = params.at[:, 0].set(focal)

    sq, cnt, jtj, jtr = distributed_lm_stats(
        mesh, params, pair_a, pair_b, pts, mask)
    jtj = jtj + lm_lambda * jnp.eye(jtj.shape[0], dtype=jtj.dtype)
    delta = jnp.linalg.solve(jtj, jtr)
    new_params = params - delta.reshape(params.shape)
    return new_params, jnp.sum(res.n_inliers)


__all__ = ["make_mesh", "sharded_extract", "sharded_pair_match",
           "distributed_lm_stats", "distributed_step"]
