"""Pipeline orchestration: detection + all-pairs match graph.

Host-side equivalent of the reference's ``features.matching``
(features.py:255-283) and ``stitcher.idx_to_keypoints``
(stitcher.py:372-387), producing bit-structure-compatible results:

- ``kpts``: object array of per-image float32 (N_i, 2) *center-relative*
  keypoint coordinates;
- ``matches[src][dst] = (match_idx (M, 2) int32, hom)`` for all connected
  ordered pairs, with the reverse edge = (fliplr, inv(hom));
- ``idx_to_keypoints`` rehydrates to homogeneous coords + confidence.

Device work (SIFT, descriptor matmul, RANSAC) is batched; the O(N^2) pair
loop itself is host-side but each iteration is a single fused device call.
"""
from __future__ import annotations

import functools
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pano360 import match as pm
from pano360.features import sift as S
from pano360.features.msop import msop_extract_batch
from pano360.ops.color import bgr2gray

LOG = logging.getLogger(__name__)


def _compact_features(feats: S.SiftFeatures, shapes):
    """Padded device buffers -> per-image compact numpy (kpts, desc)."""
    kpts, descs = [], []
    xy = np.asarray(feats.xy)
    desc = np.asarray(S.root_sift(feats.desc))
    valid = np.asarray(feats.valid)
    for i, (h, w) in enumerate(shapes):
        v = valid[i]
        cent = np.array([w / 2, h / 2], np.float32)
        kpts.append((xy[i][v] - cent).astype(np.float32))
        descs.append(desc[i][v].astype(np.float32))
    return kpts, descs


def _shape_buckets(imgs: List[np.ndarray]):
    """Group image indices by (H, W) so each bucket batches one shape."""
    buckets: Dict[tuple, List[int]] = {}
    for i, im in enumerate(imgs):
        buckets.setdefault(im.shape[:2], []).append(i)
    return buckets


def detect_all(imgs: List[np.ndarray], detector: str = "sift",
               max_kpts: int = 4096, mesh=None):
    """Extract keypoints/descriptors for all images (batched on device).

    Returns per-image lists of center-relative float32 keypoints and
    descriptors (compact, like the reference's detector closures).
    Mixed image shapes are supported by batching per shape bucket
    (features.py:259-265 processes each image independently).
    ``mesh``: optional ``jax.sharding.Mesh`` — each bucket's device
    dispatches shard over the image axis.
    """
    if not imgs:
        raise ValueError("no images to process (empty directory?)")
    if detector == "msop":
        kpts = [None] * len(imgs)
        descs = [None] * len(imgs)
        for shape, idxs in _shape_buckets(imgs).items():
            batch = msop_extract_batch([imgs[i] for i in idxs],
                                       mesh=mesh)
            cent = np.array([shape[1] / 2, shape[0] / 2], np.float32)
            for i, (k, d) in zip(idxs, batch):
                kpts[i] = (k - cent).astype(np.float32)
                descs[i] = d.astype(np.float32)
        return kpts, descs
    cfg = S.SiftConfig(max_kpts=max_kpts)
    kpts = [None] * len(imgs)
    descs = [None] * len(imgs)
    for shape, idxs in _shape_buckets(imgs).items():
        gray = np.stack([
            np.asarray(bgr2gray(jnp.asarray(
                imgs[i].astype(np.float32) / 255.0))) for i in idxs])
        feats = S.sift_extract(jnp.asarray(gray), cfg)
        ks, ds = _compact_features(feats, [shape] * len(idxs))
        for j, i in enumerate(idxs):
            kpts[i], descs[i] = ks[j], ds[j]
    return kpts, descs


def _pad(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[: len(arr)] = arr
    return out


def to_device(imgs: List[np.ndarray]) -> jnp.ndarray:
    """Upload the image list once as a device-resident uint8 stack.

    matching() and render.stitch() both accept this stack so the pipeline
    pays for the upload exactly once.
    """
    return jnp.asarray(np.stack(imgs))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _gray_extract(stack_u8: jnp.ndarray, cfg: S.SiftConfig):
    gray = bgr2gray(stack_u8.astype(jnp.float32) / 255.0)
    return S.sift_extract(gray, cfg)


@jax.jit
def _compact_buffers(kp_buf, ds_buf, sel, counts):
    """Gather the valid keypoint/descriptor rows to a smaller capacity."""
    kp_c = jnp.take_along_axis(kp_buf, sel[..., None], axis=1)
    ds_c = jnp.take_along_axis(ds_buf, sel[..., None], axis=1)
    va_c = jnp.arange(sel.shape[1])[None, :] < counts[:, None]
    return kp_c, ds_c, va_c


@functools.partial(jax.jit, static_argnames=("ccap",))
def _compact_buffers_dev(kp_buf, ds_buf, va_buf, counts, ccap: int):
    """Device-side compaction: valid rows first, ascending index order.

    Same selection the host loop builds from ``np.flatnonzero`` (stable
    argsort of ~valid lists valid indices ascending), but computed on
    device so the match dispatch does not have to wait for the packed
    keypoint blob to reach the host first. Rows past each image's count
    hold arbitrary (invalid-row) data; every consumer masks by ``va_c``.
    """
    sel = jnp.argsort(~va_buf, axis=1, stable=True)[:, :ccap]
    kp_c = jnp.take_along_axis(kp_buf, sel[..., None], axis=1)
    ds_c = jnp.take_along_axis(ds_buf, sel[..., None], axis=1)
    va_c = jnp.arange(ccap)[None, :] < counts[:, None]
    return kp_c, ds_c, va_c


@jax.jit
def _pack_kp_valid(kp_buf, va_buf):
    """Keypoints + validity as ONE f32 blob: one host sync instead of
    two (the match-graph stage needs both arrays on the host).
    """
    n = kp_buf.shape[0]
    return jnp.concatenate([kp_buf.reshape(n, -1),
                            va_buf.astype(jnp.float32)], axis=1)


@jax.jit
def _pack_match_results(res: pm.PairMatch) -> jnp.ndarray:
    """PairMatch tree -> ONE compressed int32 blob: one host sync for the
    whole match graph instead of one per leaf, laid out for minimum
    bytes:
    ``idx[:, :, 0]`` is always ``arange(M)`` (match_pair builds it that
    way) so only the best-match column travels, packed two int16 lanes
    per int32; the inlier mask travels as 32 bools per int32. Layout
    per pair row::

        [best_idx int16x2 (M/2) | inlier bits (M/32) | hom bits (9)
         | n_inliers | ok]

    = M/2 + M/32 + 11 int32 vs the naive 3M + 11 — 5.6x smaller
    (49 -> 8.7 KB per pair at M=4096). Homography f32s travel as bitcast int32 so the
    readback is exact. Requires M % 32 == 0 and M < 2^15 (the
    compacted capacity is a power of two >= 64 well under 32768).
    """
    p, m = res.idx.shape[:2]
    best = res.idx[:, :, 1].astype(jnp.int32)              # (P, M)
    best16 = best[:, 0::2] | (best[:, 1::2] << 16)         # (P, M/2)
    bits = res.inlier.astype(jnp.int32).reshape(p, m // 32, 32)
    shifts = jnp.arange(32, dtype=jnp.int32)[None, None, :]
    # distinct powers of two: int32 wraparound reproduces the bit
    # pattern exactly (bit 31 lands as the sign bit)
    inl32 = jnp.sum(bits << shifts, axis=-1)               # (P, M/32)
    hom_bits = jax.lax.bitcast_convert_type(
        res.hom.astype(jnp.float32), jnp.int32).reshape(p, 9)
    return jnp.concatenate([
        best16,
        inl32,
        hom_bits,
        res.n_inliers.reshape(p, 1).astype(jnp.int32),
        res.ok.reshape(p, 1).astype(jnp.int32),
        # final cast: under x64 some int ops promote to int64; every
        # value is an int32 bit pattern, so the wraparound cast is exact
    ], axis=1).astype(jnp.int32)


def _unpack_match_results(blob: np.ndarray, m: int) -> "pm.PairMatch":
    """Host-side inverse of ``_pack_match_results`` (numpy views)."""
    p = blob.shape[0]
    u = blob[:, : m // 2].view(np.uint32)
    best = np.empty((p, m), np.int32)
    best[:, 0::2] = (u & 0xFFFF).astype(np.int32)
    best[:, 1::2] = (u >> 16).astype(np.int32)
    idx = np.stack([np.broadcast_to(np.arange(m, dtype=np.int32), (p, m)),
                    best], axis=-1)
    inl32 = blob[:, m // 2: m // 2 + m // 32].view(np.uint32)
    inlier = ((inl32[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
              ).astype(bool).reshape(p, m)
    off = m // 2 + m // 32
    hom = blob[:, off: off + 9].copy().view(np.float32).reshape(-1, 3, 3)
    n_inl = blob[:, off + 9]
    ok = blob[:, off + 10].astype(bool)
    return pm.PairMatch(idx=idx, inlier=inlier, hom=hom,
                        n_inliers=n_inl, ok=ok)


class BucketStacks:
    """Per-shape-bucket device image stacks (mixed-size inputs).

    One device array cannot hold mixed shapes; this keeps one uint8 stack
    per (H, W) bucket so the pixels are uploaded exactly once —
    ``render.stitch`` consumes it by zero-padding each bucket to the max
    shape ON DEVICE instead of re-uploading a host-padded stack.
    """

    def __init__(self, parts):
        self.parts = parts      # list of (image indices, (B, h, w, 3) u8)
        self.n = sum(len(idxs) for idxs, _ in parts)

    def to_padded(self, h: int, w: int) -> jnp.ndarray:
        """(N, h, w, 3) uint8 device stack, zero-padded, original order."""
        rows, order = [], []
        for idxs, stack in self.parts:
            bh, bw = stack.shape[1:3]
            rows.append(jnp.pad(stack, ((0, 0), (0, h - bh), (0, w - bw),
                                        (0, 0))))
            order.extend(idxs)
        inv = np.argsort(np.asarray(order))
        return jnp.concatenate(rows, axis=0)[inv]


def upload_extract(imgs: List[np.ndarray], max_kpts: int = 4096,
                   n_batches: int = 4, devices=None):
    """Pipelined upload + SIFT extraction.

    The uint8 BGR stack is uploaded in batches interleaved with the
    per-batch gray-conversion+SIFT dispatches, so the transfer of batch
    k+1 rides under the compute of batch k; the same device-resident
    batches are concatenated into the render-time stack, so the pixels
    are uploaded exactly once (color, converted to gray on device).
    Returns ``(stack (N, H, W, 3) uint8 device,
    SiftFeatures batched over all N)``; the list is padded to a multiple
    of the batch size by repeating the last image (one XLA compile) and
    the padding is sliced off on device.

    Mixed image shapes are handled by processing each shape bucket
    through the same pipeline; the returned stack is then a
    ``BucketStacks`` (pixels still uploaded exactly once —
    render.stitch pads per bucket on device).

    ``devices``: optional device list (a mesh's devices). Batch k then
    runs on ``devices[k % len(devices)]`` — the same compiled program on
    every device, so the features are bit-identical to the one-device
    run — and the results are gathered on ``devices[0]``.
    """
    n = len(imgs)
    cfg = S.SiftConfig(max_kpts=max_kpts)
    buckets = _shape_buckets(imgs)
    if len(buckets) != 1:
        feat_parts, order, parts = [], [], []
        for shape, idxs in buckets.items():
            st, f = upload_extract([imgs[i] for i in idxs], max_kpts,
                                   n_batches, devices)
            feat_parts.append(f)
            order.extend(idxs)
            parts.append((idxs, st))
        inv = np.argsort(np.asarray(order))
        feats = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0)[inv], *feat_parts)
        return BucketStacks(parts), feats
    # FIXED batch size (not count): the SIFT program is keyed by the
    # batch shape, so a fixed (4, H, W, 3) is one compile for every image
    # count at a given resolution (ceil(n/4) was a fresh compile per
    # distinct n). The tail batch repeats the last image.
    bs = max(1, min(4, n))
    n_batches = -(-n // bs)
    padded = list(imgs) + [imgs[-1]] * (n_batches * bs - n)

    devs = devices or [None]
    chunks, feat_batches = [], []
    for b in range(n_batches):
        cb = jax.device_put(np.stack(padded[b * bs:(b + 1) * bs]),
                            devs[b % len(devs)])
        chunks.append(cb)
        feat_batches.append(_gray_extract(cb, cfg))
    if devices:
        chunks, feat_batches = jax.device_put((chunks, feat_batches),
                                              devs[0])

    stack = jnp.concatenate(chunks, axis=0)[:n]
    feats = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0)[:n], *feat_batches)
    return stack, feats


def matching(imgs: List[np.ndarray], detector: str = "sift",
             max_kpts: int = 4096, seed: int = 0,
             dev_images: Optional[jnp.ndarray] = None,
             feats: Optional[S.SiftFeatures] = None, mesh=None):
    """All-pairs feature matching (features.py:255-283 equivalent).

    Returns ``(kpts, matches)`` as numpy object arrays with the reference's
    exact structure (NPZ-cache compatible). The SIFT path is fully
    device-resident: one pipelined upload of the uint8 image stack
    overlapped with extraction (``upload_extract``), then the match graph
    in fixed-size pair chunks with one host sync. ``feats``: optional
    precomputed ``SiftFeatures`` (from ``upload_extract``) to skip
    extraction.
    ``mesh``: optional ``jax.sharding.Mesh`` — extraction batches and
    match-pair chunks go to its devices in turn (the production
    scale-out path, features.py:271-279's loop). Each batch and chunk
    runs the same compiled program as without a mesh, so features and
    the match graph are bit-identical to the one-device run.
    """
    if not imgs:
        raise ValueError("no images to process (empty directory?)")
    n = len(imgs)
    devices = list(mesh.devices.flat) if mesh is not None else None
    start = time.time()

    if detector == "msop":
        if mesh is None and len(_shape_buckets(imgs)) == 1:
            # device-resident fast path: descriptors never leave the
            # device (see the msop_extract_device docstring)
            from pano360.features.msop import msop_extract_device
            kpts_full, kp_dev, ds_dev, va_dev, counts = \
                msop_extract_device(imgs)
            h0, w0 = imgs[0].shape[:2]
            cent = np.array([w0 / 2, h0 / 2], np.float32)
            kpts_host = [k - cent for k in kpts_full]
            # valid-first compaction aligns the device rows with the
            # level-major host keypoint list (match indices index it)
            cmax = int(counts.max()) if len(counts) else 0
            cap = min(max(64, 1 << max(cmax - 1, 0).bit_length()),
                      int(kp_dev.shape[1]))
            kp_buf, ds_buf, va_buf = _compact_buffers_dev(
                kp_dev - jnp.asarray(cent), ds_dev, va_dev,
                jnp.asarray(counts), cap)
        else:
            kpts, descs = detect_all(imgs, detector, max_kpts, mesh=mesh)
            cap = max((len(k) for k in kpts), default=1)
            cap = max(1 << (cap - 1).bit_length(), 64)
            kp_buf = jnp.asarray(np.stack([_pad(k, cap) for k in kpts]))
            ds_buf = jnp.asarray(np.stack([_pad(d, cap) for d in descs]))
            va_buf = jnp.asarray(np.stack([np.arange(cap) < len(k)
                                           for k in kpts]))
            kpts_host = kpts
        LOG.info("Extracted keypoints, time: %s", time.time() - start)
        remap = None
        kv_dev = None
    else:
        if feats is None:
            cfg = S.SiftConfig(max_kpts=max_kpts)
            if (mesh is None and dev_images is not None
                    and hasattr(dev_images, "shape")):
                feats = _gray_extract(dev_images, cfg)
            else:
                _, feats = upload_extract(imgs, max_kpts, devices=devices)
        # per-image centers: keypoints are center-relative in the cache
        # format, and shapes may differ across images
        cents = jnp.asarray([[im.shape[1] / 2, im.shape[0] / 2]
                             for im in imgs], jnp.float32)
        kp_buf = feats.xy - cents[:, None, :]
        ds_buf = S.root_sift(feats.desc)
        va_buf = feats.valid
        cap0 = cap = int(feats.xy.shape[1])

        # enqueue the packed host copy of keypoints+validity (the cache
        # needs it), but defer the blocking pull until AFTER the match
        # dispatch is enqueued: the blob transfer then rides under the
        # match compute instead of gating it. Compaction is decided from
        # ONE scalar pull (max count) and performed on device.
        kv_dev = _pack_kp_valid(kp_buf, va_buf)
        counts_dev = jnp.sum(va_buf.astype(jnp.int32), axis=1)
        cmax = int(jnp.max(counts_dev))

        # compact the padded buffers to the max valid count: matching cost
        # scales with cap^2 (distance matrices), so unfilled capacity is
        # pure waste; compaction also makes match indices directly index
        # the compacted per-image keypoint lists (the cache format)
        ccap = max(64, 1 << max(cmax - 1, 0).bit_length())
        if ccap < cap:
            kp_buf, ds_buf, va_buf = _compact_buffers_dev(
                kp_buf, ds_buf, va_buf, counts_dev, ccap)
            cap = ccap
        kpts_host = None   # pulled after the match dispatch
        remap = None
        LOG.info("Extracted keypoints, time: %s", time.time() - start)

    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    start = time.time()
    keys = jax.random.split(jax.random.key(seed), max(len(pairs), 1))

    # the pairs in chunks of ``batch`` (bounding the distance-matrix
    # memory), one dispatch each — on the mesh's devices in turn, where
    # every chunk runs the same compiled program as without a mesh — and
    # one host sync for the whole match graph
    batch = max(1, min(16, (1 << 28) // max(cap * cap * 4, 1)))
    pa = np.asarray([p[0] for p in pairs] or [0], np.int32)
    pb = np.asarray([p[1] for p in pairs] or [0], np.int32)
    devs = devices or [None]
    bufs, blobs = {}, []
    for c, lo in enumerate(range(0, len(pa), batch)):
        dev = devs[c % len(devs)]
        if dev not in bufs:
            bufs[dev] = (kp_buf, ds_buf, va_buf) if dev is None else \
                jax.device_put((kp_buf, ds_buf, va_buf), dev)
        sl = slice(lo, lo + batch)
        chunk = [pa[sl], pb[sl], keys[sl]]
        if dev is not None:
            chunk = jax.device_put(chunk, dev)
        res = pm.match_all_pairs(*bufs[dev], *chunk,
                                 batch_size=len(pa[sl]))
        blobs.append(_pack_match_results(res))
    if devices:
        blobs = jax.device_put(blobs, devs[0])
    blob_dev = jnp.concatenate(blobs, axis=0)
    if kv_dev is not None:
        # host copies for the cache: ONE packed pull, issued while the
        # match dispatch runs on device (pulling before the dispatch
        # would gate the matcher on the blob transfer)
        kv = np.asarray(kv_dev)
        kp_np = kv[:, : 2 * cap0].reshape(n, cap0, 2)
        valid_np = kv[:, 2 * cap0:] > 0.5
        kpts_host = [kp_np[i][valid_np[i]].astype(np.float32)
                     for i in range(n)]
        if cap == cap0:
            remap = np.cumsum(valid_np, axis=1) - 1    # pad->compact
    # the whole match graph comes back as ONE packed pull (one host sync
    # instead of one per leaf)
    res_np = _unpack_match_results(np.asarray(blob_dev), cap)

    matches: Dict[int, Dict[int, tuple]] = {i: {} for i in range(n)}
    for k, (src, dst) in enumerate(pairs):
        if not bool(res_np.ok[k]):
            continue
        idx = res_np.idx[k][res_np.inlier[k]].astype(np.int32)
        if remap is not None:   # padded-buffer indices -> compacted
            idx = np.stack([remap[src][idx[:, 0]],
                            remap[dst][idx[:, 1]]], axis=1).astype(np.int32)
        hom = res_np.hom[k].astype(np.float64)
        matches[src][dst] = (idx, hom)
        matches[dst][src] = (np.fliplr(idx), np.linalg.inv(hom))
    LOG.info("Matched features, time: %s", time.time() - start)
    kpts = kpts_host

    matches = {i: col for i, col in matches.items() if col}
    kpts_arr = np.empty(n, dtype=object)
    for i, k in enumerate(kpts):
        kpts_arr[i] = k
    matches_arr = np.array(matches, dtype=object)
    return kpts_arr, matches_arr


def idx_to_keypoints(matches, kpts):
    """Keypoint indices -> homogeneous coords + confidence
    (stitcher.py:372-387 equivalent, same output structure)."""
    def _i_to_k(match, kpt1, kpt2):
        return np.concatenate([kpt1[match[:, 0]], kpt2[match[:, 1]]], axis=1)

    kpts = [np.concatenate([kp, np.ones((kp.shape[0], 1))], axis=1)
            for kp in kpts]
    matches = matches.item() if isinstance(matches, np.ndarray) else matches
    return {i: {j: (_i_to_k(m, kpts[i], kpts[j]), h, len(m))
                for j, (m, h) in col.items()}
            for i, col in matches.items()}


__all__ = ["detect_all", "matching", "idx_to_keypoints", "to_device",
           "upload_extract", "BucketStacks"]
