"""Chip smoke test: the stitching pipeline end to end on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # one card: phases 1-4 below
    python chip_smoke.py --four    # four cards: the --mesh 4 path only

Phases on one card:

1. device    JAX's first device must be a GPU (no CPU fallback). Prints
             the card's name and power limit (nvidia-smi), the device kind,
             the JAX version and the XLA flags.
2. flagship  the benchmark dataset (``synth.bench_dataset``: 15 views of
             864 x 1152) through ``cli.main`` with a fresh cache directory,
             checked against the synthetic ground truth; the same cameras
             rendered on JAX's CPU backend give the expected mosaic; then a
             warm run's per-stage wall times and peak device memory.
3. cli       other CLI paths at 6 views of 480 x 640: every view placed.
4. numerics  SIFT at full width, pair matching and the whole pipeline
             against the same code on JAX's CPU backend (the plain
             reference here), each with its stated tolerance.

With ``--four``: the flagship through ``cli.main --mesh 4`` and the same
run on one card; the mosaics must agree to >= 50 dB with identical
placement.

Every phase runs even when an earlier one failed, so one run reports every
number. The last line of stdout is one JSON object, printed only when every
phase passed; otherwise the exit code is 1.
"""
import argparse
import contextlib
import glob
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pano360 import cli, render, synth  # noqa: E402
from pano360 import match as pm  # noqa: E402
from pano360.features import sift as S  # noqa: E402
from pano360.imageio import imread  # noqa: E402
from pano360.pipeline import _gray_extract  # noqa: E402
from pano360.profiling import StageTimer  # noqa: E402

# Registration bars against the synthetic ground truth: the same bars as
# tests/test_e2e.py (focal within 3%, every placed edge within 0.5 deg).
FOCAL_REL_ERR = 0.03
ROT_ERR_DEG = 0.5

# GPU vs CPU bars. Positions, refinement and matching run in f32 with
# every geometric product pinned to HIGHEST, so keypoints agree up to
# f32 rounding (fused multiply-adds in another order) and rare threshold
# flips. The orientation histogram, descriptor sampling and trilinear
# binning products run at Precision.DEFAULT: TF32 on the H100 (10-bit
# mantissa, relative rounding 2^-11 on each input), full f32 on the CPU,
# so descriptors differ by ~1e-3 relative and orientation peaks near the
# 0.8*max duplicate threshold can flip.
SIFT_COUNT_REL = 0.02        # keypoint count
SIFT_POS_SHARE = 0.95        # GPU keypoints within 0.5 px of a CPU one
SIFT_DESC_COS_MEDIAN = 0.999  # descriptor cosine on matched keypoints
SIFT_DESC_COS_P5 = 0.98
MATCH_INLIER_REL = 0.02      # same inputs: only f32 rounding differs
# homography: image-corner displacement. Every product of the match and
# the refit runs at HIGHEST, so only f32 rounding in another order
# differs; the corners lie outside the inlier hull, where a refit
# difference grows, hence half a pixel rather than a rounding bar.
MATCH_CORNER_PX = 0.5
RENDER_PSNR_DB = 45.0        # same cameras rendered on GPU and CPU
PIPE_PSNR_DB = 30.0          # whole pipeline: TF32 descriptors move the
PIPE_ROT_DEG = 0.1           # registration by a fraction of a pixel
PIPE_FOCAL_REL = 0.01
MESH_PSNR_DB = 50.0          # pano360/parallel/dryrun.py's bar

# Which precision each matrix product of the main path runs at on the
# H100 (float32 operands; DEFAULT lets XLA use TF32).
PRODUCTS = {
    "sift orientation histogram (sift.py _orientation_from_patch)":
        "DEFAULT -> TF32",
    "sift descriptor sampling GEMMs (sift.py _descriptor_from_patch)":
        "DEFAULT -> TF32",
    "sift trilinear binning einsums (sift.py _trilinear_hist)":
        "DEFAULT -> TF32",
    "sift subpixel offset solve, 3x3 (sift.py _refine_one)":
        "DEFAULT -> TF32",
    "match distances, DLT, refit residuals and normal equations "
    "(match._HIGHEST)": "HIGHEST -> f32",
    "geometry.mm and every geometry product": "HIGHEST -> f32",
    "bundle-adjustment normal equations (register.py _lm_stats)":
        "HIGHEST -> f32",
    "render projection ranges and backward warp einsums": "HIGHEST -> f32",
}

FLAGSHIP_ARGS = ["-s", "1", "--ba", "incr", "-b", "multiband"]
# 60% overlap: the focal is the median over ALL pair homographies (the
# reference's rule), and at 50% only 5 of the 15 pairs overlap, so MSOP's
# spurious pairs decide it (on the CPU 3 of 6 RANSAC seeds fail at 50%
# and 0 of 6 at 60%; ROADMAP B6)
SMALL = dict(n_views=6, shape=(480, 640), overlap=0.6, seed=7)
CLI_PATHS = {
    "default": [],
    "msop": ["--detector", "msop"],
    "equalize_crop_linear": ["-e", "-c", "-b", "linear"],
    "cylindrical": ["--projection", "cylindrical"],
    "blend_none": ["-b", "none"],
}


class PhaseError(AssertionError):
    """A phase's check failed."""


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------

def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of every card, from a child
    process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "\n".join(ln.strip() for ln in out.splitlines() if ln.strip())


def require_gpu(devices, count: int = 1):
    """The device dict of the JSON line; exits unless ``devices`` holds at
    least ``count`` GPUs."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {platform}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found "
                         f"{len(devices)}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": count}


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


@contextlib.contextmanager
def on_cpu():
    """Run the enclosed JAX work on JAX's CPU backend."""
    with jax.default_device(jax.devices("cpu")[0]):
        yield


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def write_views(root: str, imgs) -> str:
    """uint8 BGR views -> ``<root>/views/*.ppm``."""
    ds = os.path.join(root, "views")
    synth.write_dataset(ds, [im.astype(np.float32) / 255.0 for im in imgs])
    return ds


def run_cli(ds: str, flags, workdir: str, tag: str, timer=None,
            extra=()):
    """``cli.main`` with a fresh, empty cache directory (a stale match or
    BA cache would skip matching and registration). Returns
    ``(mosaic, regions)``."""
    cache = tempfile.mkdtemp(prefix=f"cache_{tag}_", dir=workdir)
    out = os.path.join(workdir, f"mosaic_{tag}.ppm")
    mosaic = cli.main([ds, *flags, "--cache-dir", cache, "-o", out,
                       *extra], timer=timer)
    check(np.array_equal(imread(out), mosaic), f"{tag}: saved mosaic "
          "differs from the returned one")
    shrink = cli.build_parser().parse_args([ds, *flags]).shrink
    name = f"{os.path.basename(os.path.normpath(ds))}_s{shrink}"
    with open(os.path.join(cache, f"ba_{name}.pkl"), "rb") as fid:
        regions = pickle.load(fid)
    return mosaic, regions


def view_index(regions, imgs):
    """Dataset index of each placed region (by its pixels)."""
    idx = []
    for r in regions:
        hits = [i for i, im in enumerate(imgs) if np.array_equal(r.img, im)]
        idx.append(hits[0] if hits else -1)
    return idx


def rot_angle_deg(rot):
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(rot) - 1) / 2, -1.0, 1.0))))


def registration_errors(regions, imgs, rots, focal):
    """Placed count, focal relative error and the max relative-rotation
    error over every pair of consecutive placed views."""
    idx = view_index(regions, imgs)
    by_view = dict(zip(idx, regions))
    f_err = max(abs(r.intr[0, 0] - focal) / focal for r in regions)
    rot_err = 0.0
    for i in range(len(imgs) - 1):
        if i in by_view and i + 1 in by_view:
            est = by_view[i + 1].rot @ by_view[i].rot.T
            true = rots[i + 1] @ rots[i].T
            rot_err = max(rot_err, rot_angle_deg(est @ true.T))
    return len(regions), float(f_err), rot_err, idx


def psnr(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def run_difference(m_a, r_a, m_b, r_b) -> str:
    """How far two runs of the same views part: max rotation-entry and
    relative focal difference (regions in order) and mosaic PSNR."""
    rot = max((float(np.abs(a.rot - b.rot).max()) for a, b in zip(r_a, r_b)),
              default=np.inf)
    foc = max((abs(a.intr[0, 0] - b.intr[0, 0]) / b.intr[0, 0]
               for a, b in zip(r_a, r_b)), default=np.inf)
    db = psnr(m_a, m_b) if m_a.shape == m_b.shape else 0.0
    return (f"placed {len(r_a)}/{len(r_b)}, max |dR| {rot:.2e}, focal rel "
            f"diff {foc:.2e}, PSNR {db:.2f} dB")


def registration_agreement(reg_a, reg_b, imgs):
    """Max rotation difference (deg) and focal relative difference between
    two registrations of the same views (matched by pixels)."""
    a = dict(zip(view_index(reg_a, imgs), reg_a))
    b = dict(zip(view_index(reg_b, imgs), reg_b))
    check(sorted(a) == sorted(b), f"placed views differ: {sorted(a)} vs "
          f"{sorted(b)}")
    rot = max(rot_angle_deg(a[k].rot @ b[k].rot.T) for k in a)
    foc = max(abs(a[k].intr[0, 0] - b[k].intr[0, 0]) / b[k].intr[0, 0]
              for k in a)
    return rot, float(foc)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(label: str):
    dev = jax.devices()[0]
    log(label)
    log(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', '')!r}")
    return {"device_kind": dev.device_kind, "jax": jax.__version__}


def phase_flagship(workdir: str, label: str, data=None):
    """The flagship through ``cli.main``: registration vs ground truth,
    the CPU render of the same cameras, then a warm timed run."""
    imgs, rots, focal = data or synth.bench_dataset()
    ds = write_views(workdir, imgs)
    t0 = time.time()
    mosaic, regions = run_cli(ds, FLAGSHIP_ARGS, workdir, "flagship")
    cold = time.time() - t0
    placed, f_err, rot_err, _ = registration_errors(regions, imgs, rots,
                                                    focal)
    log(f"flagship: {len(imgs)} views of {imgs[0].shape[:2]}, placed "
        f"{placed}, focal rel err {f_err:.5f} (bar {FOCAL_REL_ERR}), max "
        f"edge rotation err {rot_err:.5f} deg (bar {ROT_ERR_DEG}), mosaic "
        f"{mosaic.shape}, cold run {cold:.3f}s")

    with on_cpu():
        m_cpu = render.stitch(regions, blender="multiband")
    render_db = psnr(mosaic, m_cpu) if m_cpu.shape == mosaic.shape else 0.0
    log(f"flagship render of the same cameras on CPU: mosaic "
        f"{m_cpu.shape}, PSNR vs GPU {render_db:.2f} dB "
        f"(bar {RENDER_PSNR_DB})")

    timer = StageTimer()
    t0 = time.time()
    m_warm, r_warm = run_cli(ds, FLAGSHIP_ARGS, workdir, "flagship_warm",
                             timer=timer)
    warm = time.time() - t0
    peak = peak_bytes(jax.devices()[0])
    log(f"flagship warm stage times [{label.splitlines()[0]}]:")
    for name, sec in timer.stages.items():
        log(f"  {name}: {sec:.4f}s")
    log(f"  total (cli.main): {warm:.4f}s; peak_bytes_in_use {peak}")
    log(f"flagship warm vs cold run (same card, same program): "
        f"{run_difference(m_warm, r_warm, mosaic, regions)}")

    check(placed == len(imgs), f"placed {placed} of {len(imgs)} views")
    check(f_err < FOCAL_REL_ERR, f"focal error {f_err}")
    check(rot_err < ROT_ERR_DEG, f"rotation error {rot_err} deg")
    check(m_cpu.shape == mosaic.shape,
          f"mosaic {mosaic.shape} vs CPU render {m_cpu.shape}")
    check(render_db >= RENDER_PSNR_DB, f"render PSNR {render_db:.2f} dB")
    return {"placed": placed, "focal_rel_err": f_err,
            "rot_err_deg": rot_err, "mosaic": list(mosaic.shape),
            "render_psnr_db": render_db, "stages": dict(timer.stages),
            "warm_s": warm, "peak_bytes_in_use": peak}


def small_dataset():
    imgs, rots, focal = synth.make_views(**SMALL)
    return [(im * 255).astype(np.uint8) for im in imgs], rots, focal


def phase_cli(workdir: str, data=None, paths=CLI_PATHS):
    """Other CLI paths: each must place every view within the
    ground-truth bars."""
    imgs, rots, focal = data or small_dataset()
    ds = write_views(workdir, imgs)
    out, failed = {}, []
    for tag, flags in paths.items():
        try:
            mosaic, regions = run_cli(ds, ["-s", "1", *flags], workdir, tag)
        except (Exception, SystemExit) as exc:
            log(f"cli {tag} {flags}: FAILED {exc!r}")
            failed.append(tag)
            continue
        placed, f_err, rot_err, _ = registration_errors(regions, imgs,
                                                        rots, focal)
        out[tag] = {"placed": placed, "focal_rel_err": f_err,
                    "rot_err_deg": rot_err, "mosaic": list(mosaic.shape)}
        log(f"cli {tag} {flags}: placed {placed} of {len(imgs)}, focal "
            f"rel err {f_err:.5f}, max edge rotation err {rot_err:.5f} "
            f"deg, mosaic {mosaic.shape}")
        if (placed != len(imgs) or f_err >= FOCAL_REL_ERR
                or rot_err >= ROT_ERR_DEG):
            failed.append(tag)
    check(not failed, f"CLI paths failed: {failed}")
    return out


def _extract(stack_u8, cfg):
    f = _gray_extract(jnp.asarray(stack_u8), cfg)
    return jax.tree_util.tree_map(np.asarray, f)


def compare_sift(gpu, cpu):
    """Per-image keypoint counts, the share of GPU keypoints within 0.5 px
    of a CPU keypoint, and descriptor cosines on keypoints matched by
    position (then by closest angle)."""
    counts, shares, cosines = [], [], []
    for b in range(gpu.valid.shape[0]):
        vg, vc = gpu.valid[b], cpu.valid[b]
        xg, xc = gpu.xy[b][vg], cpu.xy[b][vc]
        ag, ac = gpu.angle[b][vg], cpu.angle[b][vc]
        dg, dc = gpu.desc[b][vg], cpu.desc[b][vc]
        counts.append((len(xg), len(xc)))
        if not len(xg) or not len(xc):
            shares.append(0.0)
            continue
        d2 = ((xg[:, None, :] - xc[None, :, :]) ** 2).sum(-1)
        near = d2 < 0.25
        shares.append(float(near.any(1).mean()))
        dang = np.abs(ag[:, None] - ac[None, :]) % (2 * np.pi)
        dang = np.where(near, np.minimum(dang, 2 * np.pi - dang), np.inf)
        for i in np.flatnonzero(near.any(1)):
            j = int(np.argmin(dang[i]))
            cosines.append(float((dg[i] * dc[j]).sum()))
    return counts, shares, np.asarray(cosines)


def corner_displacement(hom_a, hom_b, shape):
    """Max distance between where two homographies send the image
    corners (center-relative pixel coordinates)."""
    h, w = shape
    pts = np.array([[-w / 2, -h / 2, 1], [w / 2, -h / 2, 1],
                    [-w / 2, h / 2, 1], [w / 2, h / 2, 1]], np.float64)
    pa = pts @ np.asarray(hom_a, np.float64).T
    pb = pts @ np.asarray(hom_b, np.float64).T
    pa = pa[:, :2] / pa[:, 2:]
    pb = pb[:, :2] / pb[:, 2:]
    return float(np.abs(pa - pb).max())


def phase_numerics(workdir: str, flagship=None, small=None,
                   cfg=S.SiftConfig(), pairs=((0, 1), (1, 2), (2, 3))):
    """SIFT, matching and the whole pipeline on the GPU against the same
    code on JAX's CPU backend."""
    for name, prec in PRODUCTS.items():
        log(f"precision: {name}: {prec}")
    errors = []

    # --- SIFT at full width: one 4-image batch -------------------------
    imgs = (flagship or synth.bench_dataset())[0][:4]
    stack = np.stack(imgs)
    gpu = _extract(stack, cfg)
    with on_cpu():
        cpu = _extract(stack, cfg)
    counts, shares, cos = compare_sift(gpu, cpu)
    med = float(np.median(cos)) if len(cos) else 0.0
    p5 = float(np.percentile(cos, 5)) if len(cos) else 0.0
    log(f"sift {stack.shape}: counts gpu/cpu {counts} (bar "
        f"{SIFT_COUNT_REL} rel), share within 0.5 px "
        f"{[round(s, 5) for s in shares]} (bar {SIFT_POS_SHARE}), "
        f"descriptor cosine median {med:.6f} (bar {SIFT_DESC_COS_MEDIAN}) "
        f"p5 {p5:.6f} (bar {SIFT_DESC_COS_P5}) over {len(cos)} keypoints")
    if any(abs(g - c) > SIFT_COUNT_REL * c for g, c in counts):
        errors.append(f"sift counts {counts}")
    if min(shares) < SIFT_POS_SHARE:
        errors.append(f"sift position share {shares}")
    if med < SIFT_DESC_COS_MEDIAN or p5 < SIFT_DESC_COS_P5:
        errors.append(f"sift descriptor cosine median {med} p5 {p5}")

    # --- matching: the same (CPU) features into match_pair on both -----
    h, w = stack.shape[1:3]
    cent = np.array([w / 2, h / 2], np.float32)
    desc = np.asarray(S.root_sift(jnp.asarray(cpu.desc)))
    res = {}
    for device in (jax.devices()[0], jax.devices("cpu")[0]):
        def put(x, device=device):
            return jax.device_put(x, device)
        res[device.platform] = [jax.tree_util.tree_map(np.asarray, pm.match_pair(
            put(cpu.xy[a] - cent), put(desc[a]), put(cpu.valid[a]),
            put(cpu.xy[b] - cent), put(desc[b]), put(cpu.valid[b]),
            put(jax.random.key(0)))) for a, b in pairs]
    dev_platform = jax.devices()[0].platform
    for (a, b), rg, rc in zip(pairs, res[dev_platform], res["cpu"]):
        ng, nc = int(rg.n_inliers), int(rc.n_inliers)
        disp = corner_displacement(rg.hom, rc.hom, (h, w))
        log(f"match {a}-{b}: inliers gpu {ng} cpu {nc} (bar "
            f"{MATCH_INLIER_REL} rel), ok {bool(rg.ok)}/{bool(rc.ok)}, "
            f"homography corner displacement {disp:.5f} px "
            f"(bar {MATCH_CORNER_PX})")
        if (abs(ng - nc) > MATCH_INLIER_REL * nc or disp > MATCH_CORNER_PX
                or bool(rg.ok) != bool(rc.ok)):
            errors.append(f"match {a}-{b}")

    # --- whole pipeline at the reduced size -----------------------------
    simgs, _, _ = small or small_dataset()
    ds = write_views(tempfile.mkdtemp(prefix="pipe_", dir=workdir), simgs)
    m_gpu, r_gpu = run_cli(ds, ["-s", "1"], workdir, "pipe_gpu")
    with on_cpu():
        m_cpu, r_cpu = run_cli(ds, ["-s", "1"], workdir, "pipe_cpu")
    rot, foc = registration_agreement(r_gpu, r_cpu, simgs)
    db = psnr(m_gpu, m_cpu) if m_gpu.shape == m_cpu.shape else 0.0
    log(f"pipeline {len(simgs)} x {simgs[0].shape[:2]}: placed gpu "
        f"{len(r_gpu)} cpu {len(r_cpu)}, rotation diff {rot:.5f} deg "
        f"(bar {PIPE_ROT_DEG}), focal rel diff {foc:.6f} (bar "
        f"{PIPE_FOCAL_REL}), mosaic gpu {m_gpu.shape} cpu {m_cpu.shape}, "
        f"PSNR {db:.2f} dB (bar {PIPE_PSNR_DB})")
    if (m_gpu.shape != m_cpu.shape or db < PIPE_PSNR_DB
            or rot > PIPE_ROT_DEG or foc > PIPE_FOCAL_REL):
        errors.append("whole pipeline")
    check(not errors, "; ".join(errors))
    return {"sift_counts": counts, "sift_pos_share": shares,
            "desc_cos_median": med, "desc_cos_p5": p5,
            "pipe_psnr_db": db, "pipe_rot_deg": rot, "pipe_focal": foc}


def match_graph_diff(workdir: str, tag_a: str, tag_b: str):
    """Where two runs' match caches part: the max keypoint difference
    and whether the match graphs are identical."""
    def load(tag):
        path, = glob.glob(os.path.join(workdir, f"cache_{tag}_*",
                                       "matches_*.npz"))
        arr = np.load(path, allow_pickle=True)
        return arr["kpts"], arr["matches"].item()

    (ka, ma), (kb, mb) = load(tag_a), load(tag_b)
    kp = max((float(np.abs(a - b).max()) if a.shape == b.shape and a.size
              else (0.0 if a.shape == b.shape else np.inf))
             for a, b in zip(ka, kb))
    same = set(ma) == set(mb) and all(
        set(ma[i]) == set(mb[i]) and all(
            np.array_equal(ma[i][j][0], mb[i][j][0]) for j in ma[i])
        for i in ma)
    return kp, same


def phase_mesh(workdir: str, n_devices: int = 4, data=None):
    """The flagship through ``cli.main --mesh N`` against one card."""
    imgs, _, _ = data or synth.bench_dataset()
    ds = write_views(workdir, imgs)
    m_mesh, r_mesh = run_cli(ds, FLAGSHIP_ARGS, workdir, "mesh",
                             extra=("--mesh", str(n_devices)))
    peaks = [peak_bytes(d) for d in jax.devices()[:n_devices]]
    m_one, r_one = run_cli(ds, FLAGSHIP_ARGS, workdir, "single")
    kp_diff, same_graph = match_graph_diff(workdir, "mesh", "single")
    log(f"mesh {n_devices}: max keypoint diff {kp_diff:.3e} px, match "
        f"graph identical {same_graph}")
    m_two, r_two = run_cli(ds, FLAGSHIP_ARGS, workdir, "single_again")
    log(f"one card, run twice: "
        f"{run_difference(m_two, r_two, m_one, r_one)}")
    db = psnr(m_mesh, m_one) if m_mesh.shape == m_one.shape else 0.0
    same_views = view_index(r_mesh, imgs) == view_index(r_one, imgs)
    rot_diff = max((float(np.abs(a.rot - b.rot).max())
                    for a, b in zip(r_mesh, r_one)), default=np.inf)
    foc_diff = max((abs(a.intr[0, 0] - b.intr[0, 0]) / b.intr[0, 0]
                    for a, b in zip(r_mesh, r_one)), default=np.inf)
    log(f"mesh {n_devices}: placed {len(r_mesh)} vs single {len(r_one)}, "
        f"same views in order {same_views}, max |dR| {rot_diff:.2e}, "
        f"focal rel diff {foc_diff:.2e}, mosaic {m_mesh.shape} vs "
        f"{m_one.shape}, PSNR {db:.2f} dB (bar {MESH_PSNR_DB})")
    log(f"mesh {n_devices}: peak_bytes_in_use per device "
        f"(after the mesh run) {peaks}")
    check(len(r_mesh) == len(r_one) == len(imgs) and same_views,
          "placement differs")
    check(kp_diff == 0.0 and same_graph, "features or match graph differ")
    # test_parallel's traverse parity bars: rotations 5e-5, focal 1e-4
    check(rot_diff <= 5e-5 and foc_diff <= 1e-4,
          f"registration differs: dR {rot_diff}, focal {foc_diff}")
    check(db >= MESH_PSNR_DB, f"mesh PSNR {db:.2f} dB")
    return {"psnr_db": db, "peak_bytes_in_use": peaks}


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def run_phases(phases):
    """Run every ``(name, fn)``; returns the names that failed."""
    failed = []
    for name, fn in phases:
        log(f"=== phase {name}")
        t0 = time.time()
        try:
            fn()
            log(f"=== phase {name}: ok ({time.time() - t0:.1f}s)")
        except Exception:  # every phase runs; the exit code reports it
            traceback.print_exc(file=sys.stdout)
            log(f"=== phase {name}: FAILED ({time.time() - t0:.1f}s)")
            failed.append(name)
    return failed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the --mesh 4 path on four GPUs")
    args = parser.parse_args(argv)
    count = 4 if args.four else 1
    device = require_gpu(jax.devices(), count)
    label = card_name_and_power()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        def sub(name):
            path = os.path.join(workdir, name)
            os.makedirs(path)
            return path

        if args.four:
            phases = [("device", lambda: phase_device(label)),
                      ("mesh4", lambda: phase_mesh(sub("mesh"), 4))]
        else:
            flagship = synth.bench_dataset()
            small = small_dataset()
            phases = [
                ("device", lambda: phase_device(label)),
                ("flagship", lambda: phase_flagship(sub("flagship"), label,
                                                    flagship)),
                ("cli", lambda: phase_cli(sub("cli"), small)),
                ("numerics", lambda: phase_numerics(sub("numerics"),
                                                    flagship, small)),
            ]
        failed = run_phases(phases)
    log(label)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
