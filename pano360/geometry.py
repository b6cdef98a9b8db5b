"""Core geometry: rotating-camera model, SO(3), projections, focal estimation.

Batched JAX re-design of the reference's L0 math layer
(``bundle_adj.py:18-124``, ``stitcher.py:73-157`` in Banus/pano360): every
function here is pure ``jnp``, dtype-polymorphic, and written to be
``vmap``-ed over batches of cameras / points, so the registration and render
layers can fuse the whole geometry path into single XLA programs.

The camera model is a rotating pinhole camera: world rays relate to pixel
coordinates (centered on the principal point) by ``x_pix ~ K @ R @ ray`` where
``K`` is the intrinsic matrix and ``R`` the rotation.  Matching the reference:

- ``cam_hom``:  pixel -> world-ray homography ``R^T K^-1``  (bundle_adj.py:27-29)
- ``cam_proj``: world-ray -> pixel projection ``K R``        (bundle_adj.py:31-33)
- ``hom_to_from(c1, c2)``: homography that maps pixels of camera 2 into
  camera 1: ``K1 R1 R2^T K2^-1``                             (bundle_adj.py:36-38)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

# Geometry math is tiny (3x3s) but precision-critical: a reduced-precision
# f32 matmul (TF32 on the GPU, the XLA default there) turns e.g. focal
# self-calibration into a percent-level error. Pin every product here to
# full-f32 precision — the cost is negligible at these shapes.
PRECISION = jax.lax.Precision.HIGHEST


def mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full-precision (batched) matrix product for geometry-path math."""
    return jnp.matmul(a, b, precision=PRECISION)


def det3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 determinant (no LU custom call)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse via the adjugate.

    Avoids the LU-decomposition path of ``jnp.linalg.inv`` — exact scalar
    elementwise arithmetic, batchable, and free of matmul precision
    modes.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + d * co01 + g * co02
    adj = jnp.stack([
        jnp.stack([co00, co01, co02], axis=-1),
        jnp.stack([co10, co11, co12], axis=-1),
        jnp.stack([co20, co21, co22], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


# ---------------------------------------------------------------------------
# Camera pytree
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Batched rotating-camera parameters as a JAX pytree.

    ``rot``:  (..., 3, 3) rotation matrices.
    ``intr``: (..., 3, 3) intrinsic matrices.
    The image payload deliberately lives *outside* the pytree (host side) so
    device math never carries the pixels around.
    """

    rot: jnp.ndarray
    intr: jnp.ndarray

    def hom(self) -> jnp.ndarray:
        """Pixel -> world-ray homography ``R^T K^-1`` (bundle_adj.py:27-29)."""
        return cam_hom(self.rot, self.intr)

    def proj(self) -> jnp.ndarray:
        """World-ray -> pixel projection ``K R`` (bundle_adj.py:31-33)."""
        return cam_proj(self.rot, self.intr)


def cam_hom(rot: jnp.ndarray, intr: jnp.ndarray) -> jnp.ndarray:
    """Pixel -> world-ray homography ``R^T K^-1``."""
    return mm(jnp.swapaxes(rot, -1, -2), inv3x3(intr))


def cam_proj(rot: jnp.ndarray, intr: jnp.ndarray) -> jnp.ndarray:
    """World-ray -> pixel projection ``K R``."""
    return mm(intr, rot)


def hom_to_from(cam1: Camera, cam2: Camera) -> jnp.ndarray:
    """Homography mapping pixels of ``cam2`` into ``cam1`` (bundle_adj.py:36-38)."""
    return mm(cam_proj(cam1.rot, cam1.intr), cam_hom(cam2.rot, cam2.intr))


def intrinsics(focal, center=(0.0, 0.0), dtype=None) -> jnp.ndarray:
    """Intrinsic matrix from a (scalar) focal and principal point.

    Mirrors ``bundle_adj.py:82-87`` (square pixels, zero skew).  Accepts
    batched ``focal``/``center`` and broadcasts.
    """
    focal = jnp.asarray(focal, dtype=dtype)
    cx = jnp.asarray(center[0], dtype=focal.dtype)
    cy = jnp.asarray(center[1], dtype=focal.dtype)
    z = jnp.zeros_like(focal)
    o = jnp.ones_like(focal)
    rows = jnp.stack([
        jnp.stack([focal, z, cx * o], axis=-1),
        jnp.stack([z, focal, cy * o], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ], axis=-2)
    return rows


# ---------------------------------------------------------------------------
# SO(3): exponential map and friends
# ---------------------------------------------------------------------------

def cross_mat(vec: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric cross-product matrix; batched (bundle_adj.py:90-93)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def exp_so3(rad: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle vector -> rotation matrix (bundle_adj.py:96-101).

    Uses the sinc form ``I + a K + b K^2`` with the *unnormalized* cross
    matrix K and Taylor guards near zero, so it is exact at the origin AND
    differentiable there (the bundle adjuster linearizes at the identity-
    rotation seed camera; a normalize-then-select form propagates NaNs
    through ``jacfwd``).
    """
    t2 = jnp.sum(rad * rad, axis=-1)[..., None, None]
    small = t2 < 1e-12
    t = jnp.sqrt(jnp.where(small, 1.0, t2))
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / t)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / t2)
    cross = cross_mat(rad)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rad.dtype), cross.shape)
    return eye + a * cross + b * mm(cross, cross)


def log_so3(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle vector (bundle_adj.py:104-115).

    Uses the same (antisymmetric-part, arccos-trace) construction as the
    reference, including the small-angle cutoff at ``|v| < 1e-7``.
    """
    rad = jnp.stack([
        rot[..., 2, 1] - rot[..., 1, 2],
        rot[..., 0, 2] - rot[..., 2, 0],
        rot[..., 1, 0] - rot[..., 0, 1],
    ], axis=-1)
    mod = jnp.linalg.norm(rad, axis=-1, keepdims=True)
    tr = jnp.trace(rot, axis1=-2, axis2=-1)[..., None]
    theta = jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    safe = jnp.where(mod < 1e-7, 1.0, mod)
    return jnp.where(mod < 1e-7, jnp.zeros_like(rad), rad * theta / safe)


def nearest_rotation(mat: jnp.ndarray) -> jnp.ndarray:
    """Closest rotation in Frobenius norm via SVD (bundle_adj.py:118-124)."""
    uu, _, vt = jnp.linalg.svd(mat)
    rot = mm(uu, vt)
    det = det3x3(rot)
    return rot * jnp.sign(det)[..., None, None]


# ---------------------------------------------------------------------------
# Spherical / cylindrical projections
# ---------------------------------------------------------------------------

class SphProj:
    """Forward/backward spherical projection (stitcher.py:73-87), batched."""

    @staticmethod
    def hom2proj(pts: jnp.ndarray) -> jnp.ndarray:
        hypot = jnp.sqrt(pts[..., 0] ** 2 + pts[..., 2] ** 2)
        return jnp.stack([
            jnp.arctan2(pts[..., 0], pts[..., 2]),
            jnp.arctan2(pts[..., 1], hypot),
        ], axis=-1)

    @staticmethod
    def proj2hom(pts: jnp.ndarray) -> jnp.ndarray:
        return jnp.stack([
            jnp.sin(pts[..., 0]),
            jnp.tan(pts[..., 1]),
            jnp.cos(pts[..., 0]),
        ], axis=-1)


class CylProj:
    """Forward/backward cylindrical projection (stitcher.py:90-104), batched."""

    @staticmethod
    def hom2proj(pts: jnp.ndarray) -> jnp.ndarray:
        hypot = jnp.sqrt(pts[..., 0] ** 2 + pts[..., 2] ** 2)
        return jnp.stack([
            jnp.arctan2(pts[..., 0], pts[..., 2]),
            pts[..., 1] / hypot,
        ], axis=-1)

    @staticmethod
    def proj2hom(pts: jnp.ndarray) -> jnp.ndarray:
        return jnp.stack([
            jnp.sin(pts[..., 0]),
            pts[..., 1],
            jnp.cos(pts[..., 0]),
        ], axis=-1)


PROJECTIONS = {"spherical": SphProj, "cylindrical": CylProj}


# ---------------------------------------------------------------------------
# Focal self-calibration (Szeliski-Shum decomposition)
# ---------------------------------------------------------------------------

def _focal_from_two(v1, v2, d1, d2):
    """Pick a focal from two squared estimates (bundle_adj.py:41-49), branchless."""
    swap = v1 < v2
    hi = jnp.where(swap, v2, v1)
    lo = jnp.where(swap, v1, v2)
    both = jnp.where(jnp.abs(d1) > jnp.abs(d2), hi, lo)
    f_both = jnp.sqrt(jnp.where(both > 0, both, 1.0))
    f_hi = jnp.sqrt(jnp.where(hi > 0, hi, 1.0))
    return jnp.where(
        (hi > 0) & (lo > 0), f_both,
        jnp.where(hi > 0, f_hi, jnp.zeros_like(f_hi)))


def _focal_one_side(hom: jnp.ndarray) -> jnp.ndarray:
    """Focal estimate from one homography orientation (bundle_adj.py:52-66)."""
    h = hom.reshape(hom.shape[:-2] + (9,))
    d1 = h[..., 6] * h[..., 7]
    d2 = (h[..., 7] - h[..., 6]) * (h[..., 7] + h[..., 6])
    v1 = -(h[..., 0] * h[..., 1] + h[..., 3] * h[..., 4]) / d1
    v2 = (h[..., 0] ** 2 + h[..., 3] ** 2
          - h[..., 1] ** 2 - h[..., 4] ** 2) / d2
    f1 = _focal_from_two(v1, v2, d1, d2)

    d1b = h[..., 0] * h[..., 3] + h[..., 1] * h[..., 4]
    d2b = h[..., 0] ** 2 + h[..., 1] ** 2 - h[..., 3] ** 2 - h[..., 4] ** 2
    v1b = -h[..., 2] * h[..., 5] / d1b
    v2b = (h[..., 5] ** 2 - h[..., 2] ** 2) / d2b
    f0 = _focal_from_two(v1b, v2b, d1b, d2b)

    return jnp.sqrt(f0 * f1)


def focal_from_hom(hom: jnp.ndarray) -> jnp.ndarray:
    """Estimate focal length from a homography (bundle_adj.py:69-79).

    Tries the homography, then its inverse if the first estimate is zero.
    Fully batched / jittable (both sides evaluated, branchless select).
    """
    f_fwd = _focal_one_side(hom)
    f_inv = _focal_one_side(inv3x3(hom))
    return jnp.where(f_fwd > 0, f_fwd, f_inv)


# ---------------------------------------------------------------------------
# Camera <-> parameter-vector packing (for bundle adjustment)
# ---------------------------------------------------------------------------

PARAMS_PER_CAMERA = 6  # (focal, ppx, ppy, rx, ry, rz), bundle_adj.py:9


def params_to_camera(params: jnp.ndarray) -> Camera:
    """6-vector(s) -> Camera (bundle_adj.py:131-135); batched over leading dims."""
    foc = params[..., 0]
    intr = intrinsics(foc, (params[..., 1], params[..., 2]))
    return Camera(rot=exp_so3(params[..., 3:6]), intr=intr)


def camera_to_params(cam: Camera) -> jnp.ndarray:
    """Camera -> 6-vector(s) (bundle_adj.py:138-142)."""
    intr, rot = cam.intr, cam.rot
    lead = jnp.stack([intr[..., 0, 0], intr[..., 0, 2], intr[..., 1, 2]],
                     axis=-1)
    return jnp.concatenate([lead, log_so3(rot)], axis=-1)


# ---------------------------------------------------------------------------
# Straightening
# ---------------------------------------------------------------------------

def straighten(rots: jnp.ndarray) -> jnp.ndarray:
    """Global rotation putting all camera x-axes on a common plane.

    Re-derivation of ``bundle_adj.py:398-414``: SVD of the covariance of the
    camera x-axes gives the normal of their common plane (the up vector); the
    summed z-axes anchor the yaw; a sign fix keeps the vertical pointing up.
    ``rots``: (N, 3, 3) stacked rotations -> (N, 3, 3) straightened rotations.
    """
    xs = rots[:, 0, :]                     # camera x-axes, (N, 3)
    cov = jnp.cov(xs.T)
    _, _, vt = jnp.linalg.svd(cov)
    v_y = vt[2]
    v_z = jnp.sum(rots[:, 2, :], axis=0)
    v_x = jnp.cross(v_y, v_z)
    v_x = v_x / jnp.linalg.norm(v_x)
    v_z = jnp.cross(v_x, v_y)

    sign = jnp.sum(xs * v_x)
    flip = jnp.where(sign < 0, -1.0, 1.0).astype(rots.dtype)
    rot_g = jnp.stack([v_x * flip, v_y * flip, v_z], axis=-1)
    return mm(rots, rot_g)


__all__ = [
    "Camera", "cam_hom", "cam_proj", "hom_to_from", "intrinsics",
    "cross_mat", "exp_so3", "log_so3", "nearest_rotation",
    "SphProj", "CylProj", "PROJECTIONS",
    "focal_from_hom", "PARAMS_PER_CAMERA",
    "params_to_camera", "camera_to_params", "straighten",
]
