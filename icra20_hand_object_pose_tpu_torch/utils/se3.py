"""SE(3) / SO(3) math core (counterpart of the JAX package's utils/se3.py).

Conventions (unchanged):
  - Rotations: 3x3 matrices acting on column vectors x' = R @ x.
  - Quaternions: wxyz order, unit norm.
  - Poses: 4x4 homogeneous matrices, model -> camera.
  - Twists: 6-vectors [omega(3), v(3)], rotation first.

Plain functions on float32 tensors, batched over leading axes. Matrix
products run in true FP32 (the estimator turns TF32 off); the point
rotations are written out as nine multiply-adds, as in the reference.
"""
from __future__ import annotations

import math

import torch

from . import rng

_EPS = 1e-9


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # no constant made on the host: a CUDA graph cannot capture its copy
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (wxyz) -> 3x3 rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (wxyz), branch-free
    Shepperd-style extraction (largest pivot wins), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22  # 4w^2
    tx = 1.0 + m00 - m11 - m22  # 4x^2
    ty = 1.0 - m00 + m11 - m22  # 4y^2
    tz = 1.0 - m00 - m11 + m22  # 4z^2

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    qw = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], -1) / (2.0 * safe_sqrt(tw))[..., None]
    qx = torch.stack([m21 - m12, tx, m01 + m10, m02 + m20], -1) / (2.0 * safe_sqrt(tx))[..., None]
    qy = torch.stack([m02 - m20, m01 + m10, ty, m12 + m21], -1) / (2.0 * safe_sqrt(ty))[..., None]
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, tz], -1) / (2.0 * safe_sqrt(tz))[..., None]

    t = torch.stack([tw, tx, ty, tz], -1)
    idx = torch.argmax(t, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], -2)  # [..., 4cand, 4comp]
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """Vector [..,3] -> skew-symmetric matrix [..,3,3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..,3] -> rotation matrix [..,3,3] (Rodrigues),
    with series fallbacks near theta = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    W = hat(w)
    I = _eye(3, W).expand(W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..,3,3] -> rotation vector [..,3] (quaternion route)."""
    q = matrix_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    nv = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(nv, w)
    scale = torch.where(nv < 1e-7, 2.0 / torch.clamp(w, min=_EPS),
                        angle / torch.clamp(nv, min=_EPS))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# SE(3): 4x4 matrices
# ---------------------------------------------------------------------------

def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R [..,3,3], t [..,3]) -> 4x4 pose."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device (a host constant cannot be captured)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def identity_pose(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for small matrices, [..., n, k] x [..., k, m], as the k
    broadcast products summed left to right. A batched GEMM's CUDA kernel,
    and with it the rounding, follows the batch count (a library of 32
    objects gave object 0 other bits than its single estimate); these
    elementwise ops give every matrix the same bits at any batch size."""
    p = A[..., :, :, None] * B[..., None, :, :]     # [..., n, k, m]
    out = p[..., 0, :]
    for i in range(1, A.shape[-1]):
        out = out + p[..., i, :]
    return out


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return _mm(A, B)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v for [..., n, k] x [..., k], summed left to right (see _mm)."""
    p = M * v[..., None, :]                         # [..., n, k]
    out = p[..., 0]
    for i in range(1, M.shape[-1]):
        out = out + p[..., i]
    return out


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return make_pose(Rt, -_matvec(Rt, translation(T)))


def _rotate_fma(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[...,3,3] x [...,N,3] as nine broadcast multiply-adds (exact FP32)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    Rb = R[..., None, :, :]  # broadcast over the point axis
    return torch.stack(
        [
            Rb[..., 0, 0] * x + Rb[..., 0, 1] * y + Rb[..., 0, 2] * z,
            Rb[..., 1, 0] * x + Rb[..., 1, 1] * y + Rb[..., 1, 2] * z,
            Rb[..., 2, 0] * x + Rb[..., 2, 1] * y + Rb[..., 2, 2] * z,
        ],
        dim=-1,
    )


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose(s) [..,4,4] to points [..,N,3]."""
    return _rotate_fma(rotation(T), pts) + translation(T)[..., None, :]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return _rotate_fma(rotation(T), vecs)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..,6] = [omega, v] -> 4x4 pose (full exponential map with V)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS),
    )
    I = _eye(3, W).expand(W.shape)
    V = I + b[..., None, None] * W + c[..., None, None] * _mm(W, W)
    return make_pose(R, _matvec(V, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 pose -> twist [..,6] = [omega, v]."""
    w = so3_log(rotation(T))
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    W = hat(w)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - theta * torch.sin(theta)
         / torch.clamp(2.0 * (1.0 - torch.cos(theta)), min=_EPS))
        / torch.clamp(theta2, min=_EPS),
    )
    I = _eye(3, W).expand(W.shape)
    Vinv = I - 0.5 * W + cot_term[..., None, None] * _mm(W, W)
    return torch.cat([w, _matvec(Vinv, translation(T))], dim=-1)


def apply_twist(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-multiply update: exp(xi) @ T."""
    return compose(se3_exp(xi), T)


def apply_twist_about(xi: torch.Tensor, T: torch.Tensor,
                      anchor: torch.Tensor) -> torch.Tensor:
    """Anchor-conjugated update: Trans(a) exp(xi) Trans(-a) @ T — the
    rotation part of xi acts about `anchor` [..,3]."""
    E = se3_exp(xi)
    Rw, vw = rotation(E), translation(E)
    R = _mm(Rw, rotation(T))
    t = _matvec(Rw, translation(T) - anchor) + anchor + vw
    return make_pose(R, t)


# ---------------------------------------------------------------------------
# Compact pose7 = (quat wxyz, t)
# ---------------------------------------------------------------------------

def pose_to_pose7(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_quat(rotation(T)), translation(T)], dim=-1)


def pose7_to_pose(p: torch.Tensor) -> torch.Tensor:
    return make_pose(quat_to_matrix(p[..., :4]), p[..., 4:])


# ---------------------------------------------------------------------------
# Random sampling (gen: torch.Generator or rng.Draws)
# ---------------------------------------------------------------------------

def random_quat(gen, shape=()) -> torch.Tensor:
    """Uniform random unit quaternions (Shoemake); one uniform draw of
    shape + (3,)."""
    u = rng.uniform(gen, tuple(shape) + (3,))
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    tau = 2.0 * math.pi
    return torch.stack(
        [b * torch.cos(tau * u3), a * torch.sin(tau * u2),
         a * torch.cos(tau * u2), b * torch.sin(tau * u3)],
        dim=-1,
    )


def random_rotation(gen, shape=()) -> torch.Tensor:
    return quat_to_matrix(random_quat(gen, shape))


def super_fibonacci_rotations(n: int, gen=None, *, device=None) -> torch.Tensor:
    """n near-optimally-spread SO(3) rotations (super-Fibonacci spirals,
    Alexa CVPR'22). With `gen`, the whole grid is offset by one random
    rotation (one uniform draw of shape (3,)); from an rng.Stack of O
    sources, one offset per object: [O,n,3,3]."""
    if gen is not None:
        device = gen.device
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    phi = math.sqrt(2.0)
    psi = 1.533751168755204288118041  # the "super-golden" constant
    s = i / n
    r = torch.sqrt(s)
    R = torch.sqrt(1.0 - s)
    alpha = 2.0 * math.pi * i / phi
    beta = 2.0 * math.pi * i / psi
    q = torch.stack(
        [r * torch.sin(alpha), r * torch.cos(alpha),
         R * torch.sin(beta), R * torch.cos(beta)], dim=-1,
    )
    rot = quat_to_matrix(q)
    if gen is not None:
        rot = _mm(random_rotation(gen)[..., None, :, :], rot)
    return rot


def perturb_pose(
    gen,
    T: torch.Tensor,
    rot_sigma: torch.Tensor | float,
    trans_sigma: torch.Tensor | float,
    shape=(),
) -> torch.Tensor:
    """Sample poses around T: Gaussian twists whose rotation acts about T's
    own translation. Draws, in order: the rotation normals, then the
    translation normals, each of shape + (3,). rot_sigma in radians,
    trans_sigma in meters. From an rng.Stack of O sources the draws, and
    the result, carry a leading object axis: T is then [O, ..., 4, 4]
    (broadcast against shape) and a sigma a float or [O, 1, ...]."""
    shape = tuple(shape)
    w = rng.normal(gen, shape + (3,)) * rot_sigma
    v = rng.normal(gen, shape + (3,)) * trans_sigma
    xi = torch.cat([w, v], dim=-1)
    Tb = T.expand(tuple(xi.shape[:-1]) + (4, 4))
    return apply_twist_about(xi, Tb, translation(Tb))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def rotation_angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotations, degrees."""
    cos = (torch.sum(Ra * Rb, dim=(-1, -2)) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def add_s_error(T_est: torch.Tensor, T_gt: torch.Tensor,
                model_pts: torch.Tensor) -> torch.Tensor:
    """ADD-S: mean over GT-posed points of the distance to the closest
    estimate-posed point. model_pts [N,3]; poses [..,4,4] -> [..]."""
    pe = transform_points(T_est, model_pts)
    pg = transform_points(T_gt, model_pts)
    d2 = torch.sum((pg[..., :, None, :] - pe[..., None, :, :]) ** 2, dim=-1)
    return torch.mean(torch.sqrt(torch.amin(d2, dim=-1)), dim=-1)


def add_error(T_est: torch.Tensor, T_gt: torch.Tensor,
              model_pts: torch.Tensor) -> torch.Tensor:
    """ADD (average distance, matched points)."""
    pe = transform_points(T_est, model_pts)
    pg = transform_points(T_gt, model_pts)
    return torch.mean(torch.linalg.norm(pe - pg, dim=-1), dim=-1)
