"""Batched SO(3)/SE(3) Lie-group operations on torch tensors.

Port of kimera_vio_tpu/common/geometry.py: the same formulas, the same
small-angle Taylor branches selected with `torch.where` (no data-dependent
control flow, so the functions also run under `torch.func.vmap` /
`jacfwd`), every op batched over leading dimensions. Rotations are 3x3
matrices; poses are (R, t) pairs.

Per-rotation scalars (angles, quaternion components) keep a trailing axis
of size 1 instead of becoming 0-d: under `torch.func.jacfwd`, a 0-d primal
combined with a Python float yields a float64 tangent on some PyTorch
builds, which breaks the backend's autodiff Jacobians.
"""

from __future__ import annotations

import torch

# Small-angle threshold below which Taylor expansions are used.
_EPS = 1e-6


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sinθ/θ, (1−cosθ)/θ², (θ−sinθ)/θ³) with stable
    small-angle branches. theta2 = θ²."""
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / safe_t2)
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) (Rodrigues). (...,3) -> (...,3,3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye_like(w, W.shape)
    return eye + A[..., None] * W + B[..., None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) through the quaternion (stable for all
    angles): theta = 2 atan2(|xyz|, w)."""
    q = rot_to_quat(R)
    w, xyz = q[..., 0:1], q[..., 1:4]
    n = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-7
    safe_n = torch.where(small, torch.ones_like(n), n)
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=1e-12), theta / safe_n
    )
    return scale * xyz


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): J_l(w) = I + B*W + C*W^2."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye_like(w, W.shape)
    return eye + B[..., None] * W + C[..., None] * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3): J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3), stable small-angle form."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2
        - (1.0 + torch.cos(safe_t)) / (2.0 * safe_t * torch.sin(safe_t)),
    )
    W = hat(w)
    W2 = W @ W
    eye = _eye_like(w, W.shape)
    return eye + 0.5 * W + cot_term[..., None] * W2


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) [w,x,y,z] -> rotation matrix (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) [w,x,y,z],
    branch-free Shepperd's method over the four cases."""
    m00, m01, m02 = R[..., 0, 0:1], R[..., 0, 1:2], R[..., 0, 2:3]
    m10, m11, m12 = R[..., 1, 0:1], R[..., 1, 1:2], R[..., 1, 2:3]
    m20, m21, m22 = R[..., 2, 0:1], R[..., 2, 1:2], R[..., 2, 2:3]
    tr = m00 + m11 + m22

    def case(tw, tx, ty, tz, s):
        return torch.cat([tw, tx, ty, tz], dim=-1) / (2.0 * torch.sqrt(s))

    s0 = torch.clamp(1.0 + tr, min=1e-12)
    q0 = case(s0, m21 - m12, m02 - m20, m10 - m01, s0)
    s1 = torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)
    q1 = case(m21 - m12, s1, m01 + m10, m02 + m20, s1)
    s2 = torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)
    q2 = case(m02 - m20, m01 + m10, s2, m12 + m21, s2)
    s3 = torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)
    q3 = case(m10 - m01, m02 + m20, m12 + m21, s3, s3)

    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    # Canonicalize: w >= 0.
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def se3_compose(Ra, ta, Rb, tb):
    """T_a * T_b for (R, t) pairs."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    """T^-1 of an (R, t) pair."""
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_transform(R, t, p):
    """Apply a pose to points p (...,3)."""
    return (R @ p[..., None])[..., 0] + t


def se3_exp(xi: torch.Tensor):
    """Exp map se(3) -> SE(3); xi = (...,6) [omega, v] (rotation first,
    GTSAM Pose3::Expmap ordering). Returns (R, t)."""
    w = xi[..., 0:3]
    v = xi[..., 3:6]
    R = so3_exp(w)
    J = so3_left_jacobian(w)
    t = (J @ v[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Log map SE(3) -> se(3) (...,6) [omega, v]."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / safe_t2,
    )
    eye = _eye_like(R, R.shape)
    Jl_inv = eye - 0.5 * W + coef[..., None] * W2
    v = (Jl_inv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_retract(R, t, xi):
    """Right retraction T * Exp(xi) (GTSAM Pose3 retract)."""
    dR, dt = se3_exp(xi)
    return se3_compose(R, t, dR, dt)


def rotation_between(Ra, Rb):
    """Relative rotation Ra^T Rb."""
    return torch.swapaxes(Ra, -1, -2) @ Rb


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """A near-rotation matrix projected back onto SO(3) by a quaternion
    round trip."""
    return quat_to_rot(rot_to_quat(R))
