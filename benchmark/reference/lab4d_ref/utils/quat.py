"""Quaternion and dual-quaternion algebra in torch.

Port of lab4d_tpu/utils/quat.py. Quaternions are (..., 4) tensors, real
part first (w, x, y, z); a dual quaternion is a tuple (q_r, q_d) of two
(..., 4) tensors; SE(3) is a (quat, trans) tuple or a (..., 4, 4) matrix.
All functions broadcast over leading dims like their jnp counterparts.
"""

from __future__ import annotations

from typing import Tuple

import torch

DualQuaternion = Tuple[torch.Tensor, torch.Tensor]
QuaternionTranslation = Tuple[torch.Tensor, torch.Tensor]


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quaternion_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product; broadcasts."""
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


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quaternion_apply(q: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """Rotate 3D points by unit quaternions (two-cross-product form)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    uv = _cross(qv, pt)
    uuv = _cross(qv, uv)
    return pt + 2.0 * (qw * uv + uuv)


def quaternion_translation_apply(q, t, pt):
    return quaternion_apply(q, pt) + t


def quaternion_translation_inverse(q, t) -> QuaternionTranslation:
    q_inv = quaternion_conjugate(q)
    return q_inv, quaternion_apply(q_inv, -t)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (angle = norm) to unit quaternions, with the series
    sin(x/2)/x ~= 1/2 - x^2/48 near zero."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(sq, min=1e-24))
    half = 0.5 * angle
    small = angle < 1e-6
    sin_half_over_angle = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    return torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (not necessarily unit) to rotation matrices."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.sum(q * q, dim=-1)
    row0 = torch.stack(
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)], -1
    )
    row1 = torch.stack(
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)], -1
    )
    row2 = torch.stack(
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices to quaternions: all four Shepperd candidates,
    the best-conditioned one selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(cand, -2, idx)[..., 0, :]


def quaternion_translation_to_se3(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    rmat = quaternion_to_matrix(q)
    top = torch.cat([rmat, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_to_quaternion_translation(se3: torch.Tensor, tuple_out: bool = True):
    q = matrix_to_quaternion(se3[..., :3, :3])
    t = se3[..., :3, 3]
    if tuple_out:
        return q, t
    return torch.cat([q, t], dim=-1)


def quaternion_translation_to_dual_quaternion(q, t) -> DualQuaternion:
    return q, 0.5 * quaternion_mul(torch.cat([torch.zeros_like(t[..., :1]), t], -1), q)


def dual_quaternion_to_quaternion_translation(dq: DualQuaternion) -> QuaternionTranslation:
    q_r, q_d = dq
    t = 2.0 * quaternion_mul(q_d, quaternion_conjugate(q_r))[..., 1:]
    return q_r, t


def dual_quaternion_mul(dq1: DualQuaternion, dq2: DualQuaternion) -> DualQuaternion:
    r1, d1 = dq1
    r2, d2 = dq2
    return quaternion_mul(r1, r2), quaternion_mul(r1, d2) + quaternion_mul(d1, r2)


def dual_quaternion_q_conjugate(dq: DualQuaternion) -> DualQuaternion:
    return quaternion_conjugate(dq[0]), quaternion_conjugate(dq[1])


def dual_quaternion_inverse(dq: DualQuaternion) -> DualQuaternion:
    """Inverse of a unit dual quaternion (= quaternion conjugate)."""
    return dual_quaternion_q_conjugate(dq)


