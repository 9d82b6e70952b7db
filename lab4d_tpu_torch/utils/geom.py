"""Geometry utilities in torch: intrinsics ops, pinhole projection,
dual-quaternion blend skinning, near-far estimation, aabb ops.

Port of the parts of lab4d_tpu/utils/geom.py that the rendering and
training paths use. Functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lab4d_tpu_torch.utils.quat import (
    DualQuaternion,
    dual_quaternion_to_quaternion_translation,
    quaternion_to_matrix,
    quaternion_translation_apply,
)


def safe_norm(d: torch.Tensor, dim=-1, keepdim: bool = True, eps: float = 1e-12):
    """L2 norm with a finite gradient at zero."""
    return torch.sqrt(torch.sum(d * d, dim=dim, keepdim=keepdim) + eps)


def pinhole_projection(Kmat: torch.Tensor, xyz_cam: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) intrinsics, (M, ..., 3) camera points -> (M, ..., 3)
    homogeneous pixel coordinates."""
    Kb = Kmat.reshape(Kmat.shape[:1] + (1,) * (xyz_cam.ndim - 2) + (3, 3))
    hxy = torch.einsum("...ij,...j->...i", Kb, xyz_cam)
    return hxy / (hxy[..., -1:] + 1e-6)


def K2mat(K: torch.Tensor) -> torch.Tensor:
    """(fx, fy, cx, cy) -> 3x3 intrinsics matrix."""
    fx, fy, cx, cy = K.unbind(-1)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, zero, cx], -1),
            torch.stack([zero, fy, cy], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )


def K2inv(K: torch.Tensor) -> torch.Tensor:
    """(fx, fy, cx, cy) -> inverse 3x3 intrinsics matrix."""
    fx, fy, cx, cy = K.unbind(-1)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([1.0 / fx, zero, -cx / fx], -1),
            torch.stack([zero, 1.0 / fy, -cy / fy], -1),
            torch.stack([zero, zero, one], -1),
        ],
        dim=-2,
    )


def mat2K(Kmat: torch.Tensor) -> torch.Tensor:
    """3x3 intrinsics matrix -> (fx, fy, cx, cy)."""
    return torch.stack(
        [Kmat[..., 0, 0], Kmat[..., 1, 1], Kmat[..., 0, 2], Kmat[..., 1, 2]], dim=-1
    )


def Kmatinv(Kmat: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3x3 intrinsics matrix (either way round)."""
    return K2inv(mat2K(Kmat))


def apply_se3mat(se3, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (quat, trans) SE(3) to points (broadcasting)."""
    quat, trans = se3
    return quaternion_translation_apply(quat, trans, pts)


def dual_quaternion_skinning(
    dual_quat: DualQuaternion, pts: torch.Tensor, skin: torch.Tensor
) -> torch.Tensor:
    """Dual-quaternion blend skinning; the dominant bone of each point is
    the hemisphere anchor of its blend.

    Args:
        dual_quat: ((M,B,4), (M,B,4)) per-bone SE(3)
        pts: (M, ..., 3); skin: (M, ..., B) normalized weights
    Returns:
        (M, ..., 3) skinned points
    """
    shape = pts.shape
    M, B = dual_quat[0].shape[0], dual_quat[0].shape[1]
    pts = pts.reshape(M, -1, 3)
    skin = skin.reshape(M, -1, B)
    qr, qd = dual_quat

    sign_tab = torch.where(
        torch.einsum("mia,mja->mij", qr, qr) > 0, 1.0, -1.0
    ).to(skin.dtype)  # (M, B, B)
    onehot = F.one_hot(torch.argmax(skin, -1), B).to(skin.dtype)
    sign = onehot @ sign_tab  # (M, P, B)
    sw = skin * sign
    qr_w = sw @ qr  # (M, P, 4)
    qd_w = sw @ qd
    inv_mag = torch.rsqrt(torch.clamp(torch.sum(qr_w * qr_w, -1, keepdim=True), min=1e-12))
    qr_w = qr_w * inv_mag
    qd_w = qd_w * inv_mag

    w, x, y, z = qr_w.unbind(-1)
    px, py, pz = pts.unbind(-1)
    cx = y * pz - z * py + w * px
    cy = z * px - x * pz + w * py
    cz = x * py - y * px + w * pz
    rx = px + 2 * (y * cz - z * cy)
    ry = py + 2 * (z * cx - x * cz)
    rz = pz + 2 * (x * cy - y * cx)
    dw, dx, dy, dz = qd_w.unbind(-1)
    tx = 2 * (-dw * x + dx * w - dy * z + dz * y)
    ty = 2 * (-dw * y + dx * z + dy * w - dz * x)
    tz = 2 * (-dw * z - dx * y + dy * x + dz * w)
    return torch.stack([rx + tx, ry + ty, rz + tz], -1).reshape(shape)


def dual_quaternion_skinning_pair(dq_a: DualQuaternion, dq_b: DualQuaternion, pts: torch.Tensor,
                                  skin: torch.Tensor):
    """The same points and weights skinned under two bone sets, in one
    pass over the pair-stacked arrays (the flow and cycle warps of a
    training step): (dual_quaternion_skinning(dq_a, pts, skin),
    dual_quaternion_skinning(dq_b, pts, skin))."""
    M = dq_a[0].shape[0]
    dq = (torch.cat([dq_a[0], dq_b[0]], 0), torch.cat([dq_a[1], dq_b[1]], 0))
    out = dual_quaternion_skinning(dq, torch.cat([pts, pts], 0), torch.cat([skin, skin], 0))
    return out[:M], out[M:]


def obj_to_cam(pts: torch.Tensor, rtmat: torch.Tensor) -> torch.Tensor:
    """(N,3) points by (M,4,4) object-to-camera matrices -> (M,N,3)."""
    return torch.einsum("mij,nj->mni", rtmat[:, :3, :3], pts) + rtmat[:, None, :3, 3]


def get_near_far(pts: torch.Tensor, rtmat: torch.Tensor, tol_fac: float = 1.5):
    """Per-camera near/far planes from proxy points."""
    z = obj_to_cam(pts, rtmat)[..., 2]
    zmax = z.max(-1).values
    zmin = z.min(-1).values
    delta = (zmax - zmin) * (tol_fac - 1.0)
    return torch.clamp(torch.stack([zmin - delta, zmax + delta], -1), min=1e-3)


def extend_aabb(aabb: torch.Tensor, factor: float = 0.1) -> torch.Tensor:
    """Extend a (2,3) aabb on each side by `factor` of its size."""
    size = aabb[1] - aabb[0]
    return torch.stack([aabb[0] - size * factor, aabb[1] + size * factor], 0)


def check_inside_aabb(xyz: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Boolean mask of points strictly inside the aabb."""
    return torch.all((xyz > aabb[0]) & (xyz < aabb[1]), dim=-1)


def get_bone_coords(xyz: torch.Tensor, bone2obj: DualQuaternion, scale=None) -> torch.Tensor:
    """Points (..., 3) in each bone's frame, (..., B, 3): R^T (x - t) of
    the bones ((L..., B, 4), (L..., B, 4)), whose leading dims L are a
    broadcastable prefix of the points'; scale (B, 3) divides the
    bone-frame coordinates."""
    q, t = dual_quaternion_to_quaternion_translation(bone2obj)
    R = quaternion_to_matrix(q)  # (..., B, 3, 3) bone -> obj
    if scale is not None:
        R = R / scale[..., None, :]
    n_lead = R.ndim - 3
    lead_shape = torch.broadcast_shapes(xyz.shape[:n_lead], R.shape[:n_lead])
    xyz = xyz.expand(lead_shape + xyz.shape[n_lead:])
    R = R.expand(lead_shape + R.shape[n_lead:])
    t = t.expand(lead_shape + t.shape[n_lead:])
    lead = "ACEFG"[:n_lead]
    xr = torch.einsum(f"{lead}...j,{lead}bji->{lead}...bi", xyz, R)
    tr = torch.einsum(f"{lead}bj,{lead}bji->{lead}bi", t, R)
    tr = tr.reshape(tr.shape[:n_lead] + (1,) * (xr.ndim - tr.ndim) + tr.shape[n_lead:])
    return xr - tr


def get_xyz_bone_distance(xyz: torch.Tensor, bone2obj: DualQuaternion) -> torch.Tensor:
    """Squared distance from points to bone centers; the bones may carry
    fewer leading dims than the points."""
    _, center = dual_quaternion_to_quaternion_translation(bone2obj)
    n_lead = center.ndim - 2
    pad = xyz.ndim - 1 - n_lead
    center = center.reshape(center.shape[:n_lead] + (1,) * pad + center.shape[n_lead:])
    return torch.sum((xyz[..., None, :] - center) ** 2, dim=-1)
