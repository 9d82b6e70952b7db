"""Skeleton definition and forward kinematics in torch.

Port of lab4d_tpu/utils/skel.py for the 18-joint human and the 25-joint
quadruped skeletons: the joint tables are data priors shared with the
reference, kept numerically identical; FK composes (quaternion, translation) pairs in a static
topological order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.lab4d_ref.utils.quat import (
    axis_angle_to_quaternion,
    dual_quaternion_to_quaternion_translation,
    quaternion_apply,
    quaternion_mul,
    quaternion_translation_to_dual_quaternion,
)


@dataclass(frozen=True)
class Skeleton:
    """parents: (B,) parent per joint, -1 = world root; rest_joints_np:
    (B, 3) rest joints (object space); symm_idx: mirrored joint per joint;
    topo_order: joint evaluation order (parents first)."""

    parents: Tuple[int, ...]
    rest_joints_np: np.ndarray = field(hash=False, compare=False)
    symm_idx: Tuple[int, ...] = None
    topo_order: Tuple[int, ...] = None

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def rest_joints(self) -> np.ndarray:
        return self.rest_joints_np

    @property
    def edges(self) -> Dict[int, int]:
        """1-indexed child -> parent (0 = world), as export draws bones."""
        return {i + 1: p + 1 for i, p in enumerate(self.parents)}


def _topo_sort(parents) -> Tuple[int, ...]:
    order, placed = [], set()
    pending = list(range(len(parents)))
    while pending:
        for j in list(pending):
            if parents[j] < 0 or parents[j] in placed:
                order.append(j)
                placed.add(j)
                pending.remove(j)
    return tuple(order)


def make_skeleton(parents, rest_joints, symm_idx) -> Skeleton:
    parents = tuple(int(p) for p in parents)
    return Skeleton(
        parents=parents,
        rest_joints_np=np.asarray(rest_joints, dtype=np.float32),
        symm_idx=tuple(int(s) for s in symm_idx),
        topo_order=_topo_sort(parents),
    )


def rest_joints_to_local(rest_joints: torch.Tensor, skel: Skeleton) -> torch.Tensor:
    """Parent-to-child translations; the root keeps its absolute position."""
    parents = np.asarray(skel.parents)
    has_parent = parents >= 0
    parent_pos = rest_joints[..., np.where(has_parent, parents, 0), :]
    mask = torch.as_tensor(has_parent, device=rest_joints.device)[..., None]
    return torch.where(mask, rest_joints - parent_pos, rest_joints)


def fk_quat_trans(local_rest_joints: torch.Tensor, so3: torch.Tensor, skel: Skeleton):
    """Forward kinematics: (..., B, 3) local rest joints and (..., B, 3)
    axis-angles -> joint-to-object ((..., B, 4), (..., B, 3))."""
    q_local = axis_angle_to_quaternion(so3)
    quats = [None] * skel.num_joints
    trans = [None] * skel.num_joints
    for j in skel.topo_order:
        qj = q_local[..., j, :]
        tj = local_rest_joints[..., j, :]
        p = skel.parents[j]
        if p < 0:
            quats[j], trans[j] = qj, tj
        else:
            quats[j] = quaternion_mul(quats[p], qj)
            trans[j] = quaternion_apply(quats[p], tj) + trans[p]
    return torch.stack(quats, dim=-2), torch.stack(trans, dim=-2)


def fk_se3(local_rest_joints, so3, skel: Skeleton):
    """FK as dual quaternions."""
    return quaternion_translation_to_dual_quaternion(
        *fk_quat_trans(local_rest_joints, so3, skel)
    )


def shift_joints_to_bones(joints: torch.Tensor, skel: Skeleton) -> torch.Tensor:
    """Move each internal joint to the mean midpoint to its children."""
    parents = np.asarray(skel.parents)
    child_idx = np.nonzero(parents >= 0)[0]
    parent_idx = parents[child_idx]
    if len(child_idx) == 0:
        return joints
    midpoints = (joints[..., parent_idx, :] + joints[..., child_idx, :]) / 2.0
    onehot = np.zeros((len(child_idx), skel.num_joints), dtype=np.float32)
    onehot[np.arange(len(child_idx)), parent_idx] = 1.0
    counts = onehot.sum(0)
    dev = joints.device
    sums = torch.einsum("...kc,kb->...bc", midpoints, torch.as_tensor(onehot, device=dev))
    means = sums / torch.as_tensor(np.maximum(counts, 1.0), device=dev)[..., None]
    has_child = torch.as_tensor(counts > 0, device=dev)[..., None]
    return torch.where(has_child, means, joints)


def shift_joints_to_bones_dq(dq, skel: Skeleton, shift=None):
    quat, joints = dual_quaternion_to_quaternion_translation(dq)
    if shift is not None:
        joints = joints + shift.reshape((1,) * (joints.ndim - 1) + (3,))
    joints = shift_joints_to_bones(joints, skel)
    return quaternion_translation_to_dual_quaternion(quat, joints)


# the joint tables are numeric priors shared with the reference
# (1-indexed, 0 = world), identical to lab4d_tpu/utils/skel.py
_HUMAN_PARENT_1IDX = {
    1: 0, 13: 0, 16: 0, 2: 1, 3: 2, 4: 3, 5: 3, 9: 3, 6: 5, 7: 6, 8: 7,
    10: 9, 11: 10, 12: 11, 14: 13, 15: 14, 17: 16, 18: 17,
}
_HUMAN_SYMM_1IDX = {
    1: 1, 2: 2, 3: 3, 4: 4, 5: 9, 6: 10, 7: 11, 8: 12, 9: 5, 10: 6, 11: 7,
    12: 8, 13: 16, 14: 17, 15: 18, 16: 13, 17: 14, 18: 15,
}
_HUMAN_REST_JOINTS = np.array(
    [
        [0.0, 0.0, 0.0],
        [-3.6278e-05, 3.6903e-03, -7.2475e-04],
        [-9.3221e-05, 8.0693e-03, -1.1619e-03],
        [-1.2457e-04, 1.3251e-02, -1.3801e-03],
        [-6.0306e-05, 1.8105e-02, -7.8039e-04],
        [2.2711e-03, 1.6784e-02, -8.8300e-04],
        [7.1616e-03, 1.6918e-02, -1.6573e-03],
        [1.7433e-02, 1.6934e-02, -1.7350e-03],
        [2.7266e-02, 1.6963e-02, -1.7920e-03],
        [-2.4980e-03, 1.6817e-02, -9.5435e-04],
        [-7.4151e-03, 1.6886e-02, -1.9168e-03],
        [-1.7819e-02, 1.6867e-02, -1.7721e-03],
        [-2.7194e-02, 1.6867e-02, -1.6701e-03],
        [3.4517e-03, -2.5785e-03, 4.9599e-04],
        [3.3529e-03, -1.8460e-02, 2.0430e-04],
        [3.3907e-03, -3.4376e-02, -7.4148e-04],
        [-3.4360e-03, -2.6853e-03, 2.9919e-05],
        [-3.3118e-03, -1.8488e-02, 2.1094e-04],
        [-3.3864e-03, -3.4373e-02, -7.9789e-04],
    ],
    dtype=np.float32,
)

_QUAD_PARENT_1IDX = {
    1: 0, 13: 0, 18: 0, 22: 0, 2: 1, 3: 2, 4: 3, 5: 3, 9: 3, 6: 5, 7: 6,
    8: 7, 10: 9, 11: 10, 12: 11, 14: 13, 15: 14, 16: 15, 17: 16, 19: 18,
    20: 19, 21: 20, 23: 22, 24: 23, 25: 24,
}
_QUAD_SYMM_1IDX = {
    1: 1, 2: 2, 3: 3, 4: 4, 5: 9, 6: 10, 7: 11, 8: 12, 9: 5, 10: 6, 11: 7,
    12: 8, 13: 13, 14: 14, 15: 15, 16: 16, 17: 17, 18: 22, 19: 23, 20: 24,
    21: 25, 22: 18, 23: 19, 24: 20, 25: 21,
}
_QUAD_REST_JOINTS = np.array(
    [
        [0.0000e00, 0.01, 0.03],
        [-9.3610e-05, 1.0187e-03, -2.1873e-02],
        [-5.4921e-05, 1.7428e-03, -9.3399e-03],
        [-8.7874e-05, 2.8378e-03, 4.7383e-03],
        [-6.6505e-05, 1.9184e-02, 1.9050e-02],
        [6.6107e-03, 8.1839e-03, 1.1086e-02],
        [9.1702e-03, -7.7618e-03, 1.0090e-02],
        [1.0476e-02, -2.7165e-02, 6.9399e-03],
        [1.1353e-02, -3.5803e-02, 1.1250e-02],
        [-6.9130e-03, 8.2406e-03, 1.1061e-02],
        [-9.5720e-03, -7.6817e-03, 1.0104e-02],
        [-1.0856e-02, -2.7090e-02, 7.0649e-03],
        [-1.1773e-02, -3.5696e-02, 1.1439e-02],
        [3.2358e-05, 6.6986e-03, -4.5738e-02],
        [9.5675e-05, 3.9485e-03, -5.4802e-02],
        [1.6878e-04, 3.1219e-03, -6.3845e-02],
        [2.2074e-04, 4.3004e-03, -7.3049e-02],
        [2.0674e-04, 6.3312e-03, -8.2086e-02],
        [7.4309e-03, -2.5624e-03, -3.3335e-02],
        [7.9435e-03, -1.7319e-02, -3.6508e-02],
        [8.1728e-03, -2.8493e-02, -3.9845e-02],
        [8.5748e-03, -3.3565e-02, -3.7078e-02],
        [-7.5478e-03, -2.5571e-03, -3.3397e-02],
        [-8.2738e-03, -1.7257e-02, -3.6706e-02],
        [-8.6677e-03, -2.8381e-02, -4.0128e-02],
        [-9.1048e-03, -3.3482e-02, -3.7373e-02],
    ],
    dtype=np.float32,
)


def get_predefined_skeleton(skel_type: str) -> Skeleton:
    """A predefined skeleton ("human" or "quad"): the human table upscaled
    2.5x to the initial object bound, GL->CV flip of y/z, all joints offset
    by the dropped world joint, 0-based parents/symmetry."""
    if skel_type == "human":
        parent_1idx, symm_1idx = _HUMAN_PARENT_1IDX, _HUMAN_SYMM_1IDX
        rest = _HUMAN_REST_JOINTS.copy() * 2.5
    elif skel_type == "quad":
        parent_1idx, symm_1idx = _QUAD_PARENT_1IDX, _QUAD_SYMM_1IDX
        rest = _QUAD_REST_JOINTS.copy()
    else:
        raise ValueError(f"Unknown skeleton type {skel_type}")
    rest[:, 1:] *= -1
    rest_joints = rest[1:] + rest[:1]
    B = len(rest_joints)
    parents = [parent_1idx[j + 1] - 1 for j in range(B)]
    symm_idx = [symm_1idx[j + 1] - 1 for j in range(B)]
    return make_skeleton(parents, rest_joints, symm_idx)
