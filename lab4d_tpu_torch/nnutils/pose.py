"""Camera and articulation MLPs. Port of lab4d_tpu/nnutils/pose.py: the
camera, the bag of bones (free SE(3) per bone) and the skeleton.

Articulation outputs are dual quaternions ((M,B,4), (M,B,4)), bone->object.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from lab4d_tpu_torch.nnutils.base import CondMLP
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from lab4d_tpu_torch.nnutils.linear import TorchDense
from lab4d_tpu_torch.nnutils.time_mlp import TimeMLP
from lab4d_tpu_torch.utils.quat import (
    axis_angle_to_quaternion,
    matrix_to_quaternion,
    quaternion_mul,
    quaternion_translation_to_dual_quaternion,
    quaternion_translation_to_se3,
)
from lab4d_tpu_torch.utils.skel import (
    fk_se3,
    get_predefined_skeleton,
    rest_joints_to_local,
    shift_joints_to_bones_dq,
)


def _normalize(v, dim=-1, eps=1e-12):
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


class CameraMLP(TimeMLP):
    """Time-varying object-to-camera SE(3) as (quat, trans), with
    per-video base rotations. `rtmat_init` (M, 4, 4), one per filtered
    frame in field units, is the camera prior that
    compute_distance_to_prior fits to."""

    def __init__(self, frame_info: FrameInfo, rtmat_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, generator=generator)
        if rtmat_init is not None:
            self.register_buffer("rtmat_init", torch.as_tensor(np.asarray(rtmat_init, np.float32)),
                                 persistent=False)
        W = self.W
        self.trans_head = nn.ModuleList([TorchDense(W, W // 2, generator), TorchDense(W // 2, 3, generator)])
        self.quat_head = nn.ModuleList([TorchDense(W, W // 2, generator), TorchDense(W // 2, 4, generator)])
        base_quat = torch.zeros(frame_info.num_vids, 4)
        base_quat[:, 0] = 1.0
        self.base_quat = nn.Parameter(base_quat)

    def _heads(self, t_feat):
        trans = self.trans_head[1](torch.relu(self.trans_head[0](t_feat)))
        quat = self.quat_head[1](torch.relu(self.quat_head[0](t_feat)))
        return _normalize(quat), trans

    def get_vals(self, frame_id=None):
        """Camera pose at raw frame ids; None = all filtered frames."""
        quat, trans = self._heads(self.forward_feat(self.time_embedding(frame_id)))
        base_quat = _normalize(self.base_quat[self.frame_ids_to_vid(frame_id)])
        return quaternion_mul(quat, base_quat), trans

    def compute_distance_to_prior(self):
        """MSE between the SE(3) of every filtered frame and the prior."""
        quat, trans = self.get_vals(None)
        return torch.mean((quaternion_translation_to_se3(quat, trans) - self.rtmat_init) ** 2)


def camera_base_quat_init(rtmat: np.ndarray, frame_info: FrameInfo) -> np.ndarray:
    """Per-video base rotations from the first frame of each video's prior."""
    first = frame_info.frame_offset[:-1]
    return matrix_to_quaternion(torch.as_tensor(rtmat[first, :3, :3])).numpy()


class ArticulationFlatMLP(TimeMLP):
    """Bag of bones: a free SE(3) per bone over time, with no skeleton, no
    joint-angle prior and a zero skeleton prior."""

    num_se3 = 25

    def __init__(self, frame_info: FrameInfo, generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, generator=generator)
        num_se3, W = self.num_se3, self.W
        self.trans_head = nn.ModuleList(
            [TorchDense(W, W // 2, generator), TorchDense(W // 2, 3 * num_se3, generator)])
        self.so3_head = nn.ModuleList(
            [TorchDense(W, W // 2, generator), TorchDense(W // 2, 3 * num_se3, generator)])

    def forward_arti(self, t_embed, inst_id=None):
        t_feat = self.forward_feat(t_embed)
        shape = t_embed.shape[:-1] + (self.num_se3, 3)
        trans = 0.1 * self.trans_head[1](torch.relu(self.trans_head[0](t_feat))).reshape(shape)
        so3 = self.so3_head[1](torch.relu(self.so3_head[0](t_feat))).reshape(shape)
        return quaternion_translation_to_dual_quaternion(axis_angle_to_quaternion(so3), trans)

    def get_vals(self, frame_id=None):
        return self.forward_arti(self.time_embedding(frame_id))

    def get_mean_vals(self, inst_id=None):
        """Rest bones: the articulation at the mean time embedding, batch (1,)."""
        return self.forward_arti(self.time_embedding.mean_embedding())

    def get_vals_and_mean(self, frame_id=None):
        t = self.get_vals(frame_id)
        rest = self.get_mean_vals()
        return t, (rest[0].expand(t[0].shape), rest[1].expand(t[1].shape))

    def skel_prior_loss(self):
        return self.so3_head[0].bias.new_zeros(())


class ArticulationSkelMLP(TimeMLP):
    """Skeleton articulation: joint angles -> FK -> bone dual quaternions.
    joint_angles_init (M, B, 3): an external joint-angle prior per
    filtered frame, which prior_fit_loss fits the joint angles to."""

    def __init__(self, frame_info: FrameInfo, skel_type: str = "quad",
                 joint_angles_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, generator=generator)
        if joint_angles_init is not None:
            joint_angles_init = torch.as_tensor(np.asarray(joint_angles_init, np.float32))
        self.register_buffer("joint_angles_init", joint_angles_init, persistent=False)
        self.skeleton = get_predefined_skeleton(skel_type)
        self.num_se3 = self.skeleton.num_joints
        W = self.W
        self.so3_head = nn.ModuleList(
            [TorchDense(W, W // 2, generator), TorchDense(W // 2, 3 * self.num_se3, generator)]
        )
        self.logscale = nn.Parameter(torch.zeros(1))
        self.shift = nn.Parameter(torch.zeros(3))
        self.log_bone_len = CondMLP(
            frame_info.num_vids, 0, D=2, W=64, out_channels=self.num_se3, generator=generator,
        )
        rest = torch.as_tensor(self.skeleton.rest_joints)
        self.register_buffer("rel_rest_joints", rest_joints_to_local(rest, self.skeleton),
                             persistent=False)
        self.register_buffer("symm_idx", torch.as_tensor(self.skeleton.symm_idx),
                             persistent=False)

    def compute_so3(self, t_embed):
        so3 = self.so3_head[1](torch.relu(self.so3_head[0](self.forward_feat(t_embed))))
        return so3.reshape(t_embed.shape[:-1] + (self.num_se3, 3))

    def compute_rel_rest_joints(self, inst_id=None, batch_shape=()):
        """Parent-relative rest joints scaled by the symmetrized
        per-instance bone lengths."""
        rel = self.rel_rest_joints.expand(batch_shape + self.rel_rest_joints.shape)
        empty_feat = rel.new_zeros(batch_shape + (0,))
        bone_len = torch.exp(self.log_bone_len(empty_feat, inst_id) + self.logscale)
        bone_len = (bone_len + bone_len[..., self.symm_idx]) / 2.0
        return rel * bone_len[..., None]

    def forward_arti(self, t_embed, inst_id=None, override_local_rest_joints=None):
        so3 = self.compute_so3(t_embed)
        if override_local_rest_joints is None:
            local_rest = self.compute_rel_rest_joints(inst_id, batch_shape=so3.shape[:-2])
        else:
            local_rest = override_local_rest_joints
        return self._bones(so3, local_rest)

    def _bones(self, so3, local_rest):
        """Joint angles and parent-relative rest joints -> bone dual
        quaternions (FK, then joints shifted to bone centres)."""
        dq = fk_se3(local_rest, so3, self.skeleton)
        return shift_joints_to_bones_dq(dq, self.skeleton, shift=self.shift)

    def get_vals(self, frame_id=None, return_so3: bool = False, override_so3=None):
        """Time-t bones at raw frame ids (None: all filtered frames). The
        joint angles (M, B, 3) alone with return_so3; override_so3
        (M, B, 3): the bones of those joint angles in place of the MLP's."""
        if override_so3 is None:
            so3 = self.compute_so3(self.time_embedding(frame_id))
        else:
            so3 = override_so3
        if return_so3:
            return so3
        inst_id = self.frame_ids_to_vid(frame_id)
        return self._bones(so3, self.compute_rel_rest_joints(inst_id, batch_shape=so3.shape[:-2]))

    def get_vals_and_mean(self, frame_id=None):
        """Time-t and rest-pose bones in one batched FK pass."""
        inst_id = self.frame_ids_to_vid(frame_id)
        bs = inst_id.shape[0]
        t_embed = self.time_embedding(frame_id)
        t_mean = self.time_embedding.mean_embedding().expand(t_embed.shape)
        t_all = torch.cat([t_embed, t_mean], dim=0)
        rel_i = self.compute_rel_rest_joints(inst_id, batch_shape=(bs,))
        rel_c = self.compute_rel_rest_joints(None, batch_shape=(bs,))
        dq = self.forward_arti(t_all, None,
                               override_local_rest_joints=torch.cat([rel_i, rel_c], dim=0))
        return (dq[0][:bs], dq[1][:bs]), (dq[0][bs:], dq[1][bs:])

    def get_mean_vals(self, inst_id=None):
        """Rest-pose bones: the articulation at the mean time embedding,
        with the bone lengths of instances inst_id (M,), batch (M,), or of
        the mean instance, batch (1,)."""
        t_embed = self.time_embedding.mean_embedding()
        if inst_id is not None:
            t_embed = t_embed.expand(inst_id.shape + t_embed.shape[-1:])
        return self.forward_arti(t_embed, inst_id)

    def skel_prior_loss(self):
        """L2 prior on the rest pose's joint angles and the bone-length
        increments."""
        so3 = self.compute_so3(self.time_embedding.mean_embedding())
        log_inc = self.log_bone_len(so3.new_zeros(so3.shape[:-2] + (0,)), None)
        return torch.mean(so3**2) + 0.02 * torch.mean(log_inc**2)

    def prior_fit_loss(self):
        """The init-time fit: MSE between the joint angles of every filtered
        frame and joint_angles_init."""
        so3 = self.get_vals(None, return_so3=True)
        return torch.mean((so3 - self.joint_angles_init) ** 2)
