"""Camera and skeleton-articulation MLPs. Port of lab4d_tpu/nnutils/pose.py.

Articulation outputs are dual quaternions ((M,B,4), (M,B,4)), bone->object.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lab4d_tpu_torch.nnutils.base import CondMLP
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from lab4d_tpu_torch.nnutils.linear import TorchDense
from lab4d_tpu_torch.nnutils.time_mlp import TimeMLP
from lab4d_tpu_torch.utils.quat import quaternion_mul
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
    per-video base rotations."""

    def __init__(self, frame_info: FrameInfo, generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, generator=generator)
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


class ArticulationSkelMLP(TimeMLP):
    """Skeleton articulation: joint angles -> FK -> bone dual quaternions."""

    def __init__(self, frame_info: FrameInfo, skel_type: str = "quad",
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, generator=generator)
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
        dq = fk_se3(local_rest, so3, self.skeleton)
        return shift_joints_to_bones_dq(dq, self.skeleton, shift=self.shift)

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
