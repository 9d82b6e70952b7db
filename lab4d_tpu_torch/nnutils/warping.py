"""Warp fields. Port of lab4d_tpu/nnutils/warping.py: the identity warp
of a rigid object, the dense translation fields (separate forward and
backward maps), the invertible NVP warp, neural blend skinning over a bag
of bones or a skeleton, and a skeleton warp composed with a soft dense
post-warp. Interface: warp(xyz, frame_id, inst_id, backward=...,
samples_dict=...) -> (xyz_out, aux_dict).

The dense maps are CondMLPs whose single instance code folds into the
biases, so on the card they run through the fused ReLU MLP kernels (K3f /
K3b) at one row per sample, as the JAX package runs fused_relu_mlp.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from lab4d_tpu_torch.nnutils.base import CondMLP
from lab4d_tpu_torch.nnutils.embedding import FrameInfo, PosEmbedding, TimeEmbedding
from lab4d_tpu_torch.nnutils.nvp import NVP
from lab4d_tpu_torch.nnutils.pose import ArticulationFlatMLP, ArticulationSkelMLP
from lab4d_tpu_torch.nnutils.skinning import SkinningField
from lab4d_tpu_torch.utils.geom import dual_quaternion_skinning, get_xyz_bone_distance
from lab4d_tpu_torch.utils.quat import dual_quaternion_inverse, dual_quaternion_mul


def cross_entropy_skin_loss(skin: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of softmax(skin) against its argmax assignment:
    logsumexp(skin) - max(skin)."""
    return torch.logsumexp(skin, dim=-1) - skin.max(dim=-1).values


class IdentityWarp(nn.Module):
    """Rigid: no deformation and no parameters."""

    def __init__(self, frame_info: FrameInfo, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.frame_info = frame_info

    def forward(self, xyz, frame_id, inst_id, backward=False, samples_dict=None):
        return xyz, {}


def _per_sample(code, xyz):
    """Per-pair rows (M, C) -> (M, 1, ..., 1, C) against points (M, ..., 3)."""
    return code.reshape((-1,) + (1,) * (xyz.ndim - 2) + code.shape[-1:])


class DenseWarp(IdentityWarp):
    """D-NeRF-style translation fields: x + 0.1 * MLP([PE(x), time code]),
    one map forward and one backward."""

    def __init__(self, frame_info: FrameInfo, D: int = 6, W: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info)
        self.pos_embedding = PosEmbedding(3, 6)
        self.time_embedding = TimeEmbedding(6, frame_info, generator=generator)
        in_ch = self.pos_embedding.out_channels + self.time_embedding.out_channels
        self.forward_map = CondMLP(frame_info.num_vids, in_ch, D=D, W=W, out_channels=3,
                                   generator=generator)
        self.backward_map = CondMLP(frame_info.num_vids, in_ch, D=D, W=W, out_channels=3,
                                    generator=generator)

    def forward(self, xyz, frame_id, inst_id, backward=False, samples_dict=None):
        t_embed = _per_sample(self.time_embedding(frame_id), xyz)
        t_embed = t_embed.expand(xyz.shape[:-1] + t_embed.shape[-1:])
        embed = torch.cat([self.pos_embedding(xyz), t_embed], dim=-1)
        mlp = self.backward_map if backward else self.forward_map
        return xyz + mlp(embed, inst_id) * 0.1, {}


class NVPWarp(IdentityWarp):
    """Invertible warp: one RealNVP map forward, its inverse backward."""

    def __init__(self, frame_info: FrameInfo, generator: Optional[torch.Generator] = None):
        super().__init__(frame_info)
        self.time_embedding = TimeEmbedding(6, frame_info, generator=generator)
        self.map = NVP(self.time_embedding.out_channels, n_layers=2, generator=generator)

    def forward(self, xyz, frame_id, inst_id, backward=False, samples_dict=None):
        t_embed = _per_sample(self.time_embedding(frame_id), xyz)
        if backward:
            return self.map.inverse(t_embed, xyz), {}
        return self.map(t_embed, xyz), {}


class SkinningWarp(nn.Module):
    """Bag-of-bones ("flat": 25 free bones) or skeleton articulation +
    Gaussian skinning + dual-quaternion blend."""

    def __init__(self, frame_info: FrameInfo, skel_type: str = "quad",
                 init_gauss_scale: float = 0.03, init_beta: float = 0.01,
                 joint_angles_init=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.frame_info = frame_info
        self.skel_type = skel_type
        if skel_type == "flat":
            self.articulation = ArticulationFlatMLP(frame_info, generator=generator)
            symm_idx = None
        else:
            self.articulation = ArticulationSkelMLP(frame_info, skel_type=skel_type,
                                                    joint_angles_init=joint_angles_init,
                                                    generator=generator)
            symm_idx = self.articulation.skeleton.symm_idx
        self.skinning_model = SkinningField(
            self.articulation.num_se3, frame_info, num_inst=frame_info.num_vids, init_scale=init_gauss_scale,
            symm_idx=symm_idx, generator=generator,
        )
        self.logibeta = nn.Parameter(torch.full((1,), float(-np.log(init_beta))))

    def forward(self, xyz, frame_id, inst_id, backward=False, samples_dict=None):
        """Blend-skin points between the time-t and rest configurations."""
        samples_dict = samples_dict or {}
        if "rest_articulation" in samples_dict and "t_articulation" in samples_dict:
            rest_articulation = samples_dict["rest_articulation"]
            t_articulation = samples_dict["t_articulation"]
        else:
            t_articulation, rest_articulation = self.articulation.get_vals_and_mean(frame_id)
        if backward:
            se3 = dual_quaternion_mul(rest_articulation, dual_quaternion_inverse(t_articulation))
            articulation = t_articulation
        else:
            se3 = dual_quaternion_mul(t_articulation, dual_quaternion_inverse(rest_articulation))
            articulation = rest_articulation
            frame_id = None
        skin, delta_skin = self.skinning_model(xyz, articulation, frame_id, inst_id)
        out = dual_quaternion_skinning(se3, xyz, torch.softmax(skin, dim=-1))
        warp_dict: Dict[str, torch.Tensor] = {
            "skin_entropy": cross_entropy_skin_loss(skin)[..., None]
        }
        if delta_skin is not None:
            warp_dict["delta_skin"] = torch.mean(delta_skin**2, dim=-1, keepdim=True)
        return out, warp_dict

    def get_gauss_density(self, xyz, bone2obj=None):
        """Bone-sphere density: hard max over per-bone Gaussian scores of
        radius 0.01; bone2obj defaults to the rest pose."""
        if bone2obj is None:
            bone2obj = self.articulation.get_mean_vals()
        dist2 = get_xyz_bone_distance(xyz, bone2obj) / (0.01**2)
        return torch.exp(-0.5 * dist2).max(dim=-1).values[..., None]

    def get_gauss_sdf(self, xyz):
        """SDF-like field of the rest-pose bone spheres: -logit(density)."""
        density = torch.clamp(self.get_gauss_density(xyz), 1e-6, 1 - 1e-6)
        return -torch.logit(density)


class ComposedWarp(SkinningWarp):
    """Skeleton warp composed with a soft dense post-warp: the post-warp
    runs before skinning going forward and after it going backward."""

    def __init__(self, frame_info: FrameInfo, skel_type: str = "quad", post_warp_D: int = 2,
                 post_warp_W: int = 256, joint_angles_init=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, skel_type=skel_type, joint_angles_init=joint_angles_init,
                         generator=generator)
        self.post_warp = DenseWarp(frame_info, D=post_warp_D, W=post_warp_W, generator=generator)

    def forward(self, xyz, frame_id, inst_id, backward=False, samples_dict=None):
        if not backward and frame_id is not None:
            xyz, _ = self.post_warp(xyz, frame_id, inst_id, backward=False)
        out, warp_dict = super().forward(xyz, frame_id, inst_id, backward=backward,
                                         samples_dict=samples_dict)
        if backward and frame_id is not None:
            out, _ = self.post_warp(out, frame_id, inst_id, backward=True)
        return out, warp_dict

    def compute_post_warp_dist2(self, xyz, frame_id, inst_id):
        """Soft-deformation magnitude: the mean of |post(x) - x|^2 and the
        cycle |post(x) - post^-1(post(x))|^2."""
        xyz_t, _ = self.post_warp(xyz, frame_id, inst_id, backward=False)
        dist2 = torch.sum((xyz_t - xyz) ** 2, dim=-1)
        xyz_back, _ = self.post_warp(xyz_t, frame_id, inst_id, backward=True)
        return (dist2 + torch.sum((xyz_t - xyz_back) ** 2, dim=-1)) * 0.5


def parse_warp_type(fg_motion: str) -> Dict:
    """fg_motion string -> warp class + kwargs: rigid, dense, nvp, bob,
    skel-{human,quad}, comp_skel-{human,quad}_dense."""
    if fg_motion == "rigid":
        return {"cls": IdentityWarp, "kwargs": {}}
    if fg_motion == "dense":
        return {"cls": DenseWarp, "kwargs": {}}
    if fg_motion == "nvp":
        return {"cls": NVPWarp, "kwargs": {}}
    if fg_motion == "bob":
        return {"cls": SkinningWarp, "kwargs": {"skel_type": "flat"}}
    if fg_motion in ("skel-human", "skel-quad"):
        return {"cls": SkinningWarp, "kwargs": {"skel_type": fg_motion.split("-")[1]}}
    if fg_motion.startswith("comp"):
        parts = fg_motion.split("_")[1:]
        if len(parts) != 2 or parts[0] not in ("skel-human", "skel-quad") or parts[1] != "dense":
            raise ValueError(f"fg_motion {fg_motion!r}: only comp_skel-{{human,quad}}_dense")
        return {"cls": ComposedWarp, "kwargs": {"skel_type": parts[0].split("-")[1]}}
    raise NotImplementedError(fg_motion)
