"""Warp fields. Port of lab4d_tpu/nnutils/warping.py: the identity warp
of a rigid object and the skeleton warp (neural blend skinning).
Interface: warp(xyz, frame_id, inst_id, backward=..., samples_dict=...)
-> (xyz_out, aux_dict).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from lab4d_tpu_torch.nnutils.pose import ArticulationSkelMLP
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


class SkinningWarp(nn.Module):
    """Skeleton articulation + Gaussian skinning + dual-quaternion blend."""

    def __init__(self, frame_info: FrameInfo, skel_type: str = "quad",
                 init_gauss_scale: float = 0.03, init_beta: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.frame_info = frame_info
        self.skel_type = skel_type
        self.articulation = ArticulationSkelMLP(frame_info, skel_type=skel_type,
                                                generator=generator)
        skeleton = self.articulation.skeleton
        self.skinning_model = SkinningField(
            skeleton.num_joints, frame_info, num_inst=frame_info.num_vids,
            init_scale=init_gauss_scale, symm_idx=skeleton.symm_idx, generator=generator,
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


def parse_warp_type(fg_motion: str) -> Dict:
    """fg_motion string -> warp class + kwargs. rigid and the skeleton warps
    are ported; dense, nvp, bob and comp_* wait on ROADMAP.md queue 1, item 6."""
    if fg_motion == "rigid":
        return {"cls": IdentityWarp, "kwargs": {}}
    if fg_motion.startswith("skel-"):
        return {"cls": SkinningWarp, "kwargs": {"skel_type": fg_motion.split("-")[1]}}
    raise NotImplementedError(
        f"fg_motion {fg_motion!r} is not ported yet (ROADMAP.md, queue 1, item 6)"
    )
