"""Deformable (dynamic) field = FeatureNeRF + warp field.

Port of lab4d_tpu/nnutils/deformable.py, eval side.
"""

from __future__ import annotations

import torch

from lab4d_tpu_torch.nnutils.feature import FeatureNeRF
from lab4d_tpu_torch.nnutils.warping import parse_warp_type


class Deformable(FeatureNeRF):
    """The backward warp un-articulates time-t points to the canonical
    frame; articulations are computed once per batch in get_samples."""

    def __init__(self, category: str, fg_motion: str = "skel-quad", **kwargs):
        super().__init__(category, **kwargs)
        self.fg_motion = fg_motion
        spec = parse_warp_type(fg_motion)
        self.warp = spec["cls"](self.frame_info, generator=kwargs.get("generator"),
                                **spec["kwargs"])

    def backward_warp(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples_dict=None):
        """Camera -> time-t object space -> canonical."""
        xyz_t, dir = self.cam_to_field(xyz_cam, dir_cam, field2cam)
        xyz, warp_dict = self.warp(xyz_t, frame_id, inst_id, backward=True,
                                   samples_dict=samples_dict)
        return {"xyz": xyz, "dir": dir, "xyz_t": xyz_t, **warp_dict}

    def forward_warp(self, xyz, field2cam, frame_id, inst_id, samples_dict=None):
        """Canonical -> time-t -> camera."""
        xyz_next, _ = self.warp(xyz, frame_id, inst_id, backward=False,
                                samples_dict=samples_dict)
        return self.field_to_cam(xyz_next, field2cam)

    def get_samples(self, Kinv, batch):
        """Adds the time-t and rest articulations (one batched FK)."""
        samples_dict = super().get_samples(Kinv, batch)
        (
            samples_dict["t_articulation"],
            samples_dict["rest_articulation"],
        ) = self.warp.articulation.get_vals_and_mean(samples_dict["frame_id"])
        return samples_dict

    def query_field(self, samples_dict):
        feat_dict, deltas, aux_dict = super().query_field(samples_dict)
        feat_dict.update(self.compute_gauss_density(feat_dict["xyz"], samples_dict))
        return feat_dict, deltas, aux_dict

    def compute_gauss_density(self, xyz, samples_dict):
        """Bone-Gaussian density along rays (gauss_mask channel)."""
        shape = xyz.shape[:-1]
        rest = samples_dict["rest_articulation"]
        density = self.warp.get_gauss_density(xyz.reshape(-1, 3), bone2obj=(rest[0][:1], rest[1][:1]))
        density = density * torch.exp(self.warp.logibeta)
        return {"gauss_density": density.reshape(shape + (1,))}
