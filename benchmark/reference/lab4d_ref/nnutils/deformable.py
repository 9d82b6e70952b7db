"""Deformable (dynamic) field = FeatureNeRF + warp field.

Port of lab4d_tpu/nnutils/deformable.py: the backward and forward warps
of every warp family (warping.parse_warp_type), the articulations of a
batch (one batched FK, or the joint angles batch["joint_so3"] that
reanimation gives), and the training terms: the flow and cycle warps
sharing one skinning pass (plain skinning warps only: the composed warp
post-warps each frame's points first), the gauss-skin consistency loss,
the skeleton prior and the soft-deformation loss of the composed warp. A
warp without skinning has no articulations, skinning terms or
bone-Gaussian density. The random draws of training (the gauss-skin
points; the soft-deformation points, frame ids and instance ids) accept
injected values.
"""

from __future__ import annotations

import torch

from benchmark.reference.lab4d_ref.nnutils.feature import FeatureNeRF
from benchmark.reference.lab4d_ref.nnutils.nerf import flip_pair, wants
from benchmark.reference.lab4d_ref.nnutils.warping import (
    ComposedWarp,
    SkinningWarp,
    cross_entropy_skin_loss,
    parse_warp_type,
)
from benchmark.reference.lab4d_ref.utils.geom import (
    Kmatinv,
    dual_quaternion_skinning_pair,
    pinhole_projection,
    safe_norm,
)
from benchmark.reference.lab4d_ref.utils.quat import dual_quaternion_inverse, dual_quaternion_mul


class Deformable(FeatureNeRF):
    """The backward warp un-articulates time-t points to the canonical
    frame; articulations are computed once per batch in get_samples."""

    def __init__(self, category: str, fg_motion: str = "skel-quad", joint_angles_init=None,
                 **kwargs):
        super().__init__(category, **kwargs)
        self.fg_motion = fg_motion
        spec = parse_warp_type(fg_motion)
        warp_kwargs = dict(spec["kwargs"])
        if issubclass(spec["cls"], SkinningWarp):  # the skeleton's joint-angle prior
            warp_kwargs["joint_angles_init"] = joint_angles_init
        self.warp = spec["cls"](self.frame_info, generator=kwargs.get("generator"),
                                **warp_kwargs)

    @property
    def has_skinning(self) -> bool:
        return isinstance(self.warp, SkinningWarp)

    # ------------------------------------------------------------- warping

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

    def prepare_forward_warp(self, xyz, inst_id, samples_dict):
        """The forward skin weights of the canonical samples, once for the
        flow and cycle warps: they depend on the points, the rest
        articulation, the mean time embedding and the instance only (not so
        for the composed warp, whose post-warp moves the points per frame)."""
        if type(self.warp) is not SkinningWarp:
            return samples_dict
        skin = self.warp.skinning_model(xyz, samples_dict["rest_articulation"], None, inst_id)
        return dict(samples_dict, fwd_skin=skin)

    # --------------------------------------------------------------- losses

    def cycle_loss(self, xyz, xyz_t=None, frame_id=None, inst_id=None, samples_dict=None,
                   train=False):
        """In training: canonical points warped forward to time t against
        the time-t points, and the forward warp's skinning terms; zeros at
        eval."""
        cyc_dict = super().cycle_loss(xyz)
        if not train:
            return cyc_dict
        xyz_cycled, warp_dict = self.warp(xyz, frame_id, inst_id, backward=False,
                                          samples_dict=samples_dict)
        cyc_dict["cyc_dist"] = safe_norm(xyz_cycled - xyz_t)
        cyc_dict.update(warp_dict)
        return cyc_dict

    def compute_flow_cycle(self, hxy, xyz, xyz_t, frame_id, inst_id, field2cam, Kinv,
                           samples_dict, flow_thresh=None):
        """The flow and cycle warps in one pass: both skin the same
        canonical points with the same cached forward skin weights, under
        the bones of frame t and of its paired frame
        (dual_quaternion_skinning_pair). Equal to compute_flow +
        cycle_loss, which it falls back to without the cache (the tests'
        reference)."""
        fwd_skin = samples_dict.get("fwd_skin")
        if fwd_skin is None:
            return super().compute_flow_cycle(hxy, xyz, xyz_t, frame_id, inst_id, field2cam, Kinv,
                                              samples_dict, flow_thresh)
        skin, delta = fwd_skin
        rest, t_art = samples_dict["rest_articulation"], samples_dict["t_articulation"]
        se3_cyc = dual_quaternion_mul(t_art, dual_quaternion_inverse(rest))
        se3_flow = dual_quaternion_mul(flip_pair(t_art), dual_quaternion_inverse(flip_pair(rest)))
        xyz_cyc, xyz_next = dual_quaternion_skinning_pair(se3_cyc, se3_flow, xyz,
                                                          torch.softmax(skin, dim=-1))
        cyc_dict = {
            "cyc_dist": safe_norm(xyz_cyc - xyz_t),
            "skin_entropy": cross_entropy_skin_loss(skin)[..., None],
        }
        if delta is not None:
            cyc_dict["delta_skin"] = torch.mean(delta**2, dim=-1, keepdim=True)
        else:
            cyc_dict["delta_skin"] = torch.zeros_like(cyc_dict["cyc_dist"])

        xyz_cam_next = self.field_to_cam(xyz_next, flip_pair(field2cam))
        hxy_next = pinhole_projection(Kmatinv(flip_pair(Kinv)), xyz_cam_next)
        flow = (hxy_next - hxy[:, :, None])[..., :2]
        valid = xyz_cam_next[..., -1:] > 1e-6
        if flow_thresh is not None:
            valid = valid & (torch.linalg.norm(flow, dim=-1, keepdim=True) < float(flow_thresh))
        return {"flow": torch.cat([flow, valid.to(flow.dtype)], dim=-1)}, cyc_dict

    def gauss_skin_consistency_loss(self, aabb, alpha=None, u=None):
        """BCE between the rest-pose bone-Gaussian density and the field's
        own (detached, clipped) density at points of the aabb, balanced
        between inside and outside. u: (n, 3) uniform draws (n = 2048 in
        training). Zero without skinning."""
        if not self.has_skinning:
            return self.logscale.new_zeros(())
        pts = self.sample_points_aabb(u, aabb, extend_factor=0.25)
        density_gauss = self.warp.get_gauss_density(pts)
        density = self.forward(pts, inst_id=None, get_density=True, alpha=alpha)
        density = torch.clamp((density / torch.exp(self.logibeta)).detach(), 0.0, 1.0)
        weight_pos = 0.5 / (1e-6 + density.mean())
        weight_neg = 0.5 / (1e-6 + (1 - density).mean())
        weight = density * weight_pos + (1 - density) * weight_neg
        dg = torch.clamp(density_gauss, 1e-6, 1 - 1e-6)
        bce = -(density * torch.log(dg) + (1 - density) * torch.log(1 - dg))
        return torch.mean(bce * weight)

    def soft_deform_loss(self, aabb, u=None, frame_id=None, inst_id=None):
        """The composed warp's post-warp displacement (compute_post_warp_dist2)
        at points of the aabb, random raw frames and instances. u: (n, 3)
        uniform draws, frame_id and inst_id: (n,) (n = 1024 in training).
        Zero for the other warps."""
        if not isinstance(self.warp, ComposedWarp):
            return self.logscale.new_zeros(())
        pts = self.sample_points_aabb(u, aabb, extend_factor=1.0)
        return self.warp.compute_post_warp_dist2(pts[:, None, None], frame_id, inst_id).mean()

    def skel_prior_loss(self):
        if not self.has_skinning:
            return self.logscale.new_zeros(())
        return self.warp.articulation.skel_prior_loss()

    # --------------------------------------------------------------- queries

    def get_samples(self, Kinv, batch, train: bool = False):
        """Adds the time-t and rest articulations of a skinning warp (one
        batched FK); with batch["joint_so3"] (M, B, 3) the time-t ones come
        from those joint angles (an empty one, a bag of bones' export, is
        ignored)."""
        samples_dict = super().get_samples(Kinv, batch, train=train)
        if not self.has_skinning:
            return samples_dict
        articulation = self.warp.articulation
        frame_id = samples_dict["frame_id"]
        if batch.get("joint_so3") is not None and batch["joint_so3"].numel() > 0:
            samples_dict["rest_articulation"] = articulation.get_mean_vals()
            samples_dict["t_articulation"] = articulation.get_vals(
                frame_id, override_so3=batch["joint_so3"])
        else:
            (
                samples_dict["t_articulation"],
                samples_dict["rest_articulation"],
            ) = articulation.get_vals_and_mean(frame_id)
        return samples_dict

    def query_field(self, samples_dict, alpha=None, train: bool = False, flow_thresh=None,
                    draws=None, topk=None, channels=None, beta_prob=None, swap=None):
        feat_dict, deltas, aux_dict = super().query_field(
            samples_dict, alpha=alpha, train=train, flow_thresh=flow_thresh, draws=draws,
            topk=topk, channels=channels, beta_prob=beta_prob, swap=swap)
        if train or wants(channels, "gauss_mask"):
            feat_dict.update(self.compute_gauss_density(feat_dict["xyz"], samples_dict))
        return feat_dict, deltas, aux_dict

    def compute_gauss_density(self, xyz, samples_dict):
        """Bone-Gaussian density along rays (gauss_mask channel); none
        without skinning."""
        if not self.has_skinning:
            return {}
        shape = xyz.shape[:-1]
        rest = samples_dict["rest_articulation"]
        density = self.warp.get_gauss_density(xyz.reshape(-1, 3), bone2obj=(rest[0][:1], rest[1][:1]))
        density = density * torch.exp(self.warp.logibeta)
        return {"gauss_density": density.reshape(shape + (1,))}
