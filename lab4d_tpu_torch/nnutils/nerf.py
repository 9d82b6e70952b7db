"""Static VolSDF neural field: the eval path.

Port of lab4d_tpu/nnutils/nerf.py for rendering: sample assembly, the
exact merged two-pass eval (`query_field_eval`, every sample evaluated,
both halves merged by depth sort), camera-space normals from the SDF
input gradient, and the canonical-aabb validity mask. Training branches
(eikonal subsample, flow, regularizers) and the top-k eval are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from lab4d_tpu_torch.nnutils.appearance import AppearanceEmbedding
from lab4d_tpu_torch.nnutils.base import CondMLP, embed_cond_mlp
from lab4d_tpu_torch.nnutils.embedding import FrameInfo, PosEmbedding
from lab4d_tpu_torch.nnutils.linear import TorchDense
from lab4d_tpu_torch.nnutils.pose import CameraMLP
from lab4d_tpu_torch.nnutils.visibility import VisField
from lab4d_tpu_torch.ops.renderer import compute_weights, sample_cam_rays, sample_pdf
from lab4d_tpu_torch.utils.geom import (
    apply_se3mat,
    check_inside_aabb,
    extend_aabb,
    get_near_far,
    safe_norm,
)
from lab4d_tpu_torch.utils.quat import (
    dual_quaternion_to_quaternion_translation,
    quaternion_translation_inverse,
    quaternion_translation_to_se3,
)


class NeRF(nn.Module):
    """A static SDF + appearance field with camera/visibility submodules."""

    def __init__(self, category: str, frame_info: FrameInfo = None, num_inst: int = 1, D: int = 5,
                 W: int = 128, num_freq_xyz: int = 10, num_freq_dir: int = 4,
                 appr_channels: int = 32, appr_num_freq_t: int = 6, inst_channels: int = 32,
                 skips: tuple = (4,), init_beta: float = 0.1, init_scale: float = 0.1,
                 color_act: bool = True, feature_channels: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.category = category
        self.frame_info = frame_info
        self.num_inst = num_inst
        self.W = W
        self.appr_channels = appr_channels
        self.color_act = color_act
        self.feature_channels = feature_channels
        g = generator
        self.pos_embedding = PosEmbedding(3, num_freq_xyz)
        self.dir_embedding = PosEmbedding(3, num_freq_dir)
        self.basefield = CondMLP(
            num_inst, self.pos_embedding.out_channels, D=D, W=W,
            inst_channels=inst_channels, out_channels=W, skips=skips, final_act=True, generator=g,
        )
        self.pos_embedding_color = PosEmbedding(3, num_freq_xyz + 2)
        self.colorfield = CondMLP(
            num_inst, self.pos_embedding_color.out_channels, D=2, W=W,
            inst_channels=inst_channels, out_channels=W, skips=skips, final_act=True, generator=g,
        )
        if appr_channels > 0:
            self.appr_embedding = AppearanceEmbedding(
                frame_info, appr_channels=appr_channels, num_freq_t=appr_num_freq_t, generator=g
            )
        self.sdf_head = TorchDense(W, 1, g)
        rgb_in = W + self.dir_embedding.out_channels + appr_channels
        self.rgb_head = nn.ModuleList([TorchDense(rgb_in, W // 2, g), TorchDense(W // 2, 3, g)])
        self.logibeta = nn.Parameter(torch.full((1,), float(-np.log(init_beta))))
        self.logscale = nn.Parameter(torch.full((1,), float(np.log(init_scale))))
        self.camera_mlp = CameraMLP(frame_info, generator=g)
        self.vis_mlp = VisField(num_inst, generator=g)

    # ------------------------------------------------------------------ core

    def forward(self, xyz, dir=None, frame_id=None, inst_id=None, get_density: bool = True,
                fused: Optional[bool] = None):
        """Field at canonical points: VolSDF density (or raw SDF), plus rgb
        when `dir` is given."""
        xyz_feat = embed_cond_mlp(self.basefield, self.pos_embedding, xyz, inst_id=inst_id,
                                  fused=fused)
        sdf = self.sdf_head(xyz_feat)
        if get_density:
            ibeta = torch.exp(self.logibeta)
            out = (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) * ibeta)) * ibeta
        else:
            out = sdf
        if dir is None:
            return out
        dir_embed = self.dir_embedding(dir)
        if self.appr_channels > 0:
            appr = self.appr_embedding.get_vals(frame_id)
            appr = appr.reshape(appr.shape[:1] + (1,) * (dir_embed.ndim - 2) + appr.shape[-1:])
            appr = appr.expand(dir_embed.shape[:-1] + appr.shape[-1:])
            appr_embed = torch.cat([dir_embed, appr], dim=-1)
        else:
            appr_embed = dir_embed
        xyz_feat = xyz_feat + embed_cond_mlp(self.colorfield, self.pos_embedding_color, xyz,
                                             inst_id=inst_id, fused=fused)
        rgb = self.rgb_head[1](torch.relu(self.rgb_head[0](torch.cat([xyz_feat, appr_embed], -1))))
        if self.color_act:
            rgb = torch.sigmoid(rgb)
        return rgb, out

    # ----------------------------------------------------------- ray queries

    def get_samples(self, Kinv, batch):
        """Per-ray eval metadata: camera pose (from the camera MLP unless
        batch["field2cam"] (N,7) overrides it) and near-far from the proxy
        corners."""
        frame_id = batch["frameid"]
        if "field2cam" in batch:
            f2c = batch["field2cam"]
            field2cam = (f2c[..., :4], f2c[..., 4:] * torch.exp(self.logscale))
        else:
            field2cam = self.camera_mlp.get_vals(frame_id)
        field2cam_mat = quaternion_translation_to_se3(field2cam[0], field2cam[1])
        samples_dict = {
            "Kinv": Kinv,
            "field2cam": field2cam,
            "frame_id": frame_id,
            "inst_id": batch["dataid"],
            "near_far": get_near_far(batch["proxy_corners"], field2cam_mat, tol_fac=1.5),
            "hxy": batch["hxy"],
        }
        if "aabb" in batch:
            samples_dict["aabb"] = batch["aabb"]
        return samples_dict

    def query_field(self, samples_dict):
        """Eval query: the exact merged two-pass path."""
        return self.query_field_eval(samples_dict)

    def eval_extra_heads(self, xyz):
        """Per-sample channels subclasses add at eval."""
        return {}

    def _warp_sdf_grad(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples_dict):
        """Backward warp + SDF at camera points, and the SDF's gradient
        with respect to the camera points (plain MLP chain, one
        reverse sweep). Returns (grad, detached backward-warp dict)."""
        with torch.enable_grad():
            pts = xyz_cam.detach().requires_grad_(True)
            bw = self.backward_warp(pts, dir_cam, field2cam, frame_id, inst_id,
                                    samples_dict=samples_dict)
            sdf = self.forward(bw["xyz"], inst_id=inst_id, get_density=False, fused=False)
            (g,) = torch.autograd.grad(sdf.sum(), pts)
        return g, {k: v.detach() for k, v in bw.items()}

    @staticmethod
    def _normal_from_grad(g):
        gnorm = safe_norm(g)
        eikonal = (gnorm - 1.0) ** 2
        n = g / torch.clamp(gnorm, min=1e-6)
        normal = torch.stack([n[..., 0], -n[..., 1], -n[..., 2]], dim=-1)  # ECON convention
        return eikonal, normal

    def compute_normal(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples_dict):
        """Eikonal term and camera-space normals at camera points."""
        g, _ = self._warp_sdf_grad(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                   samples_dict)
        return self._normal_from_grad(g)

    def eval_pass(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples_dict):
        """Every per-sample eval channel (heads and camera-space normals) at
        the given camera points."""
        g, backwarp_dict = self._warp_sdf_grad(xyz_cam, dir_cam, field2cam, frame_id,
                                               inst_id, samples_dict)
        eikonal, normal = self._normal_from_grad(g)
        xyz, dir, xyz_t = backwarp_dict["xyz"], backwarp_dict["dir"], backwarp_dict["xyz_t"]
        out = self.query_nerf(xyz, dir, frame_id, inst_id, fused=False)
        out["vis"] = self.vis_mlp(xyz, inst_id=inst_id, fused=False)
        out.update(self.eval_extra_heads(xyz))
        # the unmasked density drives the importance pdf
        out["density_raw"] = out["density"]
        valid = self.get_valid_mask(xyz, xyz_t, samples_dict)
        if valid is not None:
            for k in ("density", f"density_{self.category}"):
                out[k] = out[k] * valid[..., None]
        cyc_dict = self.cycle_loss(xyz)
        for k in cyc_dict:
            if k in backwarp_dict:
                out[k] = (cyc_dict[k] + backwarp_dict[k]) / 2
            else:
                out[k] = cyc_dict[k]
        out["eikonal"] = eikonal
        out["normal"] = normal
        out["xyz"] = xyz
        out["xyz_cam"] = xyz_cam
        return out

    def _fine_depth(self, density, deltas, depth):
        """Deterministic inverse-CDF depths (M,N,D,1) from a coarse pass."""
        weights, _ = compute_weights(density, deltas)
        half = depth.shape[2]
        depth_mid = 0.5 * (depth[:, :, :-1] + depth[:, :, 1:])
        R = depth.shape[0] * depth.shape[1]
        depth_fine = sample_pdf(depth_mid.reshape(R, half - 1),
                                weights.reshape(R, half)[:, 1:-1], half)
        return depth_fine.detach().reshape(depth.shape)

    def query_field_eval(self, samples_dict, n_depth: int = 64):
        """Two-pass importance rendering without recomputation: each pass
        evaluates every channel at its own half of the samples, and the
        halves are merged by depth sort."""
        Kinv = samples_dict["Kinv"]
        field2cam = samples_dict["field2cam"]
        frame_id = samples_dict["frame_id"]
        inst_id = samples_dict["inst_id"]
        near_far = samples_dict["near_far"]
        hxy = samples_dict["hxy"]
        half = n_depth // 2

        xyz_cam1, dir_cam1, deltas1, depth1 = sample_cam_rays(hxy, Kinv, near_far, n_depth=half)
        out1 = self.eval_pass(xyz_cam1, dir_cam1, field2cam, frame_id, inst_id, samples_dict)
        depth_fine = self._fine_depth(out1.pop("density_raw"), deltas1, depth1)
        xyz_cam2, dir_cam2, _, depth2 = sample_cam_rays(hxy, Kinv, near_far, depth=depth_fine)
        out2 = self.eval_pass(xyz_cam2, dir_cam2, field2cam, frame_id, inst_id, samples_dict)
        out2.pop("density_raw")

        depth_all = torch.cat([depth1, depth2], dim=2)  # (M,N,D,1)
        order = torch.argsort(depth_all[..., 0], dim=-1, stable=True)[..., None]
        feat_dict = {}
        for k in out1:
            v = torch.cat([out1[k], out2[k]], dim=2)
            feat_dict[k] = torch.gather(v, 2, order.expand(v.shape))
        depth_s = torch.gather(depth_all, 2, order)

        raydir = torch.einsum("mni,mji->mnj", hxy, Kinv)
        dir_norm = torch.linalg.norm(raydir, dim=-1, keepdim=True)
        deltas = depth_s[:, :, 1:] - depth_s[:, :, :-1]
        deltas = torch.cat([deltas, deltas[:, :, -1:]], dim=2) * dir_norm[:, :, None, :]
        feat_dict["depth"] = depth_s / torch.exp(self.logscale)  # world units
        return feat_dict, deltas, {}

    def get_valid_mask(self, xyz, xyz_t, samples_dict):
        """(M,N,D) float mask of samples inside the extended canonical aabb;
        for articulated fields also time-t points inside the bone aabb."""
        if "aabb" not in samples_dict:
            return None
        valid = check_inside_aabb(xyz, extend_aabb(samples_dict["aabb"]))
        if "t_articulation" in samples_dict:
            t_bones = dual_quaternion_to_quaternion_translation(
                samples_dict["t_articulation"]
            )[1][0]
            t_aabb = torch.stack([t_bones.min(0).values, t_bones.max(0).values], 0)
            valid = valid & check_inside_aabb(xyz_t, extend_aabb(t_aabb, factor=1.0))
        return valid.to(xyz.dtype)

    def importance_sampling(self, hxy, Kinv, near_far, field2cam, frame_id, inst_id,
                            samples_dict, n_depth: int = 64):
        """Coarse-to-fine depths for rendering: a coarse pass of n_depth/2
        samples, n_depth/2 more from its weights, all sorted by depth."""
        xyz_cam, dir_cam, deltas, depth = sample_cam_rays(hxy, Kinv, near_far,
                                                          n_depth=n_depth // 2)
        xyz = self.backward_warp(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                 samples_dict)["xyz"]
        density = self.forward(xyz, frame_id=frame_id, inst_id=inst_id, fused=False)
        depth_fine = self._fine_depth(density, deltas, depth)
        depth_all = torch.sort(torch.cat([depth, depth_fine], dim=2), dim=2).values
        return sample_cam_rays(hxy, Kinv, near_far, depth=depth_all)

    def query_nerf(self, xyz, dir, frame_id, inst_id, fused=None):
        """Dense field evaluation on points flattened to (M, N*D, 3)."""
        lead = xyz.shape[:-1]
        M = xyz.shape[0]
        rgb, density = self.forward(
            xyz.reshape(M, -1, 3), dir=dir.reshape(M, -1, 3), frame_id=frame_id,
            inst_id=inst_id, fused=fused,
        )
        rgb = rgb.reshape(lead + rgb.shape[-1:])
        density = density.reshape(lead + density.shape[-1:])
        return {"rgb": rgb, "density": density, f"density_{self.category}": density}

    # -------------------------------------------------------------- warping

    @staticmethod
    def cam_to_field(xyz_cam, dir_cam, field2cam):
        """Rays from camera to object space."""
        q, t = quaternion_translation_inverse(field2cam[0], field2cam[1])
        q, t = q[:, None, None], t[:, None, None]
        return apply_se3mat((q, t), xyz_cam), apply_se3mat((q, torch.zeros_like(t)), dir_cam)

    @staticmethod
    def field_to_cam(xyz, field2cam):
        q, t = field2cam[0][:, None, None], field2cam[1][:, None, None]
        return apply_se3mat((q, t), xyz)

    def backward_warp(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples_dict=None):
        xyz, dir = self.cam_to_field(xyz_cam, dir_cam, field2cam)
        return {"xyz": xyz, "dir": dir, "xyz_t": xyz}

    def forward_warp(self, xyz, field2cam, frame_id, inst_id, samples_dict=None):
        return self.field_to_cam(xyz, field2cam)

    def cycle_loss(self, xyz):
        """Eval-time cycle channels: zeros (the cycle warp runs only in
        training)."""
        zeros = torch.zeros_like(xyz[..., :1])
        return {"cyc_dist": zeros, "delta_skin": zeros, "skin_entropy": zeros}
