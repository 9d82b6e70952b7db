"""Static VolSDF neural field.

Port of lab4d_tpu/nnutils/nerf.py. Eval: sample assembly, the exact
merged two-pass eval (`query_field_eval`, every sample evaluated, both
halves merged by depth sort), the top-k eval (`query_field_eval_topk`:
density and weights from all 64 union samples, the heavy channels at the
k highest-weight samples of each ray), channel subsets (`channels`: the
producers of unrequested channels are skipped), camera-space normals from
the SDF input gradient, and the canonical-aabb validity mask. Training
(`query_field(train=True)`): 64 deterministic samples per ray, the field
heads through the fused kernels (all heads in one kernel where a subclass's
`query_all_heads` takes them), the flow to the paired frame, the
subsampled eikonal term (a double backward through the plain MLP chain),
and the visibility-decay and camera-prior regularizers. The random draws
of training (the eikonal ray subsample, the visibility-decay points and
instance ids) accept injected values, so that a test can hand both
packages the same draw.

The top-k eval and the channel subset are explicit arguments (`topk`,
`channels`) where the JAX package reads LAB4D_EVAL_TOPK and
LAB4D_EVAL_CHANNELS at trace time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.appearance import AppearanceEmbedding
from benchmark.reference.lab4d_ref.nnutils.base import CondMLP, embed_cond_mlp
from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo, PosEmbedding
from benchmark.reference.lab4d_ref.nnutils.linear import TorchDense
from benchmark.reference.lab4d_ref.nnutils.pose import CameraMLP
from benchmark.reference.lab4d_ref.nnutils.visibility import VisField
from benchmark.reference.lab4d_ref.ops.renderer import compute_weights, sample_cam_rays, sample_pdf
from benchmark.reference.lab4d_ref.parallel import dist
from benchmark.reference.lab4d_ref.utils.geom import (
    Kmatinv,
    apply_se3mat,
    check_inside_aabb,
    extend_aabb,
    get_near_far,
    pinhole_projection,
    safe_norm,
)
from benchmark.reference.lab4d_ref.utils.quat import (
    dual_quaternion_to_quaternion_translation,
    quaternion_translation_inverse,
    quaternion_translation_to_se3,
)


def wants(channels, *keys) -> bool:
    """Whether a channel subset (None: every channel) asks for any of keys."""
    return channels is None or any(k in channels for k in keys)


def topk_indices(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest weights along the last axis, in ascending
    order. Among equal weights the lower index wins, as in jax.lax.top_k:
    the rays that miss the object have all-zero weights, and the samples
    picked there set their depths and so every channel of the ray."""
    idx = torch.sort(weights, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.sort(idx, dim=-1).values


def flip_pair(x):
    """Swap consecutive entries along the leading axis:
    [x0, x1, x2, x3, ...] -> [x1, x0, x3, x2, ...]."""
    if isinstance(x, (tuple, list)):
        return type(x)(flip_pair(v) for v in x)
    if isinstance(x, dict):
        return {k: flip_pair(v) for k, v in x.items()}
    if x.shape[0] < 2:
        return x
    return x.reshape((x.shape[0] // 2, 2) + x.shape[1:]).flip(1).reshape(x.shape)


def _sorted_deltas(hxy, Kinv, depth_s):
    """Inter-sample distances along the rays of depth-sorted samples
    (M,N,D,1), as sample_cam_rays measures them."""
    raydir = torch.einsum("mni,mji->mnj", hxy, Kinv)
    dir_norm = torch.linalg.norm(raydir, dim=-1, keepdim=True)
    deltas = depth_s[:, :, 1:] - depth_s[:, :, :-1]
    return torch.cat([deltas, deltas[:, :, -1:]], dim=2) * dir_norm[:, :, None, :]


class NeRF(nn.Module):
    """A static SDF + appearance field with camera/visibility submodules."""

    def __init__(self, category: str, frame_info: FrameInfo = None, num_inst: int = 1, D: int = 5,
                 W: int = 128, num_freq_xyz: int = 10, num_freq_dir: int = 4,
                 appr_channels: int = 32, appr_num_freq_t: int = 6, inst_channels: int = 32,
                 skips: tuple = (4,), init_beta: float = 0.1, init_scale: float = 0.1,
                 color_act: bool = True, feature_channels: int = 16,
                 rtmat_init: Optional[np.ndarray] = None, eikonal_dense: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.category = category
        # the training eikonal as a dense (M,N,D,1) tensor, zero off the
        # subsampled rays: compose_fields packs the fields of comp along one
        # sample axis. The loss (a nonzero mean) is the compact one's.
        self.eikonal_dense = eikonal_dense
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
        self.camera_mlp = CameraMLP(frame_info, rtmat_init=rtmat_init, generator=g)
        self.vis_mlp = VisField(num_inst, generator=g)

    # ------------------------------------------------------------------ core

    def forward(self, xyz, dir=None, frame_id=None, inst_id=None, get_density: bool = True,
                alpha: Optional[float] = None, fused: Optional[bool] = None,
                beta_prob: Optional[float] = None, train: bool = False, swap=None):
        """Field at canonical points: VolSDF density (or raw SDF), plus rgb
        when `dir` is given. alpha: coarse-to-fine annealing progress of the
        positional encodings (None: full bands); beta_prob, train, swap: the
        instance-code swap of the base and colour MLPs in training
        (InstEmbedding; a swap draw each, in that order)."""
        swap_kw = dict(beta_prob=beta_prob, train=train, swap=swap)
        xyz_feat = embed_cond_mlp(self.basefield, self.pos_embedding, xyz, alpha=alpha,
                                  inst_id=inst_id, fused=fused, **swap_kw)
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
                                             alpha=alpha, inst_id=inst_id, fused=fused,
                                             **swap_kw)
        rgb = self.rgb_head[1](torch.relu(self.rgb_head[0](torch.cat([xyz_feat, appr_embed], -1))))
        if self.color_act:
            rgb = torch.sigmoid(rgb)
        return rgb, out

    # ----------------------------------------------------------- ray queries

    def get_samples(self, Kinv, batch, train: bool = False):
        """Per-ray metadata: camera pose (from the camera MLP unless
        batch["field2cam"] (N,7) overrides it) and near-far, from the
        per-frame table batch["near_far_table"] in training and from the
        proxy corners at eval."""
        frame_id = batch["frameid"]
        if "field2cam" in batch:
            f2c = batch["field2cam"]
            field2cam = (f2c[..., :4], f2c[..., 4:] * torch.exp(self.logscale))
        else:
            field2cam = self.camera_mlp.get_vals(frame_id)
        if train:
            near_far = batch["near_far_table"][frame_id]
        else:
            field2cam_mat = quaternion_translation_to_se3(field2cam[0], field2cam[1])
            near_far = get_near_far(batch["proxy_corners"], field2cam_mat, tol_fac=1.5)
        samples_dict = {
            "Kinv": Kinv,
            "field2cam": field2cam,
            "frame_id": frame_id,
            "inst_id": batch["dataid"],
            "near_far": near_far,
            "hxy": batch["hxy"],
        }
        if "feature" in batch:
            samples_dict["feature"] = batch["feature"]
        if "aabb" in batch:
            samples_dict["aabb"] = batch["aabb"]
        return samples_dict

    def query_field(self, samples_dict, alpha=None, train: bool = False, flow_thresh=None,
                    draws=None, topk: Optional[int] = None, channels=None, beta_prob=None,
                    swap=None):
        """Per-ray field channels: at eval the merged two-pass path, exact
        or top-k (see query_field_eval); in training, 64 samples per ray ->
        backward warp -> field heads (fused kernels) -> flow, cycle and
        eikonal channels. draws: the step's draws, {"eikonal_idx": (S,)
        ray ids, ...} (see compute_eikonal); beta_prob, swap: the instance-code swap of
        the field's heads where codes vary per row (NeRF.forward)."""
        if not train:
            return self.query_field_eval(samples_dict, topk=topk, channels=channels)
        Kinv = samples_dict["Kinv"]
        field2cam = samples_dict["field2cam"]
        frame_id = samples_dict["frame_id"]
        inst_id = samples_dict["inst_id"]
        hxy = samples_dict["hxy"]
        xyz_cam, dir_cam, deltas, depth = sample_cam_rays(hxy, Kinv, samples_dict["near_far"])
        backwarp_dict = self.backward_warp(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                           samples_dict=samples_dict)
        xyz, dir, xyz_t = backwarp_dict["xyz"], backwarp_dict["dir"], backwarp_dict["xyz_t"]
        feat_dict = self.query_all_heads(xyz, frame_id, inst_id, alpha)
        if feat_dict is None:
            feat_dict = self.query_nerf(xyz, dir, frame_id, inst_id, alpha=alpha,
                                        beta_prob=beta_prob, train=True, swap=swap)
            feat_dict["vis"] = self.vis_mlp(xyz, inst_id=inst_id)
        samples_dict = self.prepare_forward_warp(xyz, inst_id, samples_dict)
        flow_dict, cyc_dict = self.compute_flow_cycle(hxy, xyz, xyz_t, frame_id, inst_id,
                                                      field2cam, Kinv, samples_dict, flow_thresh)
        feat_dict.update(flow_dict)
        for k in cyc_dict:
            feat_dict[k] = (cyc_dict[k] + backwarp_dict[k]) / 2 if k in backwarp_dict else cyc_dict[k]
        feat_dict["eikonal"] = self.compute_eikonal(xyz, inst_id=inst_id, alpha=alpha,
                                                    idx=draws["eikonal_idx"])
        feat_dict["xyz"] = xyz
        feat_dict["xyz_cam"] = xyz_cam
        feat_dict["depth"] = depth / torch.exp(self.logscale)  # world units
        return feat_dict, deltas, {}

    def query_all_heads(self, xyz, frame_id, inst_id, alpha):
        """Hook for the fused field-heads kernel (FeatureNeRF); None: the
        per-module path."""
        return None

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

    def eval_pass(self, xyz_cam, dir_cam, field2cam, frame_id, inst_id, samples_dict,
                  channels=None):
        """Every per-sample eval channel (heads and camera-space normals) at
        the given camera points. channels: a subset (None: all); the
        producers of the channels it leaves out are skipped (the SDF
        gradient of normal and eikonal, vis, feature, the cycle channels),
        and every channel produced is the full pass's."""
        normal = None
        if wants(channels, "normal", "eikonal"):
            g, backwarp_dict = self._warp_sdf_grad(xyz_cam, dir_cam, field2cam, frame_id,
                                                   inst_id, samples_dict)
            eikonal, normal = self._normal_from_grad(g)
        else:
            backwarp_dict = self.backward_warp(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                               samples_dict=samples_dict)
        xyz, dir, xyz_t = backwarp_dict["xyz"], backwarp_dict["dir"], backwarp_dict["xyz_t"]
        out = self.query_nerf(xyz, dir, frame_id, inst_id, fused=False)
        if wants(channels, "vis"):
            out["vis"] = self.vis_mlp(xyz, inst_id=inst_id, fused=False)
        if wants(channels, "feature"):
            out.update(self.eval_extra_heads(xyz))
        # the unmasked density drives the importance pdf
        out["density_raw"] = out["density"]
        valid = self.get_valid_mask(xyz, xyz_t, samples_dict)
        if valid is not None:
            for k in ("density", f"density_{self.category}"):
                out[k] = out[k] * valid[..., None]
        if wants(channels, "cyc_dist"):
            cyc_dict = self.cycle_loss(xyz)
            for k in cyc_dict:
                if k in backwarp_dict:
                    out[k] = (cyc_dict[k] + backwarp_dict[k]) / 2
                else:
                    out[k] = cyc_dict[k]
        if normal is not None:
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

    def query_field_eval(self, samples_dict, n_depth: int = 64, topk: Optional[int] = None,
                         channels=None):
        """Two-pass importance rendering without recomputation: each pass
        evaluates every channel at its own half of the samples, and the
        halves are merged by depth sort. topk < n_depth: the top-k eval
        (query_field_eval_topk) instead. channels: see eval_pass."""
        if topk is not None and topk < n_depth:
            return self.query_field_eval_topk(samples_dict, n_depth=n_depth, topk=topk,
                                              channels=channels)
        Kinv = samples_dict["Kinv"]
        field2cam = samples_dict["field2cam"]
        frame_id = samples_dict["frame_id"]
        inst_id = samples_dict["inst_id"]
        near_far = samples_dict["near_far"]
        hxy = samples_dict["hxy"]
        half = n_depth // 2

        xyz_cam1, dir_cam1, deltas1, depth1 = sample_cam_rays(hxy, Kinv, near_far, n_depth=half)
        out1 = self.eval_pass(xyz_cam1, dir_cam1, field2cam, frame_id, inst_id, samples_dict,
                              channels)
        depth_fine = self._fine_depth(out1.pop("density_raw"), deltas1, depth1)
        xyz_cam2, dir_cam2, _, depth2 = sample_cam_rays(hxy, Kinv, near_far, depth=depth_fine)
        out2 = self.eval_pass(xyz_cam2, dir_cam2, field2cam, frame_id, inst_id, samples_dict,
                              channels)
        out2.pop("density_raw")

        depth_all = torch.cat([depth1, depth2], dim=2)  # (M,N,D,1)
        order = torch.argsort(depth_all[..., 0], dim=-1, stable=True)[..., None]
        feat_dict = {}
        for k in out1:
            v = torch.cat([out1[k], out2[k]], dim=2)
            feat_dict[k] = torch.gather(v, 2, order.expand(v.shape))
        depth_s = torch.gather(depth_all, 2, order)

        feat_dict["depth"] = depth_s / torch.exp(self.logscale)  # world units
        return feat_dict, _sorted_deltas(hxy, Kinv, depth_s), {}

    def query_field_eval_topk(self, samples_dict, n_depth: int = 64, topk: int = 16,
                              channels=None):
        """Top-k eval: density and integration weights from all n_depth
        union samples (warp and base field only), every other channel at
        the topk highest-weight samples of each ray. The selected weights
        are scaled to each ray's total mass, and the density returned for
        the selected samples is solved so that compute_weights over them
        gives those weights: the mask is the exact one, and the channels'
        values come from the k samples."""
        Kinv = samples_dict["Kinv"]
        field2cam = samples_dict["field2cam"]
        frame_id = samples_dict["frame_id"]
        inst_id = samples_dict["inst_id"]
        near_far = samples_dict["near_far"]
        hxy = samples_dict["hxy"]
        half = n_depth // 2

        def cheap_density(xyz_cam, dir_cam):
            bw = self.backward_warp(xyz_cam, dir_cam, field2cam, frame_id, inst_id,
                                    samples_dict=samples_dict)
            dens_raw = self.forward(bw["xyz"], inst_id=inst_id, get_density=True, fused=False)
            valid = self.get_valid_mask(bw["xyz"], bw["xyz_t"], samples_dict)
            return dens_raw, dens_raw if valid is None else dens_raw * valid[..., None]

        xyz_cam1, dir_cam1, deltas1, depth1 = sample_cam_rays(hxy, Kinv, near_far, n_depth=half)
        dens1_raw, dens1 = cheap_density(xyz_cam1, dir_cam1)
        # the fine depths come from the unmasked coarse pdf, as in the exact path
        depth_fine = self._fine_depth(dens1_raw, deltas1, depth1)
        xyz_cam2, dir_cam2, _, depth2 = sample_cam_rays(hxy, Kinv, near_far, depth=depth_fine)
        _, dens2 = cheap_density(xyz_cam2, dir_cam2)

        depth_all = torch.cat([depth1, depth2], dim=2)  # (M,N,D,1)
        order = torch.argsort(depth_all[..., 0], dim=-1, stable=True)[..., None]
        depth_s = torch.gather(depth_all, 2, order)
        dens_s = torch.gather(torch.cat([dens1, dens2], dim=2), 2, order)
        deltas_s = _sorted_deltas(hxy, Kinv, depth_s)
        w_all, _ = compute_weights(dens_s, deltas_s)  # (M,N,D)

        idx = topk_indices(w_all, topk)  # (M,N,K), depth order
        w_sel = torch.gather(w_all, -1, idx)
        depth_sel = torch.gather(depth_s[..., 0], -1, idx)[..., None]
        deltas_sel = torch.gather(deltas_s[..., 0], -1, idx)[..., None]
        mass_all = torch.sum(w_all, dim=-1, keepdim=True)
        mass_sel = torch.sum(w_sel, dim=-1, keepdim=True)
        w_sel = (w_sel * (mass_all / torch.clamp(mass_sel, min=1e-6))).detach()
        depth_sel = depth_sel.detach()

        xyz_cam_sel, dir_cam_sel, _, _ = sample_cam_rays(hxy, Kinv, near_far, depth=depth_sel)
        out = self.eval_pass(xyz_cam_sel, dir_cam_sel, field2cam, frame_id, inst_id,
                             samples_dict, channels)
        out.pop("density_raw")

        # alpha_k solves w_k = alpha_k * prod_{l<k} (1 - alpha_l) over the
        # selected samples
        cum_excl = torch.cumsum(w_sel, dim=-1) - w_sel
        alpha = torch.clamp(w_sel / torch.clamp(1.0 - cum_excl, min=1e-6), 0.0, 1.0 - 1e-6)
        dens_sel = -torch.log1p(-alpha)[..., None] / torch.clamp(deltas_sel, min=1e-12)
        for k in ("density", f"density_{self.category}"):
            out[k] = dens_sel
        out["depth"] = depth_sel / torch.exp(self.logscale)  # world units
        return out, deltas_sel, {}

    def get_valid_mask(self, xyz, xyz_t, samples_dict):
        """(M,N,D) float mask of samples inside the extended canonical aabb;
        for articulated fields also time-t points inside the bone aabb.
        Background fields are unmasked."""
        if self.category == "bg" or "aabb" not in samples_dict:
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

    def query_nerf(self, xyz, dir, frame_id, inst_id, alpha=None, fused=None, beta_prob=None,
                   train: bool = False, swap=None):
        """Dense field evaluation on points flattened to (M, N*D, 3)."""
        lead = xyz.shape[:-1]
        M = xyz.shape[0]
        rgb, density = self.forward(
            xyz.reshape(M, -1, 3), dir=dir.reshape(M, -1, 3), frame_id=frame_id,
            inst_id=inst_id, alpha=alpha, fused=fused, beta_prob=beta_prob, train=train,
            swap=swap,
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

    def prepare_forward_warp(self, xyz, inst_id, samples_dict):
        """Hook: state the flow and cycle warps share (none for a rigid
        field)."""
        return samples_dict

    def forward_warp(self, xyz, field2cam, frame_id, inst_id, samples_dict=None):
        return self.field_to_cam(xyz, field2cam)

    def cycle_loss(self, xyz, xyz_t=None, frame_id=None, inst_id=None, samples_dict=None,
                   train=False):
        """Cycle channels of a rigid field: zeros."""
        zeros = torch.zeros_like(xyz[..., :1])
        return {"cyc_dist": zeros, "delta_skin": zeros, "skin_entropy": zeros}

    # ------------------------------------------------------------ training

    def compute_flow(self, hxy, xyz, frame_id, inst_id, field2cam, Kinv, samples_dict,
                     flow_thresh=None):
        """Flow proposal: canonical points re-posed into the paired frame's
        camera and projected; (M,N,D,3) = (flow xy, valid)."""
        frame_id_next = flip_pair(frame_id)
        field2cam_next = flip_pair(field2cam)
        samples_next = flip_pair({k: v for k, v in samples_dict.items()
                                  if k in ("t_articulation", "rest_articulation")})
        xyz_cam_next = self.forward_warp(xyz, field2cam_next, frame_id_next, inst_id,
                                         samples_dict=samples_next)
        hxy_next = pinhole_projection(Kmatinv(flip_pair(Kinv)), xyz_cam_next)
        flow = (hxy_next - hxy[:, :, None])[..., :2]
        valid = xyz_cam_next[..., -1:] > 1e-6
        if flow_thresh is not None:
            valid = valid & (torch.linalg.norm(flow, dim=-1, keepdim=True) < float(flow_thresh))
        return {"flow": torch.cat([flow, valid.to(flow.dtype)], dim=-1)}

    def compute_flow_cycle(self, hxy, xyz, xyz_t, frame_id, inst_id, field2cam, Kinv,
                           samples_dict, flow_thresh=None):
        """Training-time flow proposal and cycle channels."""
        flow_dict = self.compute_flow(hxy, xyz, frame_id, inst_id, field2cam, Kinv, samples_dict,
                                      flow_thresh=flow_thresh)
        return flow_dict, self.cycle_loss(xyz, xyz_t, frame_id, inst_id, samples_dict, train=True)

    def compute_eikonal(self, xyz, inst_id=None, alpha=None, *, idx):
        """Eikonal term (|grad sdf| - 1)^2 at the samples of the rays `idx`
        ((S,) ray ids, a 1/16 of the rays drawn without replacement:
        engine/jax_streams.py eikonal_rays), in canonical space: (S, D, 1),
        or (M, N, D, 1) with zeros elsewhere for an eikonal_dense field.

        The SDF goes through the plain MLP chain (fused=False) because the
        loss differentiates its gradient once more. Where the rays are one
        rank's block of a sharded batch (parallel/dist.py), the ids are
        the global batch's and the rank evaluates those in its block."""
        M, N, Dd, _ = xyz.shape
        rank, world = dist.batch_shards()
        if world > 1:
            idx = idx.to(xyz.device)
            idx = idx[(idx >= rank * M * N) & (idx < (rank + 1) * M * N)] - rank * M * N
            if idx.numel() == 0:  # none of the global draw's rays is in this block
                return (xyz.new_zeros(M, N, Dd, 1) if self.eikonal_dense
                        else xyz.new_zeros(0, Dd, 1))
        xyz_s = xyz.reshape(M * N, Dd, 3)[idx].detach().requires_grad_(True)
        inst_s = None if inst_id is None else inst_id[:, None].expand(M, N).reshape(-1)[idx]
        with torch.enable_grad():
            sdf = self.forward(xyz_s, inst_id=inst_s, get_density=False, alpha=alpha,
                               fused=False)
            (g,) = torch.autograd.grad(sdf.sum(), xyz_s, create_graph=True)
        eik = (safe_norm(g, keepdim=False) - 1.0) ** 2  # (S, D)
        if self.eikonal_dense:
            return eik.new_zeros(M * N, Dd).index_copy(0, idx, eik).reshape(M, N, Dd, 1)
        return eik[..., None]

    @staticmethod
    def sample_points_aabb(u, aabb, extend_factor=1.0):
        """Points at unit-cube coordinates u (n, 3) in the extended aabb."""
        aabb = extend_aabb(aabb, factor=extend_factor)
        return aabb[0] + u * (aabb[1] - aabb[0])

    def visibility_decay_loss(self, aabb, u, inst_id):
        """Push visibility down at random points of the aabb. u: (n, 3)
        uniform draws, inst_id: (n,) instance ids (n = 512 in training)."""
        vis = self.vis_mlp(self.sample_points_aabb(u, aabb), inst_id=inst_id)
        return -F.logsigmoid(-vis).mean()

    def cam_prior_loss(self):
        return self.camera_mlp.compute_distance_to_prior()

    # a rigid field has no skinning, soft-deformation or skeleton terms
    def gauss_skin_consistency_loss(self, aabb, alpha=None, u=None):
        return self.logscale.new_zeros(())

    def soft_deform_loss(self, aabb, u=None, frame_id=None, inst_id=None):
        return self.logscale.new_zeros(())

    def skel_prior_loss(self):
        return self.logscale.new_zeros(())
