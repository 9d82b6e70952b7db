"""Top-level DVR model: fields container + intrinsics, the training
forward with its losses, and the eval entry. Port of
lab4d_tpu/engine/model.py.

Geometry state (aabb, per-frame near-far, proxy corners) arrives in
batch["geo"], as in the JAX package. The training forward takes the
schedule values of the step (`sched`, engine/schedules.py) and the step
index, from whose key it derives the step's random draws as the JAX
package does (engine/jax_streams.py); a test may hand in draws of its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.engine import jax_streams
from lab4d_tpu_torch.nnutils.embedding import FrameInfo, InstEmbedding
from lab4d_tpu_torch.nnutils.intrinsics import IntrinsicsMLP
from lab4d_tpu_torch.nnutils.multifields import MultiFields
from lab4d_tpu_torch.ops.renderer import render_pixel
from lab4d_tpu_torch.parallel import dist
from lab4d_tpu_torch.utils import jax_random as jr
from lab4d_tpu_torch.utils import profile
from lab4d_tpu_torch.utils.geom import K2inv, K2mat
from lab4d_tpu_torch.utils.loss import nonzero_count, nonzero_mean

# loss weights read from the config (flag names)
LOSS_WEIGHT_NAMES = (
    "mask_wt", "rgb_wt", "depth_wt", "flow_wt", "vis_wt", "feature_wt",
    "feat_reproj_wt", "reg_visibility_wt", "reg_eikonal_wt",
    "reg_deform_cyc_wt", "reg_delta_skin_wt", "reg_skin_entropy_wt",
    "reg_gauss_skin_wt", "reg_cam_prior_wt", "reg_skel_prior_wt",
    "reg_gauss_mask_wt", "reg_soft_deform_wt",
)
# loss terms that do not depend on the batch (regularizers at random points
# of the aabb, the priors): in a forward sharded over ranks each rank
# computes the same value, and only rank 0's enters the summed gradient
BATCH_FREE_TERMS = (
    "reg_visibility", "reg_soft_deform", "reg_gauss_skin", "reg_cam_prior", "reg_skel_prior",
)


def _safe_norm(d, eps=1e-12):
    """L2 norm over the last axis, differentiable at zero."""
    return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + eps)


class DVRModel(nn.Module):
    """Differentiable volume rendering model over one field, or the fg and
    bg fields composed (field_type "comp").

    The module is built on the CPU and then moved to `device` (the card
    unless the caller asks for the CPU). Its parameters are flax's init of
    the JAX model at PRNGKey(0), the JAX trainer's params key
    (jax_streams.init_params_like_jax), or torch draws from `generator`
    where one is given (tests that load params afterwards).
    Training needs the priors: intrinsics_init (M, 4) and rtmat_fg / rtmat_bg (M, 4, 4),
    and the skeleton's joint_angles_init (M, B, 3) where there is one,
    and takes train_res (the flow threshold, in pixels) and loss_weights
    ((flag name, value) pairs).
    """

    def __init__(self, frame_info: FrameInfo, field_type: str = "fg",
                 fg_motion: str = "skel-quad", num_inst: int = 1, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 intrinsics_init: Optional[np.ndarray] = None,
                 rtmat_fg: Optional[np.ndarray] = None, rtmat_bg: Optional[np.ndarray] = None,
                 train_res: int = 256, loss_weights=(),
                 joint_angles_init: Optional[np.ndarray] = None):
        super().__init__()
        self.frame_info = frame_info
        self.field_type = field_type
        self.num_inst = num_inst
        self.train_res = train_res
        self.loss_weights = dict(loss_weights)
        self.fields = MultiFields(frame_info, field_type=field_type, fg_motion=fg_motion,
                                  num_inst=num_inst, rtmat_fg=rtmat_fg, rtmat_bg=rtmat_bg,
                                  joint_angles_init=joint_angles_init, generator=generator)
        self.intrinsics = IntrinsicsMLP(frame_info, num_freq_t=0, intrinsics_init=intrinsics_init,
                                        generator=generator)
        self.register_buffer("frame_offset_raw", torch.as_tensor(frame_info.frame_offset_raw),
                             persistent=False)
        for name, m in self.named_modules():
            if isinstance(m, InstEmbedding):  # its flax scope, where its swaps draw
                m.scope = bridge.torch_to_flax_path(name + ".mapping.weight")[0][:-2]
        if generator is None:
            jax_streams.init_params_like_jax(self, jr.PRNGKey(0))
        self.to(device)

    def process_frameid(self, batch):
        batch["frameid"] = batch["frameid_sub"] + self.frame_offset_raw[batch["dataid"]]
        return batch

    @staticmethod
    def reshape_batch(batch):
        """Merge the (M, 2, ...) pair dim into the batch dim -> (2M, ...)."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, dict):
                out[k] = DVRModel.reshape_batch(v)
            elif torch.is_tensor(v) and v.ndim >= 2:
                out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
            else:
                out[k] = v
        return out

    def get_samples(self, batch, train: bool = False):
        if "Kinv" in batch:
            Kinv = batch["Kinv"]
        else:
            Kmat = self.intrinsics.get_vals(batch["frameid"])
            Kinv = K2inv(Kmat) @ K2mat(batch["crop2raw"])
        return self.fields.get_samples(Kinv, batch, train=train)

    def render_samples(self, samples_dict, topk=None, channels=None):
        multifields_dict, deltas_dict, _ = self.fields.query_multifields(
            samples_dict, topk=topk, channels=channels)
        return render_pixel(*self.fields.compose_fields(multifields_dict, deltas_dict))

    # -------------------------------------------------------------- training

    @profile.record_function("train.draws")
    def step_draws(self, batch, step: int, given=None):
        """The random draws of training step `step` on `batch` (this rank's
        block of the global batch inside sharded_batch()): the JAX
        package's draws from fold_in(PRNGKey(42), step) at the global
        batch's shape (jax_streams.training_draws), made on the host and
        moved to the device in one copy, with the entries of `given`
        ({cate: {name: array}}, a test's) in place of the derived ones."""
        _, world = dist.batch_shards()
        M, _, N = batch["hxy"].shape[:3]
        draws = jax_streams.training_draws(self, step, 2 * M * N * world,
                                           with_match="feature" in batch)
        for cate, d in (given or {}).items():
            draws[cate] = {**draws.get(cate, {}), **d}
        dev = batch["hxy"].device
        draws = jax_streams.to_device(draws, dev)
        return {c: {k: (torch.as_tensor(v).to(dev) if k != "swap" else v)
                    for k, v in d.items()} if isinstance(d, dict) else d
                for c, d in draws.items()}

    def forward(self, batch, sched, draws=None, step: int = 0):
        """Training forward of one batch of (M, 2, N, ...) frame pairs:
        returns the weighted, reduced loss terms {name: scalar}.

        sched: the step's schedule values; step: the step's index, from
        whose key the step's random draws derive (step_draws); draws:
        optional draws per field in place of those ({cate: {"eikonal_idx",
        "vis_u", "vis_inst", "match_idx", "gauss_u", "soft_u",
        "soft_frame", "soft_inst", "swap"}}; "swap": the instance-code
        swaps' (rand_id, u) pairs in the JAX package's call order).

        Inside parallel/dist.py's sharded_batch(), `batch` is this rank's
        block of a global batch, the draws (given or made) are the global
        batch's, and the terms returned are this rank's shares: summed over
        the ranks they are the terms of the one-process forward on the
        global batch, and so are their gradients."""
        draws = self.step_draws(batch, step, draws)
        batch = dict(batch)
        geo = batch.pop("geo")
        batch = self.reshape_batch(self.process_frameid(batch))
        batch["geo"] = geo
        samples_dict = self.get_samples(batch, train=True)
        multifields_dict, deltas_dict, aux_dict = self.fields.query_multifields(
            samples_dict, alpha=sched["alpha"], train=True, flow_thresh=self.train_res,
            draws=draws, beta_prob=sched["beta_prob"],
        )
        rendered = render_pixel(*self.fields.compose_fields(multifields_dict, deltas_dict))
        if len(multifields_dict) == 1:  # one field: its own render is the composed one
            aux_dict[next(iter(multifields_dict))].update(rendered)
        else:
            for cate in multifields_dict:
                aux_dict[cate].update(render_pixel(multifields_dict[cate], deltas_dict[cate]))
        if "xyz_matches" in aux_dict.get("fg", {}):
            rendered["xyz_matches"] = aux_dict["fg"]["xyz_matches"]
            rendered["xyz_reproj"] = aux_dict["fg"]["xyz_reproj"]
        loss_dict = {}
        self._recon_loss(loss_dict, rendered, aux_dict, batch)
        self._mask_losses(loss_dict, batch)
        self._reg_loss(loss_dict, rendered, aux_dict, batch, sched, draws)
        return self._apply_loss_weights(loss_dict, sched)

    @staticmethod
    def get_mask_balance_wt(mask, vis2d, is_detected):
        """Weights that balance positive and negative mask pixels."""
        mask = mask.float()
        vis2d = vis2d.float() * is_detected.float()[:, None, None]
        in_vis = (vis2d > 0).float()
        sums = torch.stack([torch.sum(mask * in_vis), torch.sum((1 - mask) * in_vis),
                            torch.sum(vis2d)])
        pos, neg, total = dist.global_sum(sums)  # over the global batch
        pos_wt = total / torch.clamp(pos, min=1e-6)
        neg_wt = total / torch.clamp(neg, min=1e-6)
        balanced = 0.5 * pos_wt * mask + 0.5 * neg_wt * (1 - mask)
        usable = (pos > 0) & (neg > 0)
        return torch.where(usable, balanced, torch.ones_like(balanced))

    def _recon_loss(self, loss_dict, rendered, aux_dict, batch):
        """comp: the fg mask (mask_fg, the fg share of the composed weights)
        against the segmentation and the composed mask against 1."""
        ft = self.field_type
        gt_mask = batch["mask"].float()
        fg_mask = rendered["mask_fg"] if ft == "comp" else rendered["mask"]
        if ft == "bg":
            loss_dict["mask"] = (rendered["mask"] - 1.0) ** 2
        else:
            wt = self.get_mask_balance_wt(batch["mask"], batch["vis2d"], batch["is_detected"])
            loss_dict["mask"] = (fg_mask - gt_mask) ** 2 * wt
            if ft == "comp":
                loss_dict["mask"] = loss_dict["mask"] + (rendered["mask"] - 1.0) ** 2
        fg = aux_dict.get("fg", {})
        if "feature" in fg:
            loss_dict["feature"] = _safe_norm(fg["feature"] - batch["feature"])
        if "xy_reproj" in fg:
            loss_dict["feat_reproj"] = _safe_norm(fg["xy_reproj"] - batch["hxy"][..., :2])
        loss_dict["rgb"] = (rendered["rgb"] - batch["rgb"]) ** 2
        loss_dict["depth"] = _safe_norm(rendered["depth"] - batch["depth"])
        if "flow" in rendered:
            loss_dict["flow"] = _safe_norm(rendered["flow"] - batch["flow"])
            loss_dict["flow"] = loss_dict["flow"] * (batch["flow_uct"] > 0).float()
        # visibility, bg down-weighted 100x
        vis_loss = 0.0
        for cate in aux_dict:
            v = aux_dict[cate]["vis"]
            vis_loss = vis_loss + (v * 0.01 if cate == "bg" else v)
        loss_dict["vis"] = vis_loss
        if "gauss_mask" in fg:
            loss_dict["reg_gauss_mask"] = (fg["gauss_mask"] - fg_mask.detach()) ** 2

    def _reg_loss(self, loss_dict, rendered, aux_dict, batch, sched, draws):
        aabbs = {cate: batch["geo"][cate]["aabb"] for cate in batch["geo"]}
        loss_dict["reg_visibility"] = self.fields.visibility_decay_loss(aabbs, draws)
        loss_dict["reg_eikonal"] = rendered["eikonal"]
        if "fg" in aux_dict:
            fg = aux_dict["fg"]
            loss_dict["reg_deform_cyc"] = fg["cyc_dist"]
            if "delta_skin" in fg:
                loss_dict["reg_delta_skin"] = fg["delta_skin"]
            loss_dict["reg_skin_entropy"] = fg["skin_entropy"]
        loss_dict["reg_soft_deform"] = self.fields.soft_deform_loss(aabbs, draws)
        loss_dict["reg_gauss_skin"] = self.fields.gauss_skin_consistency_loss(
            aabbs, alpha=sched["alpha"], draws=draws)
        loss_dict["reg_cam_prior"] = self.fields.cam_prior_loss()
        loss_dict["reg_skel_prior"] = self.fields.skel_prior_loss()

    def _mask_losses(self, loss_dict, batch):
        """Restrict the dense losses to the pixels each term applies to;
        reg_gauss_mask is left unmasked."""
        keys_ignore = ("reg_gauss_mask",)
        keys_allpix = ("mask",)
        keys_fg = ("feature", "feat_reproj")
        keys_type_specific = ("rgb", "depth", "flow", "vis")
        vis2d = batch["vis2d"].float()
        maskfg = batch["mask"].float()
        if self.field_type == "bg":
            mask = (1 - maskfg) * vis2d
        elif self.field_type == "fg":
            mask = maskfg * vis2d
        else:
            mask = vis2d
        for k, v in loss_dict.items():
            if k in keys_ignore:
                continue
            if k in keys_allpix:
                loss_dict[k] = v * vis2d
            elif k in keys_fg:
                loss_dict[k] = v * maskfg
            elif k in keys_type_specific:
                loss_dict[k] = v * mask
            else:
                raise ValueError(f"loss {k} not defined")
        is_det = batch["is_detected"].float()[:, None, None]
        for k in ("mask", "feature", "feat_reproj"):
            if k in loss_dict:
                loss_dict[k] = loss_dict[k] * is_det

    def _apply_loss_weights(self, loss_dict, sched):
        """Nonzero-mean reduce, then the flag weights and the scheduled
        factors."""
        px_unit_keys = ("flow", "feat_reproj")
        sched_factors = {
            "reg_cam_prior": sched["reg_cam_prior_factor"],
            "reg_eikonal": sched["reg_eikonal_factor"],
            "reg_skel_prior": sched["reg_skel_prior_factor"],
            "reg_gauss_mask": sched["reg_gauss_mask_factor"],
        }
        rank, world = dist.batch_shards()
        counts = {}
        if world > 1:  # a sharded batch: each per-row term's count over the global batch
            rows = [k for k in loss_dict if k not in BATCH_FREE_TERMS]
            total = dist.global_sum(torch.stack([nonzero_count(loss_dict[k]) for k in rows]))
            counts = dict(zip(rows, total))
        out = {}
        for k, v in loss_dict.items():
            v = nonzero_mean(v, counts.get(k))
            if world > 1 and k in BATCH_FREE_TERMS and rank != 0:
                v = v * 0.0
            if k in px_unit_keys:
                v = v / self.train_res
            if k + "_wt" in self.loss_weights:
                v = v * self.loss_weights[k + "_wt"]
            if k in sched_factors:
                v = v * sched_factors[k]
            out[k] = v
        return out

    # ------------------------------------------------------------------ eval

    def prepare_eval_samples(self, batch):
        """Per-frame half of eval: frame ids, camera/intrinsics MLPs, FK
        articulations, near-far from proxy corners. Run once per frame;
        ray chunks then stream through evaluate_rays."""
        batch = dict(batch)
        geo = batch.pop("geo")
        batch = self.process_frameid(batch)
        batch["geo"] = geo
        return self.get_samples(batch)

    def evaluate_rays(self, samples_dict, topk=None, channels=None):
        """Per-chunk half of eval: render the rays in samples_dict[cate]
        ["hxy"]. Every non-mask channel is blended with the rendered mask
        (render * mask + 0 * (1 - mask)).

        topk: the per-ray sample budget of the heavy channels (None or
        >= 64: exact every-sample eval; NeRF.query_field_eval_topk);
        channels: a subset of the channels (None: all), whose producers
        alone run and which alone are returned."""
        rendered = self.render_samples(samples_dict, topk=topk, channels=channels)
        mask = rendered["mask"]

        def blend(v):
            return v * (mask if v.ndim == mask.ndim else mask[..., 0])

        return {k: v if "mask" in k else blend(v) for k, v in rendered.items()
                if channels is None or k in channels}
