"""Container of neural fields. Port of lab4d_tpu/nnutils/multifields.py:
"fg" (Deformable), "bg" (a rigid NeRF), or "comp", both composed along
rays (compose_fields), each for eval and training."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.deformable import Deformable
from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo, SwapDraws
from benchmark.reference.lab4d_ref.nnutils.nerf import NeRF
from benchmark.reference.lab4d_ref.utils.quat import quaternion_translation_to_se3

INIT_SCALE = {"fg": 0.2, "bg": 0.1}  # object units per field unit at init


class MultiFields(nn.Module):
    """Dict of fields. "fg" -> Deformable: no directional encoding,
    appearance codes, init_scale 0.2, D=5 W=128. "bg" -> NeRF:
    num_freq_xyz 6, no directional encoding or appearance code, init_scale
    0.1, D=5 W=128.

    rtmat_fg / rtmat_bg: (M, 4, 4) camera priors in object units, scaled
    here to field units for the camera MLP's prior loss."""

    def __init__(self, frame_info: FrameInfo, field_type: str = "fg",
                 fg_motion: str = "skel-quad", num_inst: int = 1,
                 rtmat_fg: Optional[np.ndarray] = None, rtmat_bg: Optional[np.ndarray] = None,
                 joint_angles_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if field_type not in ("fg", "bg", "comp"):
            raise ValueError(f"field_type {field_type!r}: one of fg, bg, comp")
        self.field_type = field_type
        # comp packs both fields along one sample axis: dense eikonal tensors
        eikonal_dense = field_type == "comp"

        def prior(rtmat, cate):
            if rtmat is None:
                return None
            rtmat = np.array(rtmat, dtype=np.float32)
            rtmat[..., :3, 3] *= INIT_SCALE[cate]
            return rtmat

        fields = {}
        if field_type in ("fg", "comp"):
            fields["fg"] = Deformable(
                "fg", fg_motion=fg_motion, frame_info=frame_info, num_inst=num_inst, D=5,
                W=128, num_freq_dir=-1, appr_channels=32, init_scale=INIT_SCALE["fg"],
                rtmat_init=prior(rtmat_fg, "fg"), eikonal_dense=eikonal_dense,
                joint_angles_init=joint_angles_init, generator=generator,
            )
        if field_type in ("bg", "comp"):
            fields["bg"] = NeRF(
                "bg", frame_info=frame_info, num_inst=1, D=5, W=128, num_freq_xyz=6,
                num_freq_dir=0, appr_channels=0, init_scale=INIT_SCALE["bg"],
                rtmat_init=prior(rtmat_bg, "bg"), eikonal_dense=eikonal_dense,
                generator=generator,
            )
        self.field_params = nn.ModuleDict(fields)

    @property
    def categories(self):
        return ("fg", "bg") if self.field_type == "comp" else (self.field_type,)

    def get_samples(self, Kinv, batch, train: bool = False):
        """Per-field camera/articulation samples. batch["field2cam"] (a dict
        by category) overrides the camera MLP of the fields it names, the
        fg's alone when reanimate drives a comp model."""
        samples_dict = {}
        for cate in self.categories:
            batch_sub = dict(batch)
            batch_sub.pop("field2cam", None)
            if cate in batch.get("field2cam", {}):
                batch_sub["field2cam"] = batch["field2cam"][cate]
            if "geo" in batch:
                batch_sub.update(batch_sub.pop("geo")[cate])
            field = self.field_params[cate]
            samples_dict[cate] = field.get_samples(Kinv, batch_sub, train=train)
        return samples_dict

    def query_multifields(self, samples_dict, alpha=None, train: bool = False, flow_thresh=None,
                          draws=None, topk=None, channels=None, beta_prob=None):
        """Per-field query_field; topk and channels: the eval's (see
        NeRF.query_field_eval). In training, draws are the step's
        (DVRModel.step_draws: draws[cate] the field's, draws["swap_key"] the
        swap root) and beta_prob is the instance-code swap probability;
        each field's swap draws are draws[cate]["swap"] ((rand_id, u) pairs
        in call order) where given, else derived from the swap root."""
        multifields_dict, deltas_dict, aux_dict = {}, {}, {}
        for cate in self.categories:
            field = self.field_params[cate]
            if train:
                d = draws[cate]
                swap = SwapDraws(d.get("swap", ()), draws.get("swap_key"))
                out = field.query_field(samples_dict[cate], alpha=alpha, train=True,
                                        flow_thresh=flow_thresh, draws=d,
                                        beta_prob=beta_prob, swap=swap)
                # no training loss reads the integrated xyz / xyz_cam channels
                out[0].pop("xyz", None)
                out[0].pop("xyz_cam", None)
            else:
                out = field.query_field(samples_dict[cate], topk=topk, channels=channels)
            multifields_dict[cate], deltas_dict[cate], aux_dict[cate] = out
        return multifields_dict, deltas_dict, aux_dict

    @staticmethod
    def compose_fields(multifields_dict, deltas_dict):
        """Concatenate the fields along the sample axis, a channel that one
        field lacks as zeros there, and sort every channel and the deltas by
        depth (a stable sort: equal depths keep the fields' order, as
        jnp.argsort does). One field: the identity."""
        cates = list(multifields_dict)
        if len(cates) == 1:
            return multifields_dict[cates[0]], deltas_dict[cates[0]]
        keys = sorted({k for d in multifields_dict.values() for k in d})
        field_dict = {}
        for k in keys:
            ref = next(d[k] for d in multifields_dict.values() if k in d)
            field_dict[k] = torch.cat([multifields_dict[c].get(k, torch.zeros_like(ref))
                                       for c in cates], dim=2)
        deltas = torch.cat([deltas_dict[c] for c in cates], dim=2)
        order = torch.argsort(field_dict["depth"][..., 0], dim=-1, stable=True)[..., None]
        field_dict = {k: torch.gather(v, 2, order.expand(v.shape)) for k, v in field_dict.items()}
        return field_dict, torch.gather(deltas, 2, order.expand(deltas.shape))

    # ------------------------------------------------------------- reg terms

    def visibility_decay_loss(self, aabbs, draws):
        """draws: {cate: {"vis_u": (n, 3), "vis_inst": (n,)}}."""
        loss = 0.0
        for cate in self.categories:
            d = draws[cate]
            loss = loss + self.field_params[cate].visibility_decay_loss(
                aabbs[cate], u=d["vis_u"], inst_id=d["vis_inst"])
        return loss

    def cam_prior_loss(self):
        loss = 0.0
        for cate in self.categories:
            loss = loss + self.field_params[cate].cam_prior_loss()
        return loss

    def gauss_skin_consistency_loss(self, aabbs, alpha=None, draws=None):
        """draws: {cate: {"gauss_u": (2048, 3)}} where the field has
        skinning."""
        loss = 0.0
        for cate in self.categories:
            d = draws[cate]
            loss = loss + self.field_params[cate].gauss_skin_consistency_loss(
                aabbs[cate], alpha=alpha, u=d.get("gauss_u"))
        return loss

    def soft_deform_loss(self, aabbs, draws=None):
        """draws: {cate: {"soft_u": (1024, 3), "soft_frame": (1024,),
        "soft_inst": (1024,)}} where the field's warp is composed."""
        loss = 0.0
        for cate in self.categories:
            d = draws[cate]
            loss = loss + self.field_params[cate].soft_deform_loss(
                aabbs[cate], u=d.get("soft_u"), frame_id=d.get("soft_frame"),
                inst_id=d.get("soft_inst"))
        return loss

    def skel_prior_loss(self):
        loss = 0.0
        for cate in self.categories:
            loss = loss + self.field_params[cate].skel_prior_loss()
        return loss

    # ---------------------------------------------------------------- misc

    def get_cameras(self, frame_id=None):
        """World-unit object-to-camera matrices per field."""
        field2cam = {}
        for cate in self.categories:
            field = self.field_params[cate]
            quat, trans = field.camera_mlp.get_vals(frame_id)
            field2cam[cate] = quaternion_translation_to_se3(quat, trans / torch.exp(field.logscale))
        return field2cam

    def get_logscales(self):
        return {cate: torch.exp(self.field_params[cate].logscale) for cate in self.categories}
