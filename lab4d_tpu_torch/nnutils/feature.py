"""Feature-rendering NeRF with global matching. Port of
lab4d_tpu/nnutils/feature.py.

The canonical feature field lets training match pixel features against
canonical points (a soft argmax) and reproject the matches for the
feat_reproj loss. In training every per-point head (sdf -> density, rgb,
visibility, feature) runs in one pass through ops/field_kernel.py: the
kernels K1 / K2 on the card, their plain version on the CPU, from the same
packed nets.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lab4d_tpu_torch.nnutils.base import BaseMLP
from lab4d_tpu_torch.nnutils.embedding import PosEmbedding
from lab4d_tpu_torch.nnutils.nerf import NeRF
from lab4d_tpu_torch.ops.field_kernel import TILE_ROWS, FieldCfg, fused_nerf_heads
from lab4d_tpu_torch.parallel import dist
from lab4d_tpu_torch.utils.geom import Kmatinv, pinhole_projection, safe_norm


class FeatureNeRF(NeRF):
    """NeRF + a 16-channel normalized canonical feature field."""

    def __init__(self, category: str, **kwargs):
        super().__init__(category, **kwargs)
        self.feat_pos_embedding = PosEmbedding(3, 6)
        self.feature_field = BaseMLP(
            self.feat_pos_embedding.out_channels, D=5, W=128,
            out_channels=self.feature_channels, skips=(4,), generator=kwargs.get("generator"),
        )
        self.logsigma = nn.Parameter(torch.zeros(1))

    # ------------------------------------------------------- fused heads

    def query_all_heads(self, xyz, frame_id, inst_id, alpha):
        """Every per-point head at the canonical samples (M, N, D, 3) in one
        pass (fused_nerf_heads), or None where the field does not fit it."""
        if not self.field_kernel_ok(xyz):
            return None
        M, N, D = xyz.shape[:3]
        nets, cfg, appr, win_b, win_c, ibeta = self.pack_field_nets(frame_id, inst_id, alpha, M)
        density, rgb, vis, feature = fused_nerf_heads(
            xyz.reshape(-1, 3).contiguous(), appr, win_b, win_c, nets, ibeta, cfg, N * D)
        lead = xyz.shape[:-1]
        density = density.reshape(lead + (1,))
        return {
            "rgb": rgb.reshape(lead + (3,)),
            "density": density,
            f"density_{self.category}": density,
            "vis": vis.reshape(lead + (1,)),
            "feature": feature.reshape(lead + (self.feature_channels,)),
        }

    def field_kernel_ok(self, xyz) -> bool:
        """Whether the fused heads compute this field: one instance (its code
        folds into the biases), appearance rows as the only per-pair input,
        no direction encoding, sigmoid rgb, every xyz frequency ladder a
        prefix of the colour ladder, whole tiles of samples per pair (K1's
        TILE_ROWS on the card, 8 on the CPU); and a device with the kernel
        (CUDA) or its plain twin (the CPU)."""
        tile = TILE_ROWS if xyz.device.type == "cuda" else 8
        if not (
            xyz.device.type in ("cuda", "cpu")
            and self.num_inst == 1
            and self.appr_channels > 0
            and self.dir_embedding.n_freqs == -1
            and self.color_act
            and xyz.ndim == 4
            and (xyz.shape[1] * xyz.shape[2]) % tile == 0
        ):
            return False
        fb_c = self.pos_embedding_color.freq_bands
        for pe in (self.pos_embedding, self.vis_mlp.pos_embedding, self.feat_pos_embedding):
            n = pe.n_freqs
            if n <= 0 or n > len(fb_c) or not np.allclose(pe.freq_bands, fb_c[:n]):
                return False
        return True

    def pack_field_nets(self, frame_id, inst_id, alpha, M):
        """(nets, cfg, appr_rows, win_b, win_c, ibeta) for fused_nerf_heads:
        each head's weights and biases with the instance code folded into
        the biases (CondMLP.folded_params), in the (out, in) layout."""

        def interleave(ws, bs):
            return [t for wb in zip(ws, bs) for t in wb]

        def folded(cond_mlp, pe):
            ws, bs, _ = cond_mlp.folded_params(pe.out_channels, inst_id)
            return interleave(ws, bs)

        feat_w, feat_b, _ = self.feature_field.folded_params(self.feat_pos_embedding.out_channels)
        nets = dict(
            base=folded(self.basefield, self.pos_embedding),
            sdf=[self.sdf_head.weight, self.sdf_head.bias],
            color=folded(self.colorfield, self.pos_embedding_color),
            rgb1=[self.rgb_head[0].weight, self.rgb_head[0].bias],
            rgb2=[self.rgb_head[1].weight, self.rgb_head[1].bias],
            vis=folded(self.vis_mlp.basefield, self.vis_mlp.pos_embedding),
            feat=interleave(feat_w, feat_b),
        )
        cfg = FieldCfg(
            freqs=tuple(float(f) for f in self.pos_embedding_color.freq_bands),
            nf_base=self.pos_embedding.n_freqs,
            nf_color=self.pos_embedding_color.n_freqs,
            nf_vis=self.vis_mlp.pos_embedding.n_freqs,
            nf_feat=self.feat_pos_embedding.n_freqs,
            skips_base=self.basefield.backbone.skips,
            skips_color=self.colorfield.backbone.skips,
            skips_vis=self.vis_mlp.basefield.backbone.skips,
            skips_feat=self.feature_field.skips,
        )
        appr = self.appr_embedding.get_vals(frame_id).reshape(M, -1)
        win_b = self.pos_embedding.get_window(alpha)
        win_c = self.pos_embedding_color.get_window(alpha)
        return nets, cfg, appr, win_b, win_c, torch.exp(self.logibeta)

    # ------------------------------------------------------------ queries

    def query_field(self, samples_dict, alpha=None, train: bool = False, flow_thresh=None,
                    draws=None, topk=None, channels=None, beta_prob=None, swap=None):
        """NeRF.query_field plus, in training, the canonical feature and the
        global match of the pixel features (draws["match_idx"]: the (1024,)
        candidate sample ids) reprojected into the frame."""
        feat_dict, deltas, aux_dict = super().query_field(
            samples_dict, alpha=alpha, train=train, flow_thresh=flow_thresh, draws=draws,
            topk=topk, channels=channels, beta_prob=beta_prob, swap=swap)
        if not train:
            return feat_dict, deltas, aux_dict
        xyz = feat_dict["xyz"]
        if "feature" not in feat_dict:
            feat_dict.update(self.compute_feat(xyz))
        if "feature" in samples_dict:
            xyz_matches = self.global_match(samples_dict["feature"], xyz, draws["match_idx"])
            xy_reproj, xyz_reproj = self.forward_project(
                xyz_matches, samples_dict["field2cam"], samples_dict["Kinv"],
                samples_dict["frame_id"], samples_dict["inst_id"], samples_dict=samples_dict)
            aux_dict.update(xyz_matches=xyz_matches, xyz_reproj=xyz_reproj, xy_reproj=xy_reproj)
        return feat_dict, deltas, aux_dict

    def eval_extra_heads(self, xyz):
        return self.compute_feat(xyz, fused=False)

    def compute_feat(self, xyz, fused=None):
        """Normalized canonical feature at points."""
        freqs = self.feat_pos_embedding.pe_spec()
        if freqs is None:
            feat = self.feature_field(self.feat_pos_embedding(xyz), fused=fused)
        else:
            feat = self.feature_field(xyz, pe_spec=freqs, fused=fused)
        return {"feature": feat / torch.clamp(safe_norm(feat), min=1e-6)}

    def global_match(self, feat_px, xyz_canonical, idx):
        """Soft-argmax match of pixel features (M, N, C) against the
        canonical samples at the ids `idx` ((k,), drawn with replacement);
        the candidates' features are evaluated anew through the plain
        feature MLP. Returns (M, N, 3) matched points.

        Where the samples are one rank's block of a sharded batch
        (parallel/dist.py), the ids are the global batch's samples', and
        each candidate comes from the rank that holds it (all_gather, its
        gradient carried back there): every rank matches against the
        global batch's candidate set."""
        shape = feat_px.shape
        feat_px = feat_px.reshape(-1, shape[-1])
        xyz_canonical = xyz_canonical.reshape(-1, 3)
        total = xyz_canonical.shape[0]
        rank, world = dist.batch_shards()
        if world > 1:
            local = idx.to(xyz_canonical.device) - rank * total
            mine = ((local >= 0) & (local < total))[:, None]
            held = torch.where(mine, xyz_canonical[local.clamp(0, total - 1)], 0.0)
            xyz_c = dist.all_gather(held).sum(0)  # one rank holds each, the others add 0
        else:
            xyz_c = xyz_canonical[idx]
        feat_c = self.compute_feat(xyz_c, fused=False)["feature"]
        prob = torch.softmax(feat_px @ feat_c.t() * torch.exp(self.logsigma), dim=-1)
        return (prob @ xyz_c).reshape(shape[:-1] + (3,))

    def forward_project(self, xyz, field2cam, Kinv, frame_id, inst_id, samples_dict=None):
        """Matched canonical points (M, N, 3) re-articulated into the camera
        and projected: (xy (M, N, 2), camera points (M, N, 3))."""
        xyz_cam = self.forward_warp(xyz[:, :, None], field2cam, frame_id, inst_id,
                                    samples_dict=samples_dict)[:, :, 0]
        xy_reproj = pinhole_projection(Kmatinv(Kinv), xyz_cam)[..., :2]
        return xy_reproj, xyz_cam
