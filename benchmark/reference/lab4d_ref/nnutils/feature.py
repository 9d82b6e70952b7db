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

import torch
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.base import BaseMLP
from benchmark.reference.lab4d_ref.nnutils.embedding import PosEmbedding
from benchmark.reference.lab4d_ref.nnutils.nerf import NeRF
from benchmark.reference.lab4d_ref.parallel import dist
from benchmark.reference.lab4d_ref.utils.geom import Kmatinv, pinhole_projection, safe_norm


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
        """None: every head runs through the per-head plain path of NeRF."""
        return None

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
