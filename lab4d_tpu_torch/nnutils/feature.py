"""Feature-rendering NeRF. Port of lab4d_tpu/nnutils/feature.py (eval
side: the canonical feature channel; global matching is training only)."""

from __future__ import annotations

import torch
from torch import nn

from lab4d_tpu_torch.nnutils.base import BaseMLP
from lab4d_tpu_torch.nnutils.embedding import PosEmbedding
from lab4d_tpu_torch.nnutils.nerf import NeRF
from lab4d_tpu_torch.utils.geom import safe_norm


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
