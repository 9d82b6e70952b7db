"""Visibility field. Port of lab4d_tpu/nnutils/visibility.py."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.base import CondMLP, embed_cond_mlp
from benchmark.reference.lab4d_ref.nnutils.embedding import PosEmbedding


class VisField(nn.Module):
    """A visibility logit (-inf, +inf) for 3D canonical points."""

    def __init__(self, num_inst: int, D: int = 2, W: int = 64, num_freq_xyz: int = 10,
                 inst_channels: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pos_embedding = PosEmbedding(3, num_freq_xyz)
        self.basefield = CondMLP(
            num_inst, self.pos_embedding.out_channels, D=D, W=W,
            inst_channels=inst_channels, out_channels=1, skips=(4,), generator=generator,
        )

    def forward(self, xyz: torch.Tensor, inst_id=None, fused=None):
        return embed_cond_mlp(self.basefield, self.pos_embedding, xyz, inst_id=inst_id,
                              fused=fused)
