"""Global appearance code over time. Port of lab4d_tpu/nnutils/appearance.py."""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo
from benchmark.reference.lab4d_ref.nnutils.linear import TorchDense
from benchmark.reference.lab4d_ref.nnutils.time_mlp import TimeMLP


class AppearanceEmbedding(TimeMLP):
    """Per-frame appearance code (shadow / lighting / exposure)."""

    def __init__(self, frame_info: FrameInfo, appr_channels: int = 32, D: int = 2, W: int = 64,
                 num_freq_t: int = 6, time_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, D=D, W=W, num_freq_t=num_freq_t, time_scale=time_scale,
                         generator=generator)
        self.output = TorchDense(W, appr_channels, generator)

    def get_vals(self, frame_id=None):
        return self.output(self.forward_feat(self.time_embedding(frame_id)))
