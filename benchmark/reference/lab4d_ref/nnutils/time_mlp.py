"""Time-conditioned MLP base. Port of lab4d_tpu/nnutils/time_mlp.py."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.base import BaseMLP
from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo, TimeEmbedding


def scale_num_freq_t(num_freq_t: int, frame_info: FrameInfo) -> int:
    """64 frames -> num_freq_t; doubling the frames adds one octave."""
    if num_freq_t <= 0:
        return num_freq_t
    max_ts = int((frame_info.frame_offset[1:] - frame_info.frame_offset[:-1]).max())
    return int(np.rint(np.log2(max_ts / 64) + num_freq_t))


class TimeMLP(nn.Module):
    """MLP over a learned time embedding; subclasses add output heads.
    The backbone runs through the fused kernel on a CUDA tensor."""

    def __init__(self, frame_info: FrameInfo, D: int = 5, W: int = 256, num_freq_t: int = 6,
                 skips: tuple = (), time_scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.frame_info = frame_info
        self.W = W
        self.time_embedding = TimeEmbedding(
            scale_num_freq_t(num_freq_t, frame_info), frame_info, out_channels=W,
            time_scale=time_scale, generator=generator,
        )
        self.backbone = BaseMLP(W, D=D, W=W, out_channels=W, skips=skips, final_act=True,
                                generator=generator)
        fi = frame_info
        self.register_buffer("frame_to_vid", torch.as_tensor(fi.frame_to_vid), persistent=False)
        self.register_buffer("raw_fid_to_vid", torch.as_tensor(fi.raw_fid_to_vid),
                             persistent=False)

    def forward_feat(self, t_embed: torch.Tensor) -> torch.Tensor:
        return self.backbone(t_embed)

    def frame_ids_to_vid(self, frame_id):
        if frame_id is None:
            return self.frame_to_vid
        return self.raw_fid_to_vid[frame_id]
