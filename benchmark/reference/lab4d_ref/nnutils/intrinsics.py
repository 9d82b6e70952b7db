"""Camera intrinsics MLP. Port of lab4d_tpu/nnutils/intrinsics.py."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo
from benchmark.reference.lab4d_ref.nnutils.linear import TorchDense
from benchmark.reference.lab4d_ref.nnutils.time_mlp import TimeMLP


class IntrinsicsMLP(TimeMLP):
    """Time-varying intrinsics (fx, fy, cx, cy) with per-video base values;
    pixels are forced square by averaging fx and fy. `intrinsics_init`
    (M, 4), one per filtered frame, is the prior that
    compute_distance_to_prior fits to."""

    def __init__(self, frame_info: FrameInfo, num_freq_t: int = 0, time_scale: float = 0.1,
                 D: int = 5, W: int = 256, intrinsics_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(frame_info, D=D, W=W, num_freq_t=num_freq_t, time_scale=time_scale,
                         generator=generator)
        if intrinsics_init is not None:
            self.register_buffer(
                "intrinsics_init", torch.as_tensor(np.asarray(intrinsics_init, np.float32)),
                persistent=False,
            )
        self.focal_head = nn.ModuleList(
            [TorchDense(W, W // 2, generator), TorchDense(W // 2, 2, generator)]
        )
        self.base_logfocal = nn.Parameter(torch.zeros(frame_info.num_vids, 2))
        self.base_ppoint = nn.Parameter(torch.zeros(frame_info.num_vids, 2))

    def get_vals(self, frame_id=None):
        t_feat = self.forward_feat(self.time_embedding(frame_id))
        focal = torch.exp(self.focal_head[1](torch.relu(self.focal_head[0](t_feat))))
        inst_id = self.frame_ids_to_vid(frame_id)
        focal = focal * torch.exp(self.base_logfocal[inst_id])
        focal = (focal + focal.flip(-1)) / 2.0
        ppoint = self.base_ppoint[inst_id].expand(focal.shape)
        return torch.cat([focal, ppoint], dim=-1)

    def compute_distance_to_prior(self):
        return torch.mean((self.get_vals(None) - self.intrinsics_init) ** 2)


