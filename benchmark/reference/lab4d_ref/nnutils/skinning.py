"""Gaussian-bone skinning field. Port of lab4d_tpu/nnutils/skinning.py:
the quadratic-form path, which every warp of the training and render paths
takes, and the bone-coordinate path for the shapes it refuses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.base import CondMLP
from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo, PosEmbedding, TimeEmbedding
from benchmark.reference.lab4d_ref.utils.geom import get_bone_coords
from benchmark.reference.lab4d_ref.utils.quat import (
    dual_quaternion_to_quaternion_translation,
    quaternion_to_matrix,
)


class SkinningField(nn.Module):
    """skin = -(||x_bone / gauss||^2 + relu(delta) * 0.1) per bone, with
    delta from a time/instance-conditioned MLP over bone coordinates."""

    def __init__(self, num_coords: int, frame_info: FrameInfo = None, num_inst: int = 1,
                 D: int = 2, W: int = 64, num_freq_xyz: int = 0, num_freq_t: int = 6,
                 inst_channels: int = 32, init_scale: float = 0.03, delta_skin: bool = True,
                 symm_idx: Optional[tuple] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_coords = num_coords
        self.num_freq_xyz = num_freq_xyz
        self.delta_skin = delta_skin
        self.log_gauss = nn.Parameter(torch.full((num_coords, 3), float(np.log(init_scale))))
        self.register_buffer(
            "symm_idx", None if symm_idx is None else torch.as_tensor(symm_idx),
            persistent=False,
        )
        if delta_skin:
            self.pos_embedding = PosEmbedding(3 * num_coords, num_freq_xyz)
            self.time_embedding = TimeEmbedding(num_freq_t, frame_info, generator=generator)
            self.delta_field = CondMLP(
                num_inst, self.pos_embedding.out_channels, D=D, W=W,
                inst_channels=inst_channels, out_channels=num_coords, skips=(4,),
                row_channels=self.time_embedding.out_channels, generator=generator,
            )

    def get_gauss(self):
        log_gauss = self.log_gauss
        if self.symm_idx is not None:
            log_gauss = (log_gauss[self.symm_idx] + log_gauss) / 2.0
        return torch.exp(log_gauss)

    def _time_rows(self, frame_id, num_rows):
        if frame_id is None:
            te = self.time_embedding.mean_embedding()
            return te.reshape(1, -1).expand(num_rows, te.shape[-1])
        return self.time_embedding(frame_id).reshape(num_rows, -1)

    def _quad_path_ok(self, xyz, bone2obj) -> bool:
        if self.num_freq_xyz != 0 or bone2obj[0].ndim != 3 or xyz.ndim < 3:
            return False
        return not (self.delta_skin and any(s < self.delta_field.backbone.D
                                            for s in self.delta_field.backbone.skips))

    def _quad_call(self, xyz, bone2obj, frame_id, inst_id):
        """dist^2 to each scaled bone frame is a quadratic form in x, so all
        bones reduce to one (P, 10) @ (10, B) product; the delta MLP's first
        layer is affine in x and folds into per-pair weights (M, 3, W)."""
        q, t = dual_quaternion_to_quaternion_translation(bone2obj)
        R = quaternion_to_matrix(q)  # (M, B, 3, 3) bone -> obj
        Rt = R / self.get_gauss()[..., None, :]
        c = torch.einsum("mbj,mbji->mbi", t, Rt)
        A = torch.einsum("mbji,mbki->mbjk", Rt, Rt)
        At = torch.einsum("mbjk,mbk->mbj", A, t)
        const = torch.einsum("mbj,mbj->mb", t, At)
        Q = torch.cat(
            [
                A[..., 0, 0:1], A[..., 1, 1:2], A[..., 2, 2:3],
                2 * A[..., 0, 1:2], 2 * A[..., 0, 2:3], 2 * A[..., 1, 2:3],
                -2 * At, const[..., None],
            ],
            dim=-1,
        )  # (M, B, 10)
        lead = xyz.shape[:-1]
        M = xyz.shape[0]
        x = xyz.reshape(M, -1, 3)
        x0, x1, x2 = x[..., 0:1], x[..., 1:2], x[..., 2:3]
        phi = torch.cat([x * x, x0 * x1, x0 * x2, x1 * x2, x, torch.ones_like(x0)], dim=-1)
        dist2 = torch.einsum("mpc,mbc->mpb", phi, Q)
        if not self.delta_skin:
            return -dist2.reshape(lead + dist2.shape[-1:]), None

        weights, biases, row_adds = self.delta_field.folded_params(
            3 * self.num_coords, inst_id, row_code=self._time_rows(frame_id, M)
        )
        W1 = weights[0].t().reshape(self.num_coords, 3, -1)  # (B, 3, W)
        W1eff = torch.einsum("mbji,biw->mjw", Rt, W1)  # (M, 3, W)
        b_fold = torch.einsum("mbi,biw->mw", c, W1)
        b1 = biases[0].reshape(1, -1) + row_adds[0] - b_fold  # (M, W)
        h = torch.relu(torch.einsum("mpj,mjw->mpw", x, W1eff) + b1[:, None, :])
        for i in range(1, len(weights) - 1):
            h = torch.relu(F.linear(h, weights[i], biases[i]))
        delta = torch.relu(F.linear(h, weights[-1], biases[-1])) * 0.1  # (M, P, B)
        skin = -(dist2 + delta)
        return skin.reshape(lead + skin.shape[-1:]), delta.reshape(lead + delta.shape[-1:])

    def forward(self, xyz, bone2obj, frame_id, inst_id):
        """xyz: (M,N,D,3) canonical points; bone2obj: ((M,B,4), (M,B,4))
        per-pair bones (or bones without the pair axis); frame_id: (M,) or
        None (mean time embedding).
        Returns skin (M,N,D,B) unnormalized log-weights and delta (or None).
        """
        if self._quad_path_ok(xyz, bone2obj):
            return self._quad_call(xyz, bone2obj, frame_id, inst_id)
        # bone coordinates: bones without a per-pair axis, or too few point dims
        xyz_bone = get_bone_coords(xyz, bone2obj, scale=self.get_gauss())
        dist2 = torch.sum(xyz_bone**2, dim=-1)
        if not self.delta_skin:
            return -dist2, None
        xyz_embed = self.pos_embedding(xyz_bone.reshape(xyz.shape[:-1] + (-1,)))
        t_rows = self._time_rows(frame_id, xyz.shape[0])
        delta = torch.relu(self.delta_field(xyz_embed, inst_id, row_code=t_rows)) * 0.1
        return -(dist2 + delta), delta
