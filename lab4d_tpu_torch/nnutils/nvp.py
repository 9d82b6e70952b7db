"""Invertible RealNVP warp map. Port of lab4d_tpu/nnutils/nvp.py.

Per block, three affine coupling layers (one per coordinate axis), each
predicting a scale and a translation for its axis from the other two axes
and the conditioning code. The inverse is exact by construction. Plain
PyTorch: the coupling MLPs are 64 wide, as in the JAX package, which runs
them as plain dense layers too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lab4d_tpu_torch.nnutils.embedding import PosEmbedding
from lab4d_tpu_torch.nnutils.linear import TorchDense


class CouplingMLP(nn.Module):
    """Two ReLU layers of 64, then (log scale, translation). The layers are
    `TorchDense.<i>`, the JAX package's compact names."""

    def __init__(self, in_channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_channels, 64, 64, 2]
        self.TorchDense = nn.ModuleList(
            [TorchDense(i, o, generator) for i, o in zip(dims[:-1], dims[1:])])

    def forward(self, h):
        for layer in self.TorchDense[:-1]:
            h = torch.relu(layer(h))
        return self.TorchDense[-1](h)


class CouplingLayer(nn.Module):
    """Affine coupling on one axis: x_a' = x_a * exp(s) + t, where (s, t)
    depend on the other axes and the code; s is tanh-bounded to +-0.5."""

    def __init__(self, axis: int, code_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.axis = axis
        self.pos_embedding = PosEmbedding(2, 4)
        self.mlp = CouplingMLP(self.pos_embedding.out_channels + code_channels, generator)

    def _st(self, others, code):
        out = self.mlp(torch.cat([self.pos_embedding(others), code], dim=-1))
        return torch.tanh(out[..., :1]) * 0.5, out[..., 1:2] * 0.1

    def _split(self, xyz):
        a = self.axis
        return xyz[..., a:a + 1], torch.cat([xyz[..., :a], xyz[..., a + 1:]], dim=-1)

    def _merge(self, xa, others):
        a = self.axis
        return torch.cat([others[..., :a], xa, others[..., a:]], dim=-1)

    def forward(self, xyz, code):
        xa, others = self._split(xyz)
        s, t = self._st(others, code)
        return self._merge(xa * torch.exp(s) + t, others)

    def inverse(self, xyz, code):
        xa, others = self._split(xyz)
        s, t = self._st(others, code)
        return self._merge((xa - t) * torch.exp(-s), others)


class NVP(nn.Module):
    """n_layers blocks of coupling layers cycling through the 3 axes."""

    def __init__(self, code_channels: int, n_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList([CouplingLayer(i % 3, code_channels, generator=generator)
                                     for i in range(n_layers * 3)])

    def forward(self, code, xyz):
        code = code.expand(xyz.shape[:-1] + code.shape[-1:])
        for layer in self.layers:
            xyz = layer(xyz, code)
        return xyz

    def inverse(self, code, xyz):
        code = code.expand(xyz.shape[:-1] + code.shape[-1:])
        for layer in reversed(self.layers):
            xyz = layer.inverse(xyz, code)
        return xyz
