"""MLP primitives. Port of lab4d_tpu/nnutils/base.py.

BaseMLP is a skip-connection MLP. Conditioning codes never become a
(P, C) concat: a code constant across points folds into the biases, and a
per-row code (constant within each leading row of x) becomes a low-rank
add. A CUDA tensor with `fused` not False and no per-row add routes
through the fused kernels (ops/mlp_kernel.py): fused_pe_mlp (K4f, whose
gradient is K4b) when Fourier frequencies are given, else fused_relu_mlp
(K3f / K3b). Their gradients are first order only, so the eikonal term,
which differentiates the SDF twice, passes `fused=False` and takes the
plain chain, as do paths with per-row adds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.lab4d_ref.nnutils.embedding import InstEmbedding, fourier_embed
from benchmark.reference.lab4d_ref.nnutils.linear import TorchDense


class BaseMLP(nn.Module):
    """Skip-connection MLP with layers linear_1..linear_D and linear_final.

    `in_channels` is the full declared input width: the (embedded)
    features, then any per-row code, then any constant code.
    """

    def __init__(self, in_channels: int, D: int = 8, W: int = 256, out_channels: int = 3,
                 skips: Sequence[int] = (4,), final_act: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.D, self.W, self.out_channels = D, W, out_channels
        self.skips = tuple(skips)
        self.final_act = final_act
        ch = in_channels
        for i in range(D):
            if i in self.skips:
                ch += in_channels
            self.add_module(f"linear_{i + 1}", TorchDense(ch, W, generator))
            ch = W
        self.linear_final = TorchDense(ch, out_channels, generator)

    @property
    def layers(self):
        return [getattr(self, f"linear_{i + 1}") for i in range(self.D)] + [self.linear_final]

    def folded_params(self, feat_ch: int, const_code=None, row_code=None):
        """Weights (out, in) and biases with the codes folded out.

        Returns (weights, biases, row_adds): the input blocks of the code
        channels are removed from every layer that consumes the input,
        `const_code @ W_code` is added to those layers' biases, and
        row_adds[i] = row_code @ W_row is the (M, W) per-row addend of
        layer i.
        """
        weights = [l.weight for l in self.layers]
        biases = [l.bias for l in self.layers]
        row_ch = 0 if row_code is None else row_code.shape[-1]
        code_ch = 0 if const_code is None else const_code.shape[-1]
        in_ch = feat_ch + row_ch + code_ch
        if in_ch != self.in_channels:
            raise ValueError(f"BaseMLP takes {self.in_channels} inputs, got {in_ch}")
        row_adds = {}
        if code_ch == 0 and row_ch == 0:
            return weights, biases, row_adds
        folded_w, folded_b = [], []
        for i, (w, b) in enumerate(zip(weights, biases)):
            if i == 0 or (i < self.D and i in self.skips):
                w_row = w[:, feat_ch : feat_ch + row_ch]
                w_code = w[:, feat_ch + row_ch : in_ch]
                folded_w.append(torch.cat([w[:, :feat_ch], w[:, in_ch:]], dim=1))
                folded_b.append(b if const_code is None else b + w_code @ const_code)
                if row_ch > 0:
                    row_adds[i] = row_code @ w_row.t()
            else:
                folded_w.append(w)
                folded_b.append(b)
        return folded_w, folded_b, row_adds

    def forward(self, x: torch.Tensor, fused: Optional[bool] = None, const_code=None,
                pe_spec=None, row_code: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (M, ..., C) features, or raw coordinates when pe_spec =
        (frequencies, window or None) is given (the params then consume
        the embedded width); const_code: (C,) constant code; row_code:
        (M, Cr) per-row code."""
        if x.shape[-1] == 0 and const_code is None and row_code is None:
            return x
        feat_ch = x.shape[-1]
        if pe_spec is not None:
            pe_freqs, pe_window = pe_spec
            feat_ch *= 2 * len(pe_freqs) + 1
        weights, biases, row_adds = self.folded_params(feat_ch, const_code, row_code)

        h0 = x if pe_spec is None else fourier_embed(x, pe_freqs, pe_window)

        def row_add(i, h):
            if i not in row_adds:
                return h
            u = row_adds[i]
            return h + u.reshape(u.shape[:1] + (1,) * (h.ndim - 2) + u.shape[-1:])

        h = h0
        for i in range(self.D):
            if i in self.skips:
                h = torch.cat([h0, h], dim=-1)
            h = torch.relu(row_add(i, F.linear(h, weights[i], biases[i])))
        out = row_add(self.D, F.linear(h, weights[-1], biases[-1]))
        return torch.relu(out) if self.final_act else out


class CondMLP(nn.Module):
    """MLP conditioned on a per-instance code; `inst_id` None evaluates
    with the mean instance code.

    in_channels: (embedded) feature width; row_channels: width of a
    per-row code the caller passes as `row_code`.
    """

    def __init__(self, num_inst: int, in_channels: int, D: int = 8, W: int = 256,
                 inst_channels: int = 32, out_channels: int = 3, skips: Sequence[int] = (4,),
                 final_act: bool = False, row_channels: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_inst = num_inst
        self.inst_channels = inst_channels
        self.inst_embedding = InstEmbedding(num_inst, inst_channels, generator)
        self.backbone = BaseMLP(
            in_channels + row_channels + inst_channels, D=D, W=W, out_channels=out_channels,
            skips=skips, final_act=final_act, generator=generator,
        )

    def _const_code(self, inst_id):
        """The code shared by every point, or None when codes vary per row."""
        if inst_id is None:
            return self.inst_embedding.mean()
        if self.num_inst == 1:
            return self.inst_embedding.mapping.weight[0]
        return None

    def forward(self, feat: torch.Tensor, inst_id: Optional[torch.Tensor], fused=None,
                pe_spec=None, row_code: Optional[torch.Tensor] = None,
                beta_prob: Optional[float] = None, train: bool = False,
                swap=None) -> torch.Tensor:
        """feat: (M, ..., C), raw coordinates when pe_spec is given;
        inst_id: (M,) or None (mean instance); row_code: (M, Cr).
        beta_prob, train, swap: the instance-code swap of training
        (InstEmbedding), where codes vary per row."""
        if self.inst_channels == 0:
            if feat.shape[-1] == 0:
                return feat
            return self.backbone(feat, fused=fused, pe_spec=pe_spec, row_code=row_code)
        code = self._const_code(inst_id)
        if code is not None:
            if feat.shape[-1] == 0:
                # code-only MLP: evaluate the single row and broadcast
                out = self.backbone(code[None], fused=False)
                return out.reshape((1,) * (feat.ndim - 1) + out.shape[-1:]).expand(
                    feat.shape[:-1] + out.shape[-1:]
                )
            return self.backbone(feat, fused=fused, const_code=code, pe_spec=pe_spec,
                                 row_code=row_code)
        # per-row codes: the plain chain's row adds, as in the JAX package
        inst_rows = self.inst_embedding(inst_id, beta_prob=beta_prob, train=train, swap=swap)
        inst_rows = inst_rows.reshape(inst_id.shape[0], -1)
        rows = inst_rows if row_code is None else torch.cat([row_code, inst_rows], dim=-1)
        return self.backbone(feat, fused=fused, pe_spec=pe_spec, row_code=rows)

    def folded_params(self, feat_ch: int, inst_id, row_code=None):
        """(weights, biases, row_adds) of the backbone with the instance
        code applied, for callers that drive the layers themselves."""
        code = self._const_code(inst_id)
        if code is None:
            inst_rows = self.inst_embedding(inst_id).reshape(inst_id.shape[0], -1)
            row_code = inst_rows if row_code is None else torch.cat([row_code, inst_rows], -1)
        return self.backbone.folded_params(feat_ch, const_code=code, row_code=row_code)


def embed_cond_mlp(cond_mlp, pos_embedding, x, alpha=None, inst_id=None, fused=None,
                   beta_prob=None, train: bool = False, swap=None):
    """PosEmbedding + CondMLP, handing the embedding (and its annealing
    window at progress alpha) to BaseMLP's pe_spec path when the embedding
    is a real Fourier map. beta_prob, train, swap: CondMLP's code swap."""
    spec = pos_embedding.pe_spec(alpha)
    kw = dict(fused=fused, beta_prob=beta_prob, train=train, swap=swap)
    if spec is None:
        return cond_mlp(pos_embedding(x), inst_id, **kw)
    return cond_mlp(x, inst_id, pe_spec=spec, **kw)
