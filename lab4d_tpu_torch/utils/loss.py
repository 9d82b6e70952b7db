"""Loss helpers. Port of the parts of lab4d_tpu/utils/loss.py that
training uses."""

from __future__ import annotations

import torch


def align_vectors(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Scale k minimizing ||k*v1 - v2||^2; 1 where it would be negative."""
    scale = torch.sum(v1 * v2) / torch.clamp(torch.sum(v1 * v1), min=1e-12)
    return torch.where(scale < 0, torch.ones_like(scale), scale)


def nonzero_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the positive entries of v (0 when there are none): the
    loss reducer, `v[v > 0].mean()` without a data-dependent shape."""
    mask = (v > 0).to(v.dtype)
    denom = torch.sum(mask)
    return torch.where(denom > 0, torch.sum(v * mask) / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))
