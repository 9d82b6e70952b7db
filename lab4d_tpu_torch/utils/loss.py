"""Loss helpers. Port of lab4d_tpu/utils/loss.py (its
cross_entropy_skin_loss is in nnutils/warping.py)."""

from __future__ import annotations

from typing import Optional

import torch


def entropy_loss(prob: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Entropy of probability distributions along `axis`."""
    return -torch.sum(prob * torch.log(prob + 1e-9), dim=axis)


def masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of v over the elements where mask is truthy (0 if none)."""
    mask = mask.to(v.dtype)
    return torch.sum(v * mask) / torch.clamp(torch.sum(mask), min=1.0)


def align_vectors(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Scale k minimizing ||k*v1 - v2||^2; 1 where it would be negative."""
    scale = torch.sum(v1 * v2) / torch.clamp(torch.sum(v1 * v1), min=1e-12)
    return torch.where(scale < 0, torch.ones_like(scale), scale)


def nonzero_count(v: torch.Tensor) -> torch.Tensor:
    """The number of positive entries of v, in v's dtype."""
    return torch.sum((v > 0).to(v.dtype))


def nonzero_mean(v: torch.Tensor, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the positive entries of v (0 when there are none): the
    loss reducer, `v[v > 0].mean()` without a data-dependent shape.

    count: the number of positive entries to divide by, where v is one
    rank's block of a batch sharded over ranks (their nonzero_count summed
    over the ranks); the sum of the ranks' results is then the mean over
    the global batch, and so is the sum of their gradients."""
    mask = (v > 0).to(v.dtype)
    denom = torch.sum(mask) if count is None else count
    return torch.where(denom > 0, torch.sum(v * mask) / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))
