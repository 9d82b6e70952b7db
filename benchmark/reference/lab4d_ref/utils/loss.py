"""Loss helpers. Port of lab4d_tpu/utils/loss.py (its
cross_entropy_skin_loss is in nnutils/warping.py)."""

from __future__ import annotations

from typing import Optional

import torch


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
