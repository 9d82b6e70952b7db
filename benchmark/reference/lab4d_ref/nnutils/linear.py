"""torch.nn.Linear with an explicit generator for its default init.

Port of lab4d_tpu/nnutils/linear.py: kernel and bias ~ U(+-1/sqrt(fan_in)),
the distribution the JAX package copies from torch.nn.Linear.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def torch_linear_init_(layer: nn.Linear, generator: Optional[torch.Generator]) -> nn.Linear:
    bound = 1.0 / np.sqrt(max(layer.in_features, 1))
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class TorchDense(nn.Linear):
    """nn.Linear initialized from `generator` (the JAX package's
    TorchDense stores the (in, out) transpose as `kernel`)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        torch_linear_init_(self, generator)
