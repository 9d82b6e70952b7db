"""The precision of the reference: fp32 products with TF32 off, and the
control one step below it, TF32 operands with fp32 accumulation.

On the card the control turns cuBLAS's and cuDNN's TF32 on. On the CPU,
where no library offers TF32, `lowered()` rounds both operands of every
matrix product of the forward to TF32's 10-bit mantissa (round to
nearest, ties away from zero), so that tests exercise the same control
without a card; the backward's products stay fp32 there.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def fp32_exact():
    """TF32 off for every product on the card (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits); its
    gradient passes straight through."""
    if x.dtype != torch.float32:
        return x
    with torch.no_grad():
        bits = x.detach().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


_PRODUCTS = {
    torch.mm: (0, 1), torch.matmul: (0, 1), torch.bmm: (0, 1), torch.Tensor.__matmul__: (0, 1),
    torch.Tensor.matmul: (0, 1), torch.Tensor.mm: (0, 1), torch.Tensor.bmm: (0, 1),
    F.linear: (0, 1), torch.addmm: (1, 2), torch.baddbmm: (1, 2), torch.Tensor.__rmatmul__: (0, 1),
}


class _Tf32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        idx = _PRODUCTS.get(func)
        if idx is not None:
            args = list(args)
            for i in idx:
                if i < len(args) and torch.is_tensor(args[i]):
                    args[i] = tf32_round(args[i])
            if func is F.linear and "weight" in kwargs:
                kwargs["weight"] = tf32_round(kwargs["weight"])
        elif func is torch.einsum:
            args = [args[0]] + [tf32_round(a) if torch.is_tensor(a) else a for a in args[1:]]
        return func(*args, **kwargs)


@contextlib.contextmanager
def lowered(device: torch.device):
    """The control's precision: TF32 products, fp32 accumulation."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            fp32_exact()
    else:
        with _Tf32Products():
            yield
