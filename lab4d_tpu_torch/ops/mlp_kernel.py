"""Fused multi-layer ReLU MLP: the CUDA kernel K3f and its plain version.

Port of lab4d_tpu/ops/mlp_kernel.py:fused_relu_mlp (forward). Weights
use the torch.nn.Linear layout, (out, in), so module parameters go to
the kernel without a copy; the JAX package stores the transpose.

`fused_relu_mlp` launches the kernel (lab4d_tpu_torch/csrc/
fused_relu_mlp.cu) for a CUDA tensor and uses `mlp_reference` for a CPU
tensor; on any other device it raises. Its backward (K3b) is not ported
yet and raises (ROADMAP.md, queue 2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

MAX_LAYERS = 16  # MLP_MAX_LAYERS in csrc/fused_relu_mlp.cu


def mlp_reference(x, weights, biases, skip_idx=(), final_act: bool = False):
    """Plain PyTorch version with the kernel's semantics: ReLU between
    layers, [x, h] re-concatenated before each layer in skip_idx, optional
    ReLU on the output."""
    h = x
    n = len(weights)
    for i in range(n):
        if i in skip_idx:
            h = torch.cat([x, h], dim=-1)
        h = F.linear(h, weights[i], biases[i])
        if i < n - 1 or final_act:
            h = torch.relu(h)
    return h


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    """The kernel's library, built on first use, with its C signatures."""
    from lab4d_tpu_torch.ops.build import load_library

    lib = load_library("fused_relu_mlp")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lab4d_fused_relu_mlp_fwd.argtypes = [
        vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
        ctypes.POINTER(i32), ctypes.POINTER(i32), i32, i32, i32, i32, i32, vp,
    ]
    lib.lab4d_fused_relu_mlp_fwd.restype = i32
    lib.lab4d_cuda_error_string.argtypes = [i32]
    lib.lab4d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(x, weights, biases, skip_idx):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be a non-empty (rows, C_in) float32 tensor, got {tuple(x.shape)} {x.dtype}")
    n = len(weights)
    if not 1 <= n <= MAX_LAYERS or len(biases) != n:
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one bias each, got {n}/{len(biases)}")
    if 0 in skip_idx:
        raise ValueError("a skip at layer 0 is not supported by the kernel")
    c_in = x.shape[1]
    prev = c_in
    for i, (w, b) in enumerate(zip(weights, biases)):
        want_in = prev + (c_in if i in skip_idx else 0)
        shape = w.shape
        if len(shape) != 2 or shape[1] != want_in or b.shape != (shape[0],):
            raise ValueError(
                f"layer {i}: weight {tuple(shape)} / bias {tuple(b.shape)} "
                f"do not take {want_in} inputs"
            )
        prev = shape[0]
    dev = x.get_device()
    for t in (x, *weights, *biases):
        if t.dtype is not torch.float32 or t.get_device() != dev:
            raise ValueError("all tensors must be float32 on the device of x")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


class _FusedReluMLP(torch.autograd.Function):
    """Forward through the CUDA kernel; the backward (K3b) is not ported."""

    @staticmethod
    def forward(ctx, x, skip_idx, final_act, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        _check_args(x, weights, biases, skip_idx)
        lib = _kernel_lib()
        out = torch.empty((x.shape[0], weights[-1].shape[0]), device=x.device, dtype=x.dtype)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        skip_mask = sum(1 << i for i in skip_idx if i < n)
        args = (
            x.data_ptr(), out.data_ptr(),
            (vp * n)(*[w.data_ptr() for w in weights]),
            (vp * n)(*[b.data_ptr() for b in biases]),
            (i32 * n)(*[w.shape[1] for w in weights]),
            (i32 * n)(*[w.shape[0] for w in weights]),
            n, x.shape[1], x.shape[0], skip_mask, int(final_act),
        )
        with torch.cuda.device(x.device):  # launch on the device of x
            err = lib.lab4d_fused_relu_mlp_fwd(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = lib.lab4d_cuda_error_string(err).decode()
            raise RuntimeError(f"fused_relu_mlp kernel launch failed: {msg} ({err})")
        fused_relu_mlp.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the backward of fused_relu_mlp (K3b) is not ported yet (ROADMAP.md, queue 2)"
        )


def fused_relu_mlp(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    skip_idx=(),
    final_act: bool = False,
) -> torch.Tensor:
    """Fused D-layer MLP: ReLU between layers, [x, h] before each layer in
    skip_idx, optional ReLU on the output.

    Args:
        x: (rows, C_in) float32
        weights: (out_i, in_i) per layer; biases: (out_i,) per layer
    Returns:
        (rows, out_last)

    A CUDA tensor goes through the kernel (counted in
    `fused_relu_mlp.launches`); a CPU tensor through `mlp_reference`.
    """
    skip_idx = tuple(skip_idx)
    if x.device.type == "cuda":
        return _FusedReluMLP.apply(x, skip_idx, bool(final_act), *weights, *biases)
    if x.device.type == "cpu":
        return mlp_reference(x, weights, biases, skip_idx, final_act)
    raise NotImplementedError(f"fused_relu_mlp has no kernel for device {x.device}")


fused_relu_mlp.launches = 0
