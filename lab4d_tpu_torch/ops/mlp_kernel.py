"""Fused ReLU MLPs: the CUDA kernels K3f, K3b, K4f, K4b and their plain
versions.

Port of lab4d_tpu/ops/mlp_kernel.py. Weights use the torch.nn.Linear
layout, (out, in), so module parameters go to the kernels without a copy;
the JAX package stores the transpose.

- K3f `fused_relu_mlp` forward (csrc/fused_relu_mlp.cu): few rows, the
  TimeMLP backbones.
- K3b `fused_relu_mlp_backward` (csrc/fused_pe_mlp.cu, the K4b entry
  with no frequencies): its VJP.
- K4f `fused_pe_mlp` (csrc/fused_pe_mlp.cu): Fourier embedding + MLP over
  the points of a training step.
- K4b `fused_pe_mlp_backward` (csrc/fused_pe_mlp.cu): its VJP.

Each public function launches its kernel for a CUDA tensor (counted in
`<function>.launches`) and uses its plain version for a CPU tensor; on any
other device it raises. `fused_relu_mlp` and `fused_pe_mlp` are
differentiable: on the card their backward is K3b / K4b, first order only
(a second derivative raises), like the JAX custom VJPs. The final ReLU's
mask on the incoming gradient is applied here, outside the kernels, as the
JAX VJPs do.

The backward kernels work on tiles of rows and reduce the weight
gradients over the tiles through a workspace of one slice per block;
`tile_plan` picks the tile height and the grid from the layer widths, and
is plain Python so that the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lab4d_tpu_torch.nnutils.embedding import fourier_embed

MAX_LAYERS = 16  # MLP_MAX_LAYERS in csrc/fused_relu_mlp.cu, TM_MAX_LAYERS in csrc/mlp_tiles.cuh
MAX_FREQS = 16  # TM_MAX_FREQS
TILE_KC = 16  # TM_KC: k-chunk of the staged weights
TILE_STAGE = 16 * 256  # TM_STAGE_REGS * TM_THREADS: staged weights per k-chunk
SMEM_PER_SM = 227 * 1024  # bytes of shared memory a block may use on sm_90
TILE_ROWS = (64, 48, 32, 16, 8)


# ------------------------------------------------------------ plain versions


def mlp_reference(x, weights, biases, skip_idx=(), final_act: bool = False):
    """Plain PyTorch version with the kernels' semantics: ReLU between
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


def _vjp(fn, inputs, g):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, g, allow_unused=True)


def mlp_backward_reference(x, g, weights, biases, skip_idx=()):
    """Plain version of K3b: (dx, dWs, dbs) of mlp_reference (no final
    ReLU) for the output gradient g."""
    n = len(weights)
    grads = _vjp(lambda x_, *p: mlp_reference(x_, p[:n], p[n:], skip_idx),
                 (x, *weights, *biases), g)
    return grads[0], list(grads[1 : 1 + n]), list(grads[1 + n :])


def pe_mlp_reference(x, window, weights, biases, freqs, skip_idx=(), final_act: bool = False):
    """Plain version of K4f: fourier_embed's block layout
    [x, sin (F x C), cos (F x C)] (windowed), then mlp_reference."""
    embed = fourier_embed(x, tuple(freqs), window)
    return mlp_reference(embed, weights, biases, skip_idx, final_act)


def pe_mlp_backward_reference(x, g, window, weights, biases, freqs, skip_idx=()):
    """Plain version of K4b: (dx, dWs, dbs) of pe_mlp_reference (no final
    ReLU); no gradient reaches the window."""
    n = len(weights)
    grads = _vjp(lambda x_, *p: pe_mlp_reference(x_, window, p[:n], p[n:], freqs, skip_idx),
                 (x, *weights, *biases), g)
    return grads[0], list(grads[1 : 1 + n]), list(grads[1 + n :])


# ---------------------------------------------------------- launch planning


class TilePlan(NamedTuple):
    tile_rows: int
    smem_bytes: int
    grid: int
    n_params: int  # floats of one workspace slice (every dW, then every db)


def _stage_ld(in_dims, out_dims):
    max_w = max(max(in_dims), max(out_dims))
    return (max_w + 31) // 32 * 32 + 4


def tile_smem(c_x, in_dims, out_dims, tile_rows, backward):
    """Shared memory of the row-tiled kernels (tm_fwd_smem / tm_bwd_smem
    in csrc/mlp_tiles.cuh), bytes: k-major buffers of tile_rows + 4 floats
    per feature, and the weight staging buffer."""
    stage = TILE_KC * _stage_ld(in_dims, out_dims)
    max_out = max(out_dims)
    if backward:
        per_row = 2 * c_x + sum(out_dims[:-1]) + 2 * max_out
    else:
        per_row = c_x + 2 * max_out
    return 4 * ((tile_rows + 4) * per_row + stage)


def tile_plan(c_x, in_dims, out_dims, rows, backward, n_sm):
    """Tile height, shared memory and grid of a row-tiled launch.

    Forward: the tallest tile that leaves room for two blocks per SM, one
    block per tile. Backward: the tallest tile that fits (the weight
    gradients are added to the block's workspace slice once per tile, so
    taller tiles move fewer bytes), halved while the tiles cannot fill the
    SMs; a grid-stride launch of at most one block per SM per slot, since
    the workspace holds one slice of every weight gradient per block.
    """
    n_params = sum(o * (i + 1) for i, o in zip(in_dims, out_dims))
    if TILE_KC * (-(-max(*in_dims, *out_dims) // 4) * 4) > TILE_STAGE:
        raise ValueError(f"layers wider than {TILE_STAGE // TILE_KC} are not supported")
    budget = SMEM_PER_SM if backward else SMEM_PER_SM // 2
    fits = [t for t in TILE_ROWS if tile_smem(c_x, in_dims, out_dims, t, backward) <= budget]
    if not fits and not backward:
        fits = [t for t in TILE_ROWS if tile_smem(c_x, in_dims, out_dims, t, False) <= SMEM_PER_SM]
    if not fits:
        raise ValueError(f"an MLP of widths {list(out_dims)} does not fit in shared memory")
    tr = fits[0]
    if backward:
        while tr > TILE_ROWS[-1] and -(-rows // tr) < n_sm and tr // 2 in fits:
            tr //= 2
    smem = tile_smem(c_x, in_dims, out_dims, tr, backward)
    ntiles = -(-rows // tr)
    if backward:
        per_sm = max(1, min(2, SMEM_PER_SM // smem))
        grid = min(ntiles, n_sm * per_sm)
    else:
        grid = ntiles
    return TilePlan(tr, smem, grid, n_params)


# ------------------------------------------------------------ the libraries


@functools.lru_cache(maxsize=None)
def _kernel_lib(name: str):
    """A kernel library, built on first use, with its C signatures."""
    from lab4d_tpu_torch.ops.build import load_library

    lib = load_library(name)
    vp, i32, pvp, pi32 = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    pf32 = ctypes.POINTER(ctypes.c_float)
    if name == "fused_relu_mlp":
        lib.lab4d_fused_relu_mlp_fwd.argtypes = [
            vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, i32, i32, vp,
        ]
        lib.lab4d_fused_relu_mlp_fwd.restype = i32
    elif name == "fused_pe_mlp":
        lib.lab4d_fused_pe_mlp_fwd.argtypes = [
            vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, pf32, vp, i32, i32, i32, i32, i32, vp,
        ]
        lib.lab4d_fused_pe_mlp_fwd.restype = i32
        lib.lab4d_fused_pe_mlp_bwd.argtypes = [
            vp, vp, vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, pf32, vp, i32, i32, i32, i32, vp,
        ]
        lib.lab4d_fused_pe_mlp_bwd.restype = i32
    else:
        raise ValueError(name)
    lib.lab4d_cuda_error_string.argtypes = [i32]
    lib.lab4d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(x, weights, biases, skip_idx, n_freqs=0):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (rows, C_in) float32 tensor, got {tuple(x.shape)} {x.dtype}")
    n = len(weights)
    if not 1 <= n <= MAX_LAYERS or len(biases) != n:
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one bias each, got {n}/{len(biases)}")
    if not 0 <= n_freqs <= MAX_FREQS:
        raise ValueError(f"need 0..{MAX_FREQS} frequencies, got {n_freqs}")
    if 0 in skip_idx:
        raise ValueError("a skip at layer 0 is not supported by the kernel")
    c_in = x.shape[1] * (2 * n_freqs + 1)
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


def _layer_args(weights, biases, skip_idx):
    n = len(weights)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return (
        (vp * n)(*[w.data_ptr() for w in weights]),
        (vp * n)(*[b.data_ptr() for b in biases]),
        (i32 * n)(*[w.shape[1] for w in weights]),
        (i32 * n)(*[w.shape[0] for w in weights]),
        n,
    ), sum(1 << i for i in skip_idx if i < n)


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.lab4d_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _n_sm(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _freq_args(freqs, window, x):
    n_freqs = len(freqs)
    if window is not None:
        if window.shape != (n_freqs,) or window.dtype != torch.float32 or window.device != x.device:
            raise ValueError(f"window must be a ({n_freqs},) float32 tensor on the device of x")
        window = window.contiguous()
    return n_freqs, (ctypes.c_float * max(n_freqs, 1))(*freqs), window


def _split_grads(flat, weights):
    """Views of the kernels' flat gradient: every dW (out, in), then every db."""
    dws, dbs, off = [], [], 0
    for w in weights:
        dws.append(flat[off : off + w.numel()].view(w.shape))
        off += w.numel()
    for w in weights:
        dbs.append(flat[off : off + w.shape[0]])
        off += w.shape[0]
    return dws, dbs


def _launch_tile_bwd(lib, fn, x, g, weights, biases, skip_idx, n_sm, stream, pe):
    """Run the row-tiled backward entry (K4b, or K3b with no frequencies).
    pe: (n_freqs, freq array, window) from _freq_args."""
    layers, skip_mask = _layer_args(weights, biases, skip_idx)
    c_x = weights[0].shape[1]
    plan = tile_plan(c_x, [w.shape[1] for w in weights], [w.shape[0] for w in weights],
                     x.shape[0], True, n_sm)
    dx = torch.empty_like(x)
    ws = torch.empty(plan.grid * plan.n_params, device=x.device, dtype=x.dtype)
    flat = torch.empty(plan.n_params, device=x.device, dtype=x.dtype)
    n_freqs, freq_arr, window = pe
    err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), ws.data_ptr(), flat.data_ptr(), *layers,
             x.shape[1], n_freqs, freq_arr, None if window is None else window.data_ptr(),
             x.shape[0], plan.tile_rows, skip_mask, plan.grid, stream)
    _raise_on(lib, err, fn.__name__)
    dws, dbs = _split_grads(flat, weights)
    return dx, dws, dbs


# ------------------------------------------------------------------ K3f, K3b


class _FusedReluMLP(torch.autograd.Function):
    """Forward through K3f, backward through K3b."""

    @staticmethod
    def forward(ctx, x, skip_idx, final_act, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        _check_args(x, weights, biases, skip_idx)
        lib = _kernel_lib("fused_relu_mlp")
        out = torch.empty((x.shape[0], weights[-1].shape[0]), device=x.device, dtype=x.dtype)
        layers, skip_mask = _layer_args(weights, biases, skip_idx)
        err = lib.lab4d_fused_relu_mlp_fwd(
            x.data_ptr(), out.data_ptr(), *layers, x.shape[1], x.shape[0], skip_mask,
            int(final_act), _stream(x.device),
        )
        _raise_on(lib, err, "fused_relu_mlp")
        fused_relu_mlp.launches += 1
        ctx.skip_idx, ctx.final_act = skip_idx, final_act
        ctx.save_for_backward(x, out, *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, out, *params = ctx.saved_tensors
        n = len(params) // 2
        g = grad_out * (out > 0.0) if ctx.final_act else grad_out
        dx, dws, dbs = fused_relu_mlp_backward(x, g.contiguous(), params[:n], params[n:],
                                               ctx.skip_idx)
        return (dx, None, None, *dws, *dbs)


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

    A CUDA tensor goes through K3f (counted in `fused_relu_mlp.launches`),
    and its gradient through K3b; a CPU tensor through `mlp_reference`.
    """
    skip_idx = tuple(skip_idx)
    if x.device.type == "cuda":
        return _FusedReluMLP.apply(x, skip_idx, bool(final_act), *weights, *biases)
    if x.device.type == "cpu":
        return mlp_reference(x, weights, biases, skip_idx, final_act)
    raise NotImplementedError(f"fused_relu_mlp has no kernel for device {x.device}")


fused_relu_mlp.launches = 0


def fused_relu_mlp_backward(x, g, weights, biases, skip_idx=()):
    """VJP of fused_relu_mlp without the final ReLU (the caller masks g):
    returns (dx, dWs, dbs) for the output gradient g (rows, out_last).
    K3b on a CUDA tensor (counted in `fused_relu_mlp_backward.launches`),
    `mlp_backward_reference` on a CPU tensor."""
    skip_idx = tuple(skip_idx)
    if x.device.type == "cpu":
        return mlp_backward_reference(x, g, weights, biases, skip_idx)
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_relu_mlp_backward has no kernel for device {x.device}")
    _check_args(x, weights, biases, skip_idx)
    if g.shape != (x.shape[0], weights[-1].shape[0]) or not g.is_contiguous() or g.dtype != x.dtype:
        raise ValueError(f"g must be a contiguous ({x.shape[0]}, {weights[-1].shape[0]}) float32 tensor")
    lib = _kernel_lib("fused_pe_mlp")
    out = _launch_tile_bwd(lib, lib.lab4d_fused_pe_mlp_bwd, x, g, weights, biases, skip_idx,
                           _n_sm(x.device), _stream(x.device), pe=_freq_args((), None, x))
    fused_relu_mlp_backward.launches += 1
    return out


fused_relu_mlp_backward.launches = 0


# ------------------------------------------------------------------ K4f, K4b


class _FusedPEMLP(torch.autograd.Function):
    """Forward through K4f, backward through K4b; no gradient reaches the
    window (the JAX VJP returns zeros for it)."""

    @staticmethod
    def forward(ctx, x, window, freqs, skip_idx, final_act, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        _check_args(x, weights, biases, skip_idx, len(freqs))
        n_freqs, freq_arr, window = _freq_args(freqs, window, x)
        lib = _kernel_lib("fused_pe_mlp")
        layers, skip_mask = _layer_args(weights, biases, skip_idx)
        plan = tile_plan(weights[0].shape[1], [w.shape[1] for w in weights],
                         [w.shape[0] for w in weights], x.shape[0], False, 1)
        out = torch.empty((x.shape[0], weights[-1].shape[0]), device=x.device, dtype=x.dtype)
        err = lib.lab4d_fused_pe_mlp_fwd(
            x.data_ptr(), out.data_ptr(), *layers, x.shape[1], n_freqs, freq_arr,
            None if window is None else window.data_ptr(), x.shape[0], plan.tile_rows,
            skip_mask, int(final_act), plan.grid, _stream(x.device),
        )
        _raise_on(lib, err, "fused_pe_mlp")
        fused_pe_mlp.launches += 1
        ctx.freqs, ctx.skip_idx, ctx.final_act = freqs, skip_idx, final_act
        ctx.has_window = window is not None
        ctx.save_for_backward(x, out, *([window] if window is not None else []), *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, out, *rest = ctx.saved_tensors
        window = rest.pop(0) if ctx.has_window else None
        n = len(rest) // 2
        g = grad_out * (out > 0.0) if ctx.final_act else grad_out
        dx, dws, dbs = fused_pe_mlp_backward(x, g.contiguous(), window, rest[:n], rest[n:],
                                             ctx.freqs, ctx.skip_idx)
        return (dx, None, None, None, None, *dws, *dbs)


def fused_pe_mlp(x, window, weights, biases, freqs, skip_idx=(), final_act: bool = False):
    """Fourier-embed + fused MLP in one pass.

    Args:
        x: (rows, C) raw coordinates; window: (F,) annealing weights or None
        weights/biases: MLP params consuming C * (2F + 1) inputs, (out, in)
        freqs: the F frequency bands (Python floats)
    Returns:
        (rows, out_last)

    A CUDA tensor goes through K4f (counted in `fused_pe_mlp.launches`) and
    its gradient through K4b; a CPU tensor through `pe_mlp_reference`.
    """
    freqs, skip_idx = tuple(float(f) for f in freqs), tuple(skip_idx)
    if x.device.type == "cuda":
        return _FusedPEMLP.apply(x, window, freqs, skip_idx, bool(final_act), *weights, *biases)
    if x.device.type == "cpu":
        return pe_mlp_reference(x, window, weights, biases, freqs, skip_idx, final_act)
    raise NotImplementedError(f"fused_pe_mlp has no kernel for device {x.device}")


fused_pe_mlp.launches = 0


def fused_pe_mlp_backward(x, g, window, weights, biases, freqs, skip_idx=()):
    """VJP of fused_pe_mlp without the final ReLU (the caller masks g):
    (dx, dWs, dbs). K4b on a CUDA tensor (counted in
    `fused_pe_mlp_backward.launches`), `pe_mlp_backward_reference` on a CPU
    tensor."""
    freqs, skip_idx = tuple(float(f) for f in freqs), tuple(skip_idx)
    if x.device.type == "cpu":
        return pe_mlp_backward_reference(x, g, window, weights, biases, freqs, skip_idx)
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_pe_mlp_backward has no kernel for device {x.device}")
    _check_args(x, weights, biases, skip_idx, len(freqs))
    if g.shape != (x.shape[0], weights[-1].shape[0]) or not g.is_contiguous() or g.dtype != x.dtype:
        raise ValueError(f"g must be a contiguous ({x.shape[0]}, {weights[-1].shape[0]}) float32 tensor")
    pe = _freq_args(freqs, window, x)
    lib = _kernel_lib("fused_pe_mlp")
    out = _launch_tile_bwd(lib, lib.lab4d_fused_pe_mlp_bwd, x, g, weights, biases, skip_idx,
                           _n_sm(x.device), _stream(x.device), pe=pe)
    fused_pe_mlp_backward.launches += 1
    return out


fused_pe_mlp_backward.launches = 0
