"""Fused ReLU MLPs: the CUDA kernels K3f, K3b, K4f, K4b and their plain
versions.

Port of lab4d_tpu/ops/mlp_kernel.py. Weights use the torch.nn.Linear
layout, (out, in), so module parameters go to the kernels without a copy;
the JAX package stores the transpose.

- K3f `fused_relu_mlp` forward (csrc/fused_relu_mlp.cu): the TimeMLP
  backbones (1 to 512 rows) and the warps' CondMLPs at every sample
  (262,144 rows). When autograd needs a gradient it also saves every
  hidden layer output (`pe_act_layout`, `mlp_forward_saved`).
- K3b `fused_relu_mlp_backward` (csrc/fused_relu_mlp.cu): its VJP from
  those saved outputs; its plain version on the same saved outputs is
  `mlp_backward_saved_reference`.
- K4f `fused_pe_mlp` (csrc/fused_pe_mlp.cu): Fourier embedding + MLP over
  the points of a training step, on 3xTF32 tensor cores. When autograd
  needs a gradient it also saves every hidden layer output
  (`pe_act_layout`, `pe_mlp_forward_saved`).
- K4b `fused_pe_mlp_backward` (csrc/fused_pe_mlp.cu): its VJP from those
  saved outputs, layer by layer over all points; its plain version on the
  same saved outputs is `pe_mlp_backward_saved_reference`.

Each public function launches its kernel for a CUDA tensor (counted in
`<function>.launches`) and uses its plain version for a CPU tensor; on any
other device it raises. `fused_relu_mlp` and `fused_pe_mlp` are
differentiable: on the card their backward is K3b / K4b, first order only
(a second derivative raises), like the JAX custom VJPs. The final ReLU's
mask on the incoming gradient is applied here, outside the kernels, as the
JAX VJPs do.

K3f / K3b's row-count decisions (`relu_mlp_plan`: the engine, K3f's
tile, K3b's chunks of rows for dW and its launches) are made here in plain
Python, so that the CPU tests reach them; the library lays out their
shared memory itself. K4f / K4b's launch plan is the library's own (`pe_mlp_plan` reads
it from csrc/fused_pe_mlp.cu); only their width limit (`check_pe_widths`)
and the saved outputs' layout (`pe_act_layout`) are kept here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lab4d_tpu_torch.nnutils.embedding import fourier_embed

MAX_LAYERS = 16  # RM_MAX_LAYERS in csrc/fused_relu_mlp.cu, NH_ / PM_MAX_LAYERS in the others
MAX_FREQS = 16  # PM_MAX_FREQS in csrc/fused_pe_mlp.cu
SMEM_PER_SM = 227 * 1024  # bytes of shared memory a block may use on sm_90
PE_MAX_WIDTH = 128  # NH_NMAX: widest layer output and embedding of K4f / K4b
# K3f / K3b (csrc/fused_relu_mlp.cu): K3f's fp32 FMA tile of RM_FMA_ROWS
# rows takes up to that many rows, else both run 3xTF32
K3_FMA_ROWS = 8
K3_MAX_WIDTH = 512  # RM_MAX_WIDTH: widest layer input and output of K3f / K3b
K3_DW_ROWS = 512  # RM_DW_ROWS: K3b's dW takes every row at once up to this many rows
K3_CHUNK_ROWS = 1024  # K3b's dW past them: fewest rows per chunk of the split over rows
# K3f / K3b's row engine (csrc/fused_relu_mlp.cu, rw_*): from this many rows
# on (the crossover measured by tools/profile_k4b_phases.py --k3_sweep),
# where no layer output and no input x is wider than K3_ROWS_MAX_WIDTH
K3_ROWS_MIN = 1024
K3_ROWS_MAX_WIDTH = 256  # RW_MAX_WIDTH
_RW_ROWS, _RW_KS, _RW_RS, _RW_NW, _RW_NWS, _RW_DW_M = 64, 16, 32, 128, 8, 128  # RW_* of the library


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
    """Autograd of pe_mlp_reference (no final ReLU): (dx, dWs, dbs) for the
    output gradient g; no gradient reaches the window."""
    n = len(weights)
    grads = _vjp(lambda x_, *p: pe_mlp_reference(x_, window, p[:n], p[n:], freqs, skip_idx),
                 (x, *weights, *biases), g)
    return grads[0], list(grads[1 : 1 + n]), list(grads[1 + n :])


def pe_act_layout(weights):
    """The layout of the hidden layer outputs K4f saves for K4b: the floats
    per point before each hidden layer's block, and the floats per point in
    all. Layer l's block is a row-major (rows, out_l) array at
    offset * rows of the flat buffer; the last layer's output is not saved."""
    offs, n = [], 0
    for w in weights[:-1]:
        offs.append(n)
        n += w.shape[0]
    return offs, n


def mlp_forward_saved_reference(x, weights, biases, skip_idx=(), final_act: bool = False,
                                pre_activations: bool = False):
    """Plain version of K3f with its saved layer outputs: (out, acts), out
    as mlp_reference computes it and acts the flat (rows * floats per row,)
    buffer of every hidden layer's output after its ReLU, in
    pe_act_layout's order, as K3f writes it when autograd needs it. With
    pre_activations, acts holds each hidden layer's output before its ReLU
    instead (the inputs whose sign decides each ReLU's gradient)."""
    h, zs = x, []
    n = len(weights)
    for i in range(n):
        if i in skip_idx:
            h = torch.cat([x, h], dim=-1)
        z = F.linear(h, weights[i], biases[i])
        zs.append(z)
        h = torch.relu(z) if i < n - 1 or final_act else z
    blocks = zs[:-1] if pre_activations else [torch.relu(z) for z in zs[:-1]]
    acts = torch.cat([b.reshape(-1) for b in blocks]) if blocks else x.new_zeros(0)
    return h, acts


def mlp_backward_saved_reference(x, g, weights, biases, skip_idx, acts):
    """Plain version of K3b's dataflow: (dx, dWs, dbs) for the output
    gradient g (already masked by the final ReLU) from the saved hidden
    outputs acts (pe_act_layout), layer by layer in reverse as K3b runs it:
    dW = G^T A, db = sum G, dIn = G W with the ReLU mask of the saved input,
    the x columns summed into dx."""
    rows = x.shape[0]
    offs, _ = pe_act_layout(weights)

    def saved(i):
        w = weights[i].shape[0]
        return acts[offs[i] * rows: (offs[i] + w) * rows].view(rows, w)

    c_x = x.shape[1]
    dx = torch.zeros_like(x)
    n = len(weights)
    dws, dbs = [None] * n, [None] * n
    gcur = g
    for i in range(n - 1, -1, -1):
        hprev = saved(i - 1) if i > 0 else None
        A = x if i == 0 else (torch.cat([x, hprev], dim=-1) if i in skip_idx else hprev)
        dws[i] = gcur.T @ A
        dbs[i] = gcur.sum(0)
        din = gcur @ weights[i]
        if i == 0 or i in skip_idx:
            dx = dx + din[:, :c_x]
            din = din[:, c_x:]
        if i > 0:
            gcur = din * (hprev > 0)
    return dx, dws, dbs


def pe_mlp_forward_saved_reference(x, window, weights, biases, freqs, skip_idx=(),
                                   final_act: bool = False, pre_activations: bool = False):
    """Plain version of K4f with its saved layer outputs: fourier_embed,
    then mlp_forward_saved_reference (its (out, acts), acts as K4f writes
    them)."""
    return mlp_forward_saved_reference(fourier_embed(x, tuple(freqs), window), weights, biases,
                                       skip_idx, final_act, pre_activations)


def pe_mlp_backward_saved_reference(x, g, window, weights, biases, freqs, skip_idx, acts):
    """Plain version of K4b's dataflow: mlp_backward_saved_reference on the
    embedding X (dX), then dx through sin / cos and the window."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        X = fourier_embed(xl, tuple(freqs), window)
    dX, dws, dbs = mlp_backward_saved_reference(X.detach(), g, weights, biases, skip_idx, acts)
    return torch.autograd.grad(X, xl, dX)[0], dws, dbs


# ---------------------------------------------------------- launch planning


class ReluMlpPlan(NamedTuple):
    """K3f / K3b's row-count decisions for one shape (relu_mlp_plan)."""
    fwd_fma: bool  # the cluster engine's K3f on its 8-row fp32 FMA tile, else 3xTF32 on 32 rows
    n_chunks: int  # K3b's dW: chunks of rows, one workspace slice each when > 1
    chunk_rows: int  # rows per chunk, whole 32-row slabs
    n_params: int  # floats of the gradients: every dW, then every db
    act_floats: int  # saved floats per row (pe_act_layout)
    scratch_floats: int  # K3b's scratch: its split weights and G slabs (rows engine) or the
    # hidden layers' gradients (cluster engine), then the workspace
    bwd_launches: int  # CUDA launches of one K3b call
    engine: str = "cluster"  # "cluster" (few rows) or "rows"
    pack_floats: int = 0  # K3f's split weights (rows engine)
    fwd_launches: int = 1  # CUDA launches of one K3f call


def _cdiv(a, b):
    return -(-a // b)


def relu_mlp_plan(c_in, in_dims, out_dims, rows, n_sm=132, engine=None):
    """K3f / K3b's row-count decisions (ReluMlpPlan, made once per shape).

    Two engines sit behind K3f and K3b (csrc/fused_relu_mlp.cu):
    - the cluster engine, for the TimeMLPs' few rows (1 to 512: a render's
      frames, a training batch's frames): one cluster of 8 blocks per tile
      of rows splits every layer's columns, so that the 1.57 MB of weights
      is read once per tile by 8 SMs and no layer waits on the latency of
      more than 1/8 of it. K3f runs fp32 FMA on 8 rows up to 8 rows, else
      3xTF32 mma.sync on 32; K3b's dW is one launch up to K3_CHUNK_ROWS
      rows (from every row at once up to K3_DW_ROWS), else chunks of rows
      summed by a third launch.
    - the row engine, from K3_ROWS_MIN rows on (the warp fields' 262,144
      samples), where the card's time goes into the products and into
      streaming the weights: one persistent block per SM carries tiles of
      64 rows through every layer on wgmma 3xTF32, with the weights split
      once per call and streamed from L2 by the TMA unit; K3b's dW is a
      wgmma product over chunks of rows, summed by a further launch.
      It takes layers of at most K3_ROWS_MAX_WIDTH outputs and x of at
      most that many columns; wider MLPs stay on the cluster engine.
    Both chunk K3b's dW so that about four waves of blocks cover n_sm SMs,
    at most 512 chunks. engine: force "cluster" or "rows" (the profilers'
    sweep); the library lays out the shared memory (lab4d_relu_mlp_smem,
    lab4d_relu_mlp_rows_layout) and raises at launch when a layer's
    buffers do not fit."""
    return _relu_plan_of(c_in, tuple(in_dims), tuple(out_dims), rows, n_sm, engine)


def rows_engine_layout(c_in, in_dims, out_dims, rows):
    """The row engine's buffers (lab4d_relu_mlp_rows_layout's first four
    numbers): (K3f's split weights, K3b's split transposed weights, the G
    slabs of K3b's dW, floats each; dW's blocks per chunk of rows)."""
    L = len(in_dims)
    skip = [l > 0 and in_dims[l] != out_dims[l - 1] for l in range(L)]
    pk = pt = gimg = tiles = 0
    for l in range(L):
        nw = _RW_NWS if out_dims[l] <= 2 * _RW_NWS else _RW_NW
        pk += _cdiv(out_dims[l], 2 * nw) * _cdiv(in_dims[l], _RW_KS) * 64 * nw
        x_cols = c_in if l == 0 or skip[l] else 0
        n_pass = _cdiv(x_cols, 2 * _RW_NW) + (l > 0)
        pt += n_pass * _cdiv(out_dims[l], _RW_KS) * 64 * _RW_NW
        nwo = _RW_NWS if out_dims[l] <= _RW_NWS else _RW_NW
        n_ot = _cdiv(out_dims[l], nwo)
        gimg += _cdiv(rows, _RW_ROWS) * _RW_ROWS // _RW_RS * n_ot * 64 * nwo
        tiles += _cdiv(in_dims[l], _RW_DW_M) * n_ot
    return pk, pt, gimg, tiles


@functools.lru_cache(maxsize=256)
def _relu_plan_of(c_in, in_dims, out_dims, rows, n_sm, engine):
    if max(*in_dims, *out_dims) > K3_MAX_WIDTH:
        raise ValueError(f"K3f / K3b take layers of at most {K3_MAX_WIDTH} inputs and outputs")
    fits = max(c_in, *out_dims) <= K3_ROWS_MAX_WIDTH
    if engine is None:
        engine = "rows" if rows >= K3_ROWS_MIN and fits else "cluster"
    elif engine == "rows" and not fits:
        raise ValueError(f"K3's row engine takes x and layers of at most {K3_ROWS_MAX_WIDTH} columns")
    n_params = sum(o * (i + 1) for i, o in zip(in_dims, out_dims))
    act = sum(out_dims[:-1])
    if engine == "rows":
        pk, pt, gimg, tiles = rows_engine_layout(c_in, in_dims, out_dims, rows)
    else:
        pk, pt, gimg = 0, 0, rows * act
        tiles = sum(_cdiv(o, 64) * _cdiv(i, 64) for i, o in zip(in_dims, out_dims))
    n_chunks = 1 if engine == "cluster" and rows <= K3_DW_ROWS else \
        max(1, min(_cdiv(rows, K3_CHUNK_ROWS), _cdiv(4 * n_sm, tiles), 512))
    chunk_rows = _cdiv(_cdiv(rows, n_chunks), 32) * 32
    n_chunks = _cdiv(rows, chunk_rows)
    ws = n_chunks * n_params if n_chunks > 1 else 0
    if engine == "rows":
        return ReluMlpPlan(False, n_chunks, chunk_rows, n_params, act, pt + gimg + ws,
                           3 + (n_chunks > 1), "rows", pk, 2)
    return ReluMlpPlan(rows <= K3_FMA_ROWS, n_chunks, chunk_rows, n_params, act, gimg + ws,
                       2 + (n_chunks > 1))


def check_pe_widths(c_x, out_dims):
    """K4f / K4b hold every output column of a warpgroup's rows (NH_NMAX): an
    embedding or a layer wider than PE_MAX_WIDTH columns raises."""
    if c_x > PE_MAX_WIDTH or max(out_dims) > PE_MAX_WIDTH:
        raise ValueError(f"K4f / K4b take embeddings and layers of at most {PE_MAX_WIDTH} "
                         f"columns, got {c_x} and {max(out_dims)}")


# ------------------------------------------------------------ the libraries


@functools.lru_cache(maxsize=None)
def _kernel_lib(name: str):
    """A kernel library, built on first use, with its C signatures."""
    from lab4d_tpu_torch.ops.build import load_library

    return bind_signatures(name, load_library(name))


def bind_signatures(name, lib):
    """Declare the C signatures of the library `name` (fused_relu_mlp or
    fused_pe_mlp); returns lib."""
    vp, i32, pvp, pi32 = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    pf32 = ctypes.POINTER(ctypes.c_float)
    if name == "fused_relu_mlp":
        lib.lab4d_relu_mlp_smem.argtypes = [pi32, pi32, i32, i32, i32, i32,
                                            ctypes.POINTER(ctypes.c_longlong)]
        lib.lab4d_relu_mlp_smem.restype = i32
        lib.lab4d_relu_mlp_max_clusters.argtypes = [i32, i32]
        lib.lab4d_relu_mlp_max_clusters.restype = i32
        lib.lab4d_relu_mlp_fwd.argtypes = [
            vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, i32, i32, i32, pi32, vp,
        ]
        lib.lab4d_relu_mlp_fwd.restype = i32
        lib.lab4d_relu_mlp_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, i32, i32, i32, pi32, vp,
        ]
        lib.lab4d_relu_mlp_bwd.restype = i32
        lib.lab4d_relu_mlp_rows_layout.argtypes = [pi32, pi32, i32, i32, i32, i32,
                                                   ctypes.POINTER(ctypes.c_longlong)]
        lib.lab4d_relu_mlp_rows_layout.restype = i32
        lib.lab4d_relu_mlp_rows_fwd.argtypes = [
            vp, vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, i32, i32, pi32, vp,
        ]
        lib.lab4d_relu_mlp_rows_fwd.restype = i32
        lib.lab4d_relu_mlp_rows_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, i32, i32, i32, pi32, vp,
        ]
        lib.lab4d_relu_mlp_rows_bwd.restype = i32
    elif name == "fused_pe_mlp":
        lib.lab4d_pe_mlp_plan.argtypes = [pi32, pi32, i32, i32, i32, i32, i32,
                                          ctypes.POINTER(ctypes.c_longlong)]
        lib.lab4d_pe_mlp_plan.restype = i32
        lib.lab4d_pe_mlp_fwd.argtypes = [
            vp, vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, pf32, vp, i32, i32, i32, vp, vp,
        ]
        lib.lab4d_pe_mlp_fwd.restype = i32
        lib.lab4d_pe_mlp_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, pvp, pvp, pi32, pi32, i32, i32, i32, pf32, vp, i32, i32,
            vp, vp, i32, vp, vp,
        ]
        lib.lab4d_pe_mlp_bwd.restype = i32
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


def _k3_plan(x, weights, engine=None):
    return relu_mlp_plan(x.shape[1], [w.shape[1] for w in weights], [w.shape[0] for w in weights],
                         x.shape[0], _n_sm(x.device), engine)


def _launch_k3f(lib, x, weights, biases, skip_idx, final_act, stream, save, engine=None):
    """Run K3f on the plan's engine (or `engine`); returns (out, acts, n),
    acts the saved hidden outputs (pe_act_layout) when save, else None, and
    n the CUDA launches made."""
    layers, skip_mask = _layer_args(weights, biases, skip_idx)
    plan = _k3_plan(x, weights, engine)
    out = torch.empty((x.shape[0], weights[-1].shape[0]), device=x.device, dtype=x.dtype)
    acts = torch.empty(x.shape[0] * plan.act_floats, device=x.device, dtype=x.dtype) if save else None
    n_launches = ctypes.c_int(0)
    acts_ptr = None if acts is None else acts.data_ptr()
    if plan.engine == "rows":
        pk = torch.empty(plan.pack_floats, device=x.device, dtype=x.dtype)
        err = lib.lab4d_relu_mlp_rows_fwd(
            x.data_ptr(), out.data_ptr(), acts_ptr, pk.data_ptr(), *layers, x.shape[1],
            x.shape[0], skip_mask, int(final_act), ctypes.byref(n_launches), stream)
    else:
        err = lib.lab4d_relu_mlp_fwd(
            x.data_ptr(), out.data_ptr(), acts_ptr, *layers, x.shape[1], x.shape[0], skip_mask,
            int(final_act), int(plan.fwd_fma), ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "relu_mlp_fwd")
    return out, acts, n_launches.value


def _launch_k3b(lib, x, g, weights, biases, skip_idx, acts, stream, engine=None):
    """Run K3b from K3f's saved outputs acts on the plan's engine (or
    `engine`); returns (dx, dWs, dbs, n), n the CUDA launches made."""
    layers, skip_mask = _layer_args(weights, biases, skip_idx)
    plan = _k3_plan(x, weights, engine)
    if acts.shape != (x.shape[0] * plan.act_floats,) or acts.device != x.device or \
            acts.dtype != x.dtype or not acts.is_contiguous():
        raise ValueError(f"acts must hold {plan.act_floats} floats per row (pe_act_layout)")
    dx = torch.empty_like(x)
    flat = torch.empty(plan.n_params, device=x.device, dtype=x.dtype)
    scratch = torch.empty(max(plan.scratch_floats, 1), device=x.device, dtype=x.dtype)
    n_launches = ctypes.c_int(0)
    bwd = lib.lab4d_relu_mlp_rows_bwd if plan.engine == "rows" else lib.lab4d_relu_mlp_bwd
    err = bwd(x.data_ptr(), g.data_ptr(), acts.data_ptr(), dx.data_ptr(), flat.data_ptr(),
              scratch.data_ptr(), *layers, x.shape[1], x.shape[0], skip_mask, plan.n_chunks,
              plan.chunk_rows, ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "relu_mlp_bwd")
    dws, dbs = _split_grads(flat, weights)
    return dx, dws, dbs, n_launches.value


class PeMlpPlan(NamedTuple):
    """K4f / K4b's launch plan for one shape, as lab4d_pe_mlp_plan
    (csrc/fused_pe_mlp.cu) returns it."""
    pk_floats: int  # K4f's pre-split weights (hi and lo)
    act_floats: int  # saved floats per point (pe_act_layout)
    n_params: int  # floats of the gradients: every dW, then every db
    n_chunks: int  # K4b: chunks of the points, one workspace slice each
    chunk_rows: int  # points per chunk, whole k-slabs
    scratch_floats: int  # K4b's scratch
    smem_bytes: int  # K4f's shared memory per block
    tile_rows: int  # K4f: points per tile
    n_tiles: int  # K4f's tiles (a persistent block per SM takes them in turn)
    bwd_launches: int  # CUDA launches of one K4b call


def pe_mlp_plan(lib, c_raw, n_freqs, in_dims, out_dims, rows, skip_mask=0):
    """K4f / K4b's launch plan (PeMlpPlan) from the library lib."""
    return _plan_of(lib, c_raw, n_freqs, tuple(in_dims), tuple(out_dims), rows, skip_mask)


@functools.lru_cache(maxsize=256)
def _plan_of(lib, c_raw, n_freqs, in_dims, out_dims, rows, skip_mask):
    n = len(in_dims)
    sizes = (ctypes.c_longlong * len(PeMlpPlan._fields))()
    err = lib.lab4d_pe_mlp_plan((ctypes.c_int * n)(*in_dims), (ctypes.c_int * n)(*out_dims), n,
                                c_raw, n_freqs, rows, skip_mask, sizes)
    _raise_on(lib, err, "pe_mlp_plan")
    return PeMlpPlan(*sizes)


def _pe_plan(lib, x, weights, n_freqs, skip_mask):
    return pe_mlp_plan(lib, x.shape[1], n_freqs, [w.shape[1] for w in weights],
                       [w.shape[0] for w in weights], x.shape[0], skip_mask)


def _launch_pe_fwd(lib, x, window, weights, biases, freqs, skip_idx, final_act, stream, save):
    """Run K4f; returns (out, acts, n), acts the saved hidden outputs
    (pe_act_layout) when save, else None, and n the CUDA launches made."""
    layers, skip_mask = _layer_args(weights, biases, skip_idx)
    n_freqs, freq_arr, window = _freq_args(freqs, window, x)
    plan = _pe_plan(lib, x, weights, n_freqs, skip_mask)
    out = torch.empty((x.shape[0], weights[-1].shape[0]), device=x.device, dtype=x.dtype)
    acts = torch.empty(x.shape[0] * plan.act_floats, device=x.device, dtype=x.dtype) if save else None
    wpk = torch.empty(plan.pk_floats, device=x.device, dtype=x.dtype)
    n_launches = ctypes.c_int(0)
    err = lib.lab4d_pe_mlp_fwd(
        x.data_ptr(), out.data_ptr(), None if acts is None else acts.data_ptr(), wpk.data_ptr(),
        *layers, x.shape[1], n_freqs, freq_arr, None if window is None else window.data_ptr(),
        x.shape[0], skip_mask, int(final_act), ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "pe_mlp_fwd")
    return out, acts, n_launches.value


def _launch_pe_bwd(lib, x, g, window, weights, biases, freqs, skip_idx, acts, stream, events=None):
    """Run K4b (its sequence of launches) from K4f's saved outputs acts;
    returns (dx, dWs, dbs, kinds): kinds lists each CUDA launch's kind
    (csrc/fused_pe_mlp.cu:lab4d_pe_mlp_bwd). events: CUDA events (created,
    as torch.cuda.Event after one record) recorded before the first launch
    and after each launch."""
    layers, skip_mask = _layer_args(weights, biases, skip_idx)
    n_freqs, freq_arr, window = _freq_args(freqs, window, x)
    plan = _pe_plan(lib, x, weights, n_freqs, skip_mask)
    if acts.shape != (x.shape[0] * plan.act_floats,) or acts.device != x.device or \
            acts.dtype != x.dtype or not acts.is_contiguous():
        raise ValueError(f"acts must hold {plan.act_floats} floats per point (pe_act_layout)")
    dx = torch.empty_like(x)
    flat = torch.empty(plan.n_params, device=x.device, dtype=x.dtype)
    scratch = torch.empty(plan.scratch_floats, device=x.device, dtype=x.dtype)
    n_ev = 64 if events is None else len(events)
    kinds = (ctypes.c_int * n_ev)()
    handles = None if events is None else (ctypes.c_void_p * n_ev)(*[e.cuda_event for e in events])
    n_launches = ctypes.c_int(0)
    err = lib.lab4d_pe_mlp_bwd(
        x.data_ptr(), g.data_ptr(), acts.data_ptr(), dx.data_ptr(), flat.data_ptr(),
        scratch.data_ptr(), *layers, x.shape[1], n_freqs, freq_arr,
        None if window is None else window.data_ptr(), x.shape[0], skip_mask, handles, kinds, n_ev,
        ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "pe_mlp_bwd")
    dws, dbs = _split_grads(flat, weights)
    return dx, dws, dbs, list(kinds[: min(n_launches.value, n_ev - 1)])


def needs_saved(*tensors):
    """Whether autograd may call a backward of a function of these inputs:
    grad mode is on and one of them requires a gradient. (Inside an
    autograd.Function's forward grad mode is off and needs_input_grad does
    not see it, so the caller decides.)"""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


# ------------------------------------------------------------------ K3f, K3b


def mlp_forward_saved(x, weights, biases, skip_idx=(), final_act: bool = False):
    """K3f with its saved hidden outputs: (out, acts), acts in
    pe_act_layout. A CUDA tensor runs K3f (counted in
    `fused_relu_mlp.launches`); a CPU tensor mlp_forward_saved_reference."""
    skip_idx = tuple(skip_idx)
    if x.device.type == "cpu":
        return mlp_forward_saved_reference(x, weights, biases, skip_idx, final_act)
    if x.device.type != "cuda":
        raise NotImplementedError(f"mlp_forward_saved has no kernel for device {x.device}")
    return _k3f_cuda(x, weights, biases, skip_idx, final_act, save=True)


def _k3f_cuda(x, weights, biases, skip_idx, final_act, save):
    _check_args(x, weights, biases, skip_idx)
    *out, n = _launch_k3f(_kernel_lib("fused_relu_mlp"), x, weights, biases, skip_idx, final_act,
                          _stream(x.device), save)
    fused_relu_mlp.launches += 1
    fused_relu_mlp.cuda_launches = n
    fused_relu_mlp.engine = _k3_plan(x, weights).engine
    return tuple(out)


class _FusedReluMLP(torch.autograd.Function):
    """Forward through K3f, saving every hidden layer output when `save`
    (the caller's needs_saved); backward through K3b from them. On CPU
    tensors (the tests) both run their plain versions of that dataflow."""

    @staticmethod
    def forward(ctx, x, skip_idx, final_act, save, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        if save:
            out, acts = mlp_forward_saved(x, weights, biases, skip_idx, final_act)
        elif x.device.type == "cuda":
            out, acts = _k3f_cuda(x, weights, biases, skip_idx, final_act, save=False)
        else:
            out, acts = mlp_reference(x, weights, biases, skip_idx, final_act), None
        ctx.skip_idx, ctx.final_act = skip_idx, final_act
        ctx.save_for_backward(x, out, acts, *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, out, acts, *params = ctx.saved_tensors
        if acts is None:
            raise RuntimeError("fused_relu_mlp ran without saving its layer outputs (no input "
                               "required a gradient, or grad mode was off)")
        n = len(params) // 2
        g = grad_out * (out > 0.0) if ctx.final_act else grad_out
        dx, dws, dbs = fused_relu_mlp_backward(x, g.contiguous(), params[:n], params[n:],
                                               ctx.skip_idx, saved=acts)
        return (dx, None, None, None, *dws, *dbs)


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
        weights: (out_i, in_i) per layer, at most 512 inputs and outputs on
            the card (within shared memory: lab4d_relu_mlp_smem); biases: (out_i,)
    Returns:
        (rows, out_last)

    A CUDA tensor goes through K3f (one count in `fused_relu_mlp.launches`
    for its CUDA launches, whose number is left in
    `fused_relu_mlp.cuda_launches`), which saves its hidden outputs when autograd needs a
    gradient (needs_saved), and its gradient through K3b; a CPU tensor
    through `mlp_reference`.
    """
    skip_idx = tuple(skip_idx)
    if x.device.type == "cuda":
        save = needs_saved(x, *weights, *biases)
        return _FusedReluMLP.apply(x, skip_idx, bool(final_act), save, *weights, *biases)
    if x.device.type == "cpu":
        return mlp_reference(x, weights, biases, skip_idx, final_act)
    raise NotImplementedError(f"fused_relu_mlp has no kernel for device {x.device}")


fused_relu_mlp.launches = 0
fused_relu_mlp.cuda_launches = 0
fused_relu_mlp.engine = None  # the engine of the last CUDA call: "cluster" or "rows"


def fused_relu_mlp_backward(x, g, weights, biases, skip_idx=(), saved=None):
    """VJP of fused_relu_mlp without the final ReLU (the caller masks g):
    (dx, dWs, dbs) for the output gradient g (rows, out_last). saved: the
    hidden outputs of mlp_forward_saved, which K3b needs. A CUDA tensor
    runs K3b (one count in `fused_relu_mlp_backward.launches` for its CUDA
    launches, whose number is left in
    `fused_relu_mlp_backward.cuda_launches`); a CPU tensor
    mlp_backward_saved_reference, or mlp_backward_reference when saved is
    None."""
    skip_idx = tuple(skip_idx)
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"fused_relu_mlp_backward has no kernel for device {x.device}")
    if saved is None:
        if x.device.type == "cuda":
            raise ValueError("K3b needs the layer outputs of mlp_forward_saved (saved=)")
        return mlp_backward_reference(x, g, weights, biases, skip_idx)
    if x.device.type == "cpu":
        return mlp_backward_saved_reference(x, g, weights, biases, skip_idx, saved)
    _check_args(x, weights, biases, skip_idx)
    if g.shape != (x.shape[0], weights[-1].shape[0]) or not g.is_contiguous() or g.dtype != x.dtype:
        raise ValueError(f"g must be a contiguous ({x.shape[0]}, {weights[-1].shape[0]}) float32 tensor")
    *out, n = _launch_k3b(_kernel_lib("fused_relu_mlp"), x, g, weights, biases, skip_idx, saved,
                          _stream(x.device))
    fused_relu_mlp_backward.launches += 1
    fused_relu_mlp_backward.cuda_launches = n
    fused_relu_mlp_backward.engine = _k3_plan(x, weights).engine
    return tuple(out)


fused_relu_mlp_backward.launches = 0
fused_relu_mlp_backward.cuda_launches = 0
fused_relu_mlp_backward.engine = None  # the engine of the last CUDA call


# ------------------------------------------------------------------ K4f, K4b


def pe_mlp_forward_saved(x, window, weights, biases, freqs, skip_idx=(), final_act: bool = False):
    """K4f with its saved hidden outputs: (out, acts), acts in
    pe_act_layout. A CUDA tensor runs K4f (counted in
    `fused_pe_mlp.launches`); a CPU tensor pe_mlp_forward_saved_reference."""
    freqs, skip_idx = tuple(float(f) for f in freqs), tuple(skip_idx)
    if x.device.type == "cpu":
        return pe_mlp_forward_saved_reference(x, window, weights, biases, freqs, skip_idx, final_act)
    if x.device.type != "cuda":
        raise NotImplementedError(f"pe_mlp_forward_saved has no kernel for device {x.device}")
    return _pe_forward_cuda(x, window, weights, biases, freqs, skip_idx, final_act, save=True)


def _check_pe_args(x, weights, biases, skip_idx, n_freqs):
    _check_args(x, weights, biases, skip_idx, n_freqs)
    check_pe_widths(x.shape[1] * (2 * n_freqs + 1), [w.shape[0] for w in weights])


def _pe_forward_cuda(x, window, weights, biases, freqs, skip_idx, final_act, save):
    _check_pe_args(x, weights, biases, skip_idx, len(freqs))
    *out, n = _launch_pe_fwd(_kernel_lib("fused_pe_mlp"), x, window, weights, biases, freqs,
                             skip_idx, final_act, _stream(x.device), save)
    fused_pe_mlp.launches += 1
    fused_pe_mlp.cuda_launches = n
    return tuple(out)


class _FusedPEMLP(torch.autograd.Function):
    """Forward through K4f, saving every hidden layer output when `save`
    (the caller's needs_saved); backward through K4b from them; no gradient
    reaches the window (the JAX VJP returns zeros for it). On CPU tensors
    (the tests) both run their plain versions of that dataflow."""

    @staticmethod
    def forward(ctx, x, window, freqs, skip_idx, final_act, save, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        if save:
            out, acts = pe_mlp_forward_saved(x, window, weights, biases, freqs, skip_idx, final_act)
        elif x.device.type == "cuda":
            out, acts = _pe_forward_cuda(x, window, weights, biases, freqs, skip_idx, final_act,
                                         save=False)
        else:
            out, acts = pe_mlp_reference(x, window, weights, biases, freqs, skip_idx, final_act), None
        ctx.freqs, ctx.skip_idx, ctx.final_act = freqs, skip_idx, final_act
        ctx.save_for_backward(x, out, window, acts, *params)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, out, window, acts, *params = ctx.saved_tensors
        if acts is None:
            raise RuntimeError("fused_pe_mlp ran without saving its layer outputs (no input "
                               "required a gradient, or grad mode was off)")
        n = len(params) // 2
        g = grad_out * (out > 0.0) if ctx.final_act else grad_out
        dx, dws, dbs = fused_pe_mlp_backward(x, g.contiguous(), window, params[:n], params[n:],
                                             ctx.freqs, ctx.skip_idx, saved=acts)
        return (dx, None, None, None, None, None, *dws, *dbs)


def fused_pe_mlp(x, window, weights, biases, freqs, skip_idx=(), final_act: bool = False):
    """Fourier-embed + fused MLP in one pass.

    Args:
        x: (rows, C) raw coordinates; window: (F,) annealing weights or None
        weights/biases: MLP params consuming C * (2F + 1) inputs, (out, in),
            at most 128 columns each on the card (and the embedding too)
        freqs: the F frequency bands (Python floats)
    Returns:
        (rows, out_last)

    A CUDA tensor goes through K4f (one count in `fused_pe_mlp.launches`
    for its CUDA launches, whose number is left in
    `fused_pe_mlp.cuda_launches`), which saves its hidden outputs when
    autograd needs a gradient
    (needs_saved), and its gradient through K4b; a CPU tensor through
    `pe_mlp_reference`.
    """
    freqs, skip_idx = tuple(float(f) for f in freqs), tuple(skip_idx)
    if x.device.type == "cuda":
        save = needs_saved(x, *weights, *biases)
        return _FusedPEMLP.apply(x, window, freqs, skip_idx, bool(final_act), save, *weights,
                                 *biases)
    if x.device.type == "cpu":
        return pe_mlp_reference(x, window, weights, biases, freqs, skip_idx, final_act)
    raise NotImplementedError(f"fused_pe_mlp has no kernel for device {x.device}")


fused_pe_mlp.launches = 0
fused_pe_mlp.cuda_launches = 0


def fused_pe_mlp_backward(x, g, window, weights, biases, freqs, skip_idx=(), saved=None):
    """VJP of fused_pe_mlp without the final ReLU (the caller masks g):
    (dx, dWs, dbs). saved: the hidden outputs of pe_mlp_forward_saved, which
    K4b needs. A CUDA tensor runs K4b (one count in
    `fused_pe_mlp_backward.launches` for its sequence of CUDA launches,
    whose number is left in `fused_pe_mlp_backward.cuda_launches`); a CPU
    tensor pe_mlp_backward_saved_reference, or pe_mlp_backward_reference
    when saved is None."""
    freqs, skip_idx = tuple(float(f) for f in freqs), tuple(skip_idx)
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"fused_pe_mlp_backward has no kernel for device {x.device}")
    if saved is None:
        if x.device.type == "cuda":
            raise ValueError("K4b needs the layer outputs of pe_mlp_forward_saved (saved=)")
        return pe_mlp_backward_reference(x, g, window, weights, biases, freqs, skip_idx)
    if x.device.type == "cpu":
        return pe_mlp_backward_saved_reference(x, g, window, weights, biases, freqs, skip_idx,
                                               saved)
    _check_pe_args(x, weights, biases, skip_idx, len(freqs))
    if g.shape != (x.shape[0], weights[-1].shape[0]) or not g.is_contiguous() or g.dtype != x.dtype:
        raise ValueError(f"g must be a contiguous ({x.shape[0]}, {weights[-1].shape[0]}) float32 tensor")
    *out, kinds = _launch_pe_bwd(_kernel_lib("fused_pe_mlp"), x, g, window, weights, biases, freqs,
                                 skip_idx, saved, _stream(x.device))
    fused_pe_mlp_backward.launches += 1
    fused_pe_mlp_backward.cuda_launches = len(kinds)
    return tuple(out)


fused_pe_mlp_backward.launches = 0
fused_pe_mlp_backward.cuda_launches = 0
