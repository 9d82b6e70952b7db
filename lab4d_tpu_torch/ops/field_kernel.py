"""All per-point heads of the FeatureNeRF field in one pass: the CUDA
kernels K1 (forward) and K2 (backward) and their plain versions.

Port of lab4d_tpu/ops/field_kernel.py. Weights use the torch.nn.Linear
layout, (out, in), as in ops/mlp_kernel.py. `nets` maps each head to its
flat [W0, b0, W1, b1, ...] list: "base", "color", "vis" and "feat" are ReLU
MLPs over the Fourier embedding of the points (skip layers re-read it),
"sdf" the sdf head, "rgb1" / "rgb2" the rgb head, whose first layer takes
[hc, appearance code].

- K1 `fused_nerf_heads` (csrc/nerf_heads.cu): density (VolSDF of the sdf),
  sigmoid rgb, visibility logit and the L2-normalised feature of every
  point, with one appearance row per pair of `spp` points.
- K2 `fused_nerf_heads_backward` (csrc/nerf_heads.cu): its VJP: dx, the
  appearance rows' gradient, every weight and bias gradient, d ibeta; the
  annealing windows get zeros, as in the JAX VJP.

Each public function launches its kernel for a CUDA tensor (counted in
`<function>.launches`) and uses its plain version for a CPU tensor; on any
other device it raises. `fused_nerf_heads` is differentiable: on the card
its backward is K2, first order only.

The kernels read the nets in the split layout of `split_nets` (a skip
layer's weight as its X and h column blocks, rgb1's as its hc and
appearance blocks); `merge_net_grads` puts the gradients back into the
callers' shapes. The direction input of the JAX kernel is left out: the
field takes this path only without a direction encoding
(nnutils/feature.py:field_kernel_ok).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lab4d_tpu_torch.nnutils.embedding import fourier_embed
from lab4d_tpu_torch.ops.mlp_kernel import (
    SMEM_PER_SM,
    TILE_KC,
    _n_sm,
    _raise_on,
    _stream,
    _vjp,
    mlp_reference,
)

OUT_DIMS = (1, 3, 1, 16)  # density, rgb, vis, feat
NET_ORDER = ("base", "sdf", "color", "rgb1", "rgb2", "vis", "feat")
HEADS = ("base", "color", "vis", "feat")  # the MLP heads, in the kernel's order

FieldCfg = collections.namedtuple(
    "FieldCfg",
    "freqs nf_base nf_color nf_vis nf_feat skips_base skips_color skips_vis skips_feat",
)
_NET_SKIPS = dict(base="skips_base", color="skips_color", vis="skips_vis", feat="skips_feat")
_NET_FREQS = dict(base="nf_base", color="nf_color", vis="nf_vis", feat="nf_feat")

MAX_LAYERS = 8  # NH_MAX_LAYERS in csrc/nerf_heads.cu
MAX_FREQS = 16  # TM_MAX_FREQS in csrc/mlp_tiles.cuh
FWD_TILES = (64, 32, 16, 8)
BWD_TILES = (32, 16, 8)


# ------------------------------------------------------------- net layouts


def split_nets(nets, cfg, appr_dim: int):
    """Rewrite every skip-layer weight (out, c_x + h) into its [W_x, W_h]
    column blocks and rgb1's weight (out, hc + appr) into [W_hc, W_appr],
    each contiguous, so the kernels never concatenate an operand."""
    out = {}
    for name, arrs in nets.items():
        if name in _NET_SKIPS:
            skips = getattr(cfg, _NET_SKIPS[name])
            n = len(arrs) // 2
            xdim = arrs[0].shape[1]
            lst = []
            for i in range(n):
                w, b = arrs[2 * i], arrs[2 * i + 1]
                if i in skips:
                    lst += [w[:, :xdim].contiguous(), w[:, xdim:].contiguous(), b.contiguous()]
                else:
                    lst += [w.contiguous(), b.contiguous()]
            out[name] = lst
        elif name == "rgb1":
            w, b = arrs
            hc_w = w.shape[1] - appr_dim
            out[name] = [w[:, :hc_w].contiguous(), w[:, hc_w:].contiguous(), b.contiguous()]
        else:
            out[name] = [a.contiguous() for a in arrs]
    return out


def merge_net_grads(dnets, nets, cfg):
    """Inverse of split_nets on gradients: the column blocks concatenated
    back into the callers' weight shapes."""
    out = {}
    for name, arrs in nets.items():
        g = dnets[name]
        if name in _NET_SKIPS:
            skips = getattr(cfg, _NET_SKIPS[name])
            lst, pos = [], 0
            for i in range(len(arrs) // 2):
                if i in skips:
                    lst += [torch.cat([g[pos], g[pos + 1]], dim=1), g[pos + 2]]
                    pos += 3
                else:
                    lst += [g[pos], g[pos + 1]]
                    pos += 2
            out[name] = lst
        elif name == "rgb1":
            out[name] = [torch.cat(g[:-1], dim=1), g[-1]]
        else:
            out[name] = list(g)
    return out


def flatten_nets(nets):
    """Flat list of the nets' arrays in NET_ORDER, and its (name, index)
    order for unflatten_nets."""
    flat, order = [], []
    for name in NET_ORDER:
        for i, a in enumerate(nets[name]):
            order.append((name, i))
            flat.append(a)
    return flat, tuple(order)


def unflatten_nets(flat, order):
    nets = {}
    for (name, _), a in zip(order, flat):
        nets.setdefault(name, []).append(a)
    return nets


# ------------------------------------------------------------ plain versions


def nerf_heads_reference(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp):
    """Plain version of K1, the JAX oracle's dataflow: each head's MLP over
    fourier_embed's layout, VolSDF density (with expm1), sigmoid rgb,
    normalised feature. x: (P, 3); appr_rows: (P / spp, Ca); win_b / win_c:
    (nf_base,) / (nf_color,) windows or None; ibeta: one element. Returns
    (density (P,1), rgb (P,3), vis (P,1), feat (P,16))."""
    freqs = cfg.freqs

    def run(name, window, final_act):
        wb = nets[name]
        embed = fourier_embed(x, freqs[: getattr(cfg, _NET_FREQS[name])], window)
        return mlp_reference(embed, wb[0::2], wb[1::2], getattr(cfg, _NET_SKIPS[name]), final_act)

    feat = run("base", win_b, True)
    sdf = F.linear(feat, *nets["sdf"])
    hc = feat + run("color", win_c, True)
    rep = appr_rows.repeat_interleave(spp, dim=0)
    rgb_h = torch.relu(F.linear(torch.cat([hc, rep], dim=-1), *nets["rgb1"]))
    rgb = torch.sigmoid(F.linear(rgb_h, *nets["rgb2"]))
    vis = run("vis", None, False)
    f16 = run("feat", None, False)
    ib = ibeta.reshape(())
    density = (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) * ib)) * ib
    f16 = f16 / torch.clamp(torch.sqrt(torch.sum(f16 * f16, -1, keepdim=True) + 1e-12), min=1e-6)
    return density, rgb, vis, f16


def nerf_heads_backward_reference(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp):
    """Plain version of K2: (dx, dappr, dnets, dibeta) of
    nerf_heads_reference for the cotangents g = (g_density, g_rgb, g_vis,
    g_feat); no gradient reaches the windows."""
    flat, order = flatten_nets(nets)

    def fn(x_, appr_, ibeta_, *p):
        return nerf_heads_reference(x_, appr_, win_b, win_c, unflatten_nets(p, order), ibeta_,
                                    cfg, spp)

    grads = _vjp(fn, (x, appr_rows, ibeta, *flat), tuple(g))
    return grads[0], grads[1], unflatten_nets(grads[3:], order), grads[2]


# ---------------------------------------------------------- launch planning


class HeadsPlan(NamedTuple):
    tile_rows: int
    smem_bytes: int
    grid: int


class HeadsDims(NamedTuple):
    """Widths that size the kernels' shared memory (NhArgs in
    csrc/nerf_heads.cu)."""
    width: int  # output width of base and colour (hc)
    rgb_hidden: int
    max_cx: int  # widest embedding
    g_width: int  # widest layer output
    h_total: int  # most floats per row of one head's layer outputs
    stage_ld: int


def heads_dims(nets, cfg) -> HeadsDims:
    c_x = {n: 3 * (2 * getattr(cfg, _NET_FREQS[n]) + 1) for n in HEADS}
    outs = {n: [w.shape[0] for w in nets[n][0::2]] for n in HEADS}
    ins = [w.shape[1] for n in HEADS for w in nets[n][0::2]]
    width, rgb_hidden = nets["base"][-2].shape[0], nets["rgb1"][0].shape[0]
    max_w = max(width, rgb_hidden, *ins, *(o for n in HEADS for o in outs[n]))
    return HeadsDims(
        width=width, rgb_hidden=rgb_hidden, max_cx=max(c_x.values()),
        g_width=max(rgb_hidden, *(o for n in HEADS for o in outs[n])),
        h_total=max(sum(outs[n]) for n in HEADS), stage_ld=(max_w + 31) // 32 * 32 + 4,
    )


def heads_smem(d: HeadsDims, tile_rows: int, backward: bool) -> int:
    """Shared memory of K1 / K2 (nh_fwd_smem / nh_bwd_smem), bytes."""
    ts = tile_rows + 4
    if backward:
        per_row = 2 * d.max_cx + 4 + d.h_total + 2 * d.g_width + d.width + 4
    else:
        per_row = d.max_cx + 2 * d.g_width + d.width
    return 4 * (ts * per_row + (d.rgb_hidden + 3) // 4 * 4 + TILE_KC * d.stage_ld)


def heads_plan(d: HeadsDims, spp: int, rows: int, backward: bool, n_sm: int) -> HeadsPlan:
    """Tile height (a divisor of the samples of a pair), shared memory and
    grid of a K1 / K2 launch. K1: the tallest tile that leaves room for two
    blocks per SM, one block per tile. K2: the tallest tile that fits; a
    grid-stride launch of at most one block per SM per slot, since the
    workspace holds a slice of every weight gradient per block."""
    if rows % spp:
        raise ValueError(f"{rows} points are not whole pairs of {spp}")
    cands = [t for t in (BWD_TILES if backward else FWD_TILES) if spp % t == 0]
    fits = [t for t in cands if heads_smem(d, t, backward) <= SMEM_PER_SM]
    if not backward:
        fits = [t for t in fits if heads_smem(d, t, False) <= SMEM_PER_SM // 2] or fits
    if not fits:
        raise ValueError(f"no tile of {cands} fits the heads' shared memory for {spp} samples per pair")
    tr = fits[0]
    smem = heads_smem(d, tr, backward)
    ntiles = rows // tr
    if backward:
        grid = min(ntiles, n_sm * max(1, min(2, SMEM_PER_SM // smem)))
    else:
        grid = ntiles
    return HeadsPlan(tr, smem, grid)


# ------------------------------------------------------------- the library


class _NhHead(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("n_layers", "skip_mask", "n_freqs", "c_x")] + [
        (n, ctypes.c_int * MAX_LAYERS) for n in ("in_dim", "out_dim", "k1", "off_w1", "off_w2", "off_b")
    ] + [("window", ctypes.c_void_p)] + [
        (n, ctypes.c_void_p * MAX_LAYERS) for n in ("w1", "w2", "b")
    ]


_ARG_INTS = ("rows", "spp", "tr", "ts", "stage_ld", "width", "rgb_hidden", "appr_dim", "feat_dim",
             "max_cx", "g_width", "h_total", "off_w_sdf", "off_b_sdf", "off_w_hc", "off_w_rgb2",
             "off_b_rgb2", "off_dibeta", "n_slice")
_ARG_PTRS = ("w_sdf", "b_sdf", "w_hc", "w_appr", "b_rgb1", "w_rgb2", "b_rgb2", "ibeta")


class _NhArgs(ctypes.Structure):
    _fields_ = [("head", _NhHead * len(HEADS))] + [(n, ctypes.c_int) for n in _ARG_INTS] + [
        ("freq", ctypes.c_float * MAX_FREQS)
    ] + [(n, ctypes.c_void_p) for n in _ARG_PTRS]


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    """csrc/nerf_heads.cu, built on first use, with its C signatures."""
    from lab4d_tpu_torch.ops.build import load_library

    return bind_signatures(load_library("nerf_heads"))


def bind_signatures(lib):
    """Declare the C signatures of a nerf_heads library and check its
    NhArgs layout against _NhArgs; returns lib."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lab4d_nerf_heads_fwd.argtypes = [vp] * 7 + [i32, vp]
    lib.lab4d_nerf_heads_fwd.restype = i32
    lib.lab4d_nerf_heads_bwd.argtypes = [vp] * 13 + [i32, vp]
    lib.lab4d_nerf_heads_bwd.restype = i32
    lib.lab4d_nerf_heads_args_size.argtypes = []
    lib.lab4d_nerf_heads_args_size.restype = i32
    lib.lab4d_cuda_error_string.argtypes = [i32]
    lib.lab4d_cuda_error_string.restype = ctypes.c_char_p
    if lib.lab4d_nerf_heads_args_size() != ctypes.sizeof(_NhArgs):
        raise RuntimeError("the NhArgs layout of csrc/nerf_heads.cu differs from _NhArgs")
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _grad_offsets(snets, rgb_hidden, appr_dim):
    """Offsets of every split array's gradient in the kernel's flat output:
    the workspace slice (all but rgb1's W_appr and bias, then d ibeta), then
    dW_appr and db_rgb1, which the appearance pass writes."""
    offs, n = {}, 0
    for name in NET_ORDER:
        for i, a in enumerate(snets[name]):
            if name == "rgb1" and i > 0:
                continue
            offs[(name, i)] = n
            n += a.numel()
    offs["dibeta"] = n
    n_slice = n + 1
    offs[("rgb1", 1)] = n_slice
    offs[("rgb1", 2)] = n_slice + rgb_hidden * appr_dim
    return offs, n_slice, n_slice + rgb_hidden * appr_dim + rgb_hidden


def _check_inputs(x, appr, win_b, win_c, nets, ibeta, cfg, spp):
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (P, 3) float32 tensor, got {tuple(x.shape)} {x.dtype}")
    P = x.shape[0]
    if spp < 1 or P < spp or P % spp:
        raise ValueError(f"{P} points are not whole pairs of {spp} samples")
    if appr is None or appr.ndim != 2 or appr.shape[0] != P // spp or not appr.is_contiguous():
        raise ValueError(f"appr_rows must be a contiguous ({P // spp}, Ca) tensor")
    if len(cfg.freqs) > MAX_FREQS:
        raise ValueError(f"at most {MAX_FREQS} frequencies, got {len(cfg.freqs)}")
    for name, win in (("nf_base", win_b), ("nf_color", win_c)):
        if win is not None and (win.shape != (getattr(cfg, name),) or not win.is_contiguous()):
            raise ValueError(f"window of {name} must be a contiguous ({getattr(cfg, name)},) tensor")
    if ibeta.numel() != 1:
        raise ValueError("ibeta must hold one value")
    tensors = [x, appr, ibeta] + [t for t in (win_b, win_c) if t is not None] + flatten_nets(nets)[0]
    for t in tensors:
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("all tensors must be float32 on the device of x")
    for name in HEADS:
        if len(nets[name]) // 2 > MAX_LAYERS:
            raise ValueError(f"head {name} has more than {MAX_LAYERS} layers")


def _build_args(x, appr, win_b, win_c, nets, snets, ibeta, cfg, spp, plan, dims, offs, n_slice):
    """The NhArgs of a launch: every pointer of the split nets, the heads'
    layer tables and the gradients' workspace offsets."""
    a = _NhArgs()
    windows = {"base": win_b, "color": win_c}
    for hi, name in enumerate(HEADS):
        h = a.head[hi]
        skips = getattr(cfg, _NET_SKIPS[name])
        n = len(nets[name]) // 2
        h.n_layers, h.n_freqs = n, getattr(cfg, _NET_FREQS[name])
        h.c_x = 3 * (2 * h.n_freqs + 1)
        h.skip_mask = sum(1 << i for i in skips if i < n)
        h.window = _ptr(windows.get(name))
        pos = 0
        for i in range(n):
            w1 = snets[name][pos]
            h.w1[i], h.off_w1[i], h.k1[i] = w1.data_ptr(), offs[(name, pos)], w1.shape[1]
            h.out_dim[i] = w1.shape[0]
            if i in skips:
                w2 = snets[name][pos + 1]
                h.w2[i], h.off_w2[i] = w2.data_ptr(), offs[(name, pos + 1)]
                h.in_dim[i] = w1.shape[1] + w2.shape[1]
                pos += 1
            else:
                h.w2[i], h.in_dim[i] = None, w1.shape[1]
            h.b[i], h.off_b[i] = snets[name][pos + 1].data_ptr(), offs[(name, pos + 1)]
            pos += 2
    ints = dict(rows=x.shape[0], spp=spp, tr=plan.tile_rows, ts=plan.tile_rows + 4,
                stage_ld=dims.stage_ld, width=dims.width, rgb_hidden=dims.rgb_hidden,
                appr_dim=appr.shape[1], feat_dim=nets["feat"][-2].shape[0], max_cx=dims.max_cx,
                g_width=dims.g_width, h_total=dims.h_total, off_w_sdf=offs[("sdf", 0)],
                off_b_sdf=offs[("sdf", 1)], off_w_hc=offs[("rgb1", 0)], off_w_rgb2=offs[("rgb2", 0)],
                off_b_rgb2=offs[("rgb2", 1)], off_dibeta=offs["dibeta"], n_slice=n_slice)
    for k, v in ints.items():
        setattr(a, k, v)
    for f, v in enumerate(cfg.freqs):
        a.freq[f] = float(v)
    ptrs = dict(w_sdf=snets["sdf"][0], b_sdf=snets["sdf"][1], w_hc=snets["rgb1"][0],
                w_appr=snets["rgb1"][1], b_rgb1=snets["rgb1"][2], w_rgb2=snets["rgb2"][0],
                b_rgb2=snets["rgb2"][1], ibeta=ibeta)
    for k, v in ptrs.items():
        setattr(a, k, v.data_ptr())
    return a


def _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp, backward, n_sm):
    _check_inputs(x, appr, win_b, win_c, nets, ibeta, cfg, spp)
    ibeta = ibeta.reshape(1).contiguous()
    snets = split_nets(nets, cfg, appr.shape[1])
    dims = heads_dims(nets, cfg)
    plan = heads_plan(dims, spp, x.shape[0], backward, n_sm)
    offs, n_slice, n_grads = _grad_offsets(snets, dims.rgb_hidden, appr.shape[1])
    args = _build_args(x, appr, win_b, win_c, nets, snets, ibeta, cfg, spp, plan, dims, offs, n_slice)
    # snets and ibeta hold the memory that args points to
    return args, plan, snets, offs, n_slice, n_grads, ibeta


def _launch_fwd(lib, x, appr, win_b, win_c, nets, ibeta, cfg, spp, stream):
    """Run K1; returns (density, rgb, vis, feat)."""
    args, plan, _snets, _, _, _, _ibeta = _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp,
                                                   backward=False, n_sm=1)
    P = x.shape[0]
    outs = [torch.empty((P, c), device=x.device, dtype=x.dtype) for c in OUT_DIMS[:3]]
    outs.append(torch.empty((P, nets["feat"][-2].shape[0]), device=x.device, dtype=x.dtype))
    err = lib.lab4d_nerf_heads_fwd(ctypes.addressof(args), x.data_ptr(), appr.data_ptr(),
                                   *[o.data_ptr() for o in outs], plan.grid, stream)
    _raise_on(lib, err, "nerf_heads_fwd")
    return tuple(outs)


def _launch_bwd(lib, x, g, appr, win_b, win_c, nets, ibeta, cfg, spp, n_sm, stream):
    """Run K2 and its reductions; returns (dx, dappr, dnets, dibeta)."""
    P = x.shape[0]
    feat_dim = nets["feat"][-2].shape[0]
    for gi, c in zip(g, OUT_DIMS[:3] + (feat_dim,)):
        if gi.shape != (P, c) or gi.dtype != x.dtype or gi.device != x.device or not gi.is_contiguous():
            raise ValueError(f"each cotangent must be a contiguous ({P}, {c}) float32 tensor")
    args, plan, snets, offs, n_slice, n_grads, _ibeta = _prepare(
        x, appr, win_b, win_c, nets, ibeta, cfg, spp, backward=True, n_sm=n_sm)
    dev, rh = x.device, args.rgb_hidden
    dx = torch.empty_like(x)
    dappr = torch.empty_like(appr)
    grads = torch.empty(n_grads, device=dev, dtype=x.dtype)
    ws = torch.empty(plan.grid * n_slice, device=dev, dtype=x.dtype)
    gsum_ws = torch.empty((P // plan.tile_rows) * rh, device=dev, dtype=x.dtype)
    gpair = torch.empty((P // spp) * rh, device=dev, dtype=x.dtype)
    err = lib.lab4d_nerf_heads_bwd(
        ctypes.addressof(args), x.data_ptr(), appr.data_ptr(), *[t.data_ptr() for t in g],
        dx.data_ptr(), ws.data_ptr(), gsum_ws.data_ptr(), gpair.data_ptr(), grads.data_ptr(),
        dappr.data_ptr(), plan.grid, stream)
    _raise_on(lib, err, "nerf_heads_bwd")
    dsplit = {name: [grads[offs[(name, i)]: offs[(name, i)] + a.numel()].view(a.shape)
                     for i, a in enumerate(arrs)] for name, arrs in snets.items()}
    dibeta = grads[offs["dibeta"]: offs["dibeta"] + 1]
    return dx, dappr, merge_net_grads(dsplit, nets, cfg), dibeta


# ------------------------------------------------------------------ K1, K2


class _FusedNerfHeads(torch.autograd.Function):
    """Forward through K1, backward through K2; zeros for the windows."""

    @staticmethod
    def forward(ctx, x, appr, win_b, win_c, ibeta, cfg, spp, order, *flat):
        outs = _launch_fwd(_kernel_lib(), x, appr, win_b, win_c, unflatten_nets(flat, order), ibeta,
                           cfg, spp, _stream(x.device))
        fused_nerf_heads.launches += 1
        ctx.cfg, ctx.spp, ctx.order = cfg, spp, order
        ctx.save_for_backward(x, appr, win_b, win_c, ibeta, *flat)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *g):
        x, appr, win_b, win_c, ibeta, *flat = ctx.saved_tensors
        nets = unflatten_nets(flat, ctx.order)
        dx, dappr, dnets, dibeta = fused_nerf_heads_backward(
            x, [t.contiguous() for t in g], appr, win_b, win_c, nets, ibeta, ctx.cfg, ctx.spp)
        zeros = [None if w is None else torch.zeros_like(w) for w in (win_b, win_c)]
        return (dx, dappr, *zeros, dibeta.reshape(ibeta.shape), None, None, None,
                *flatten_nets(dnets)[0])


def fused_nerf_heads(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp):
    """Every per-point head of the field in one pass.

    Args:
        x: (P, 3) canonical points, P a multiple of spp
        appr_rows: (P / spp, Ca) appearance code of each pair of spp points
        win_b / win_c: (nf_base,) / (nf_color,) annealing windows or None
        nets: {head: [W0, b0, ...]} in the (out, in) layout; ibeta: (1,)
        cfg: FieldCfg; spp: samples per pair
    Returns:
        density (P,1), sigmoid rgb (P,3), visibility logit (P,1),
        normalised feature (P,16)

    A CUDA tensor goes through K1 (counted in `fused_nerf_heads.launches`)
    and its gradient through K2; a CPU tensor through nerf_heads_reference.
    """
    if x.device.type == "cuda":
        flat, order = flatten_nets(nets)
        return _FusedNerfHeads.apply(x, appr_rows, win_b, win_c, ibeta, cfg, spp, order, *flat)
    if x.device.type == "cpu":
        return nerf_heads_reference(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp)
    raise NotImplementedError(f"fused_nerf_heads has no kernel for device {x.device}")


fused_nerf_heads.launches = 0


def fused_nerf_heads_backward(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp):
    """VJP of fused_nerf_heads for the cotangents g = (g_density, g_rgb,
    g_vis, g_feat): (dx, dappr, dnets, dibeta), dnets in the shapes of nets.
    K2 on a CUDA tensor (counted in `fused_nerf_heads_backward.launches`),
    nerf_heads_backward_reference on a CPU tensor."""
    if x.device.type == "cpu":
        return nerf_heads_backward_reference(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp)
    if x.device.type != "cuda":
        raise NotImplementedError(f"fused_nerf_heads_backward has no kernel for device {x.device}")
    out = _launch_bwd(_kernel_lib(), x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp,
                      _n_sm(x.device), _stream(x.device))
    fused_nerf_heads_backward.launches += 1
    return out


fused_nerf_heads_backward.launches = 0
