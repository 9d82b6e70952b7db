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
  point, with one appearance row per pair of `spp` points. When autograd
  needs a gradient it also saves every layer output (`act_layout`,
  `nerf_heads_forward_saved`).
- K2 `fused_nerf_heads_backward` (csrc/nerf_heads.cu): its VJP from those
  saved outputs: dx, the appearance rows' gradient, every weight and bias
  gradient, d ibeta; the annealing windows get zeros, as in the JAX VJP.
  Its plain version on the same saved outputs is
  `nerf_heads_backward_saved_reference`.

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
from lab4d_tpu_torch.ops.mlp_kernel import (SMEM_PER_SM, _raise_on, _stream, _vjp, mlp_reference,
                                            needs_saved)

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
MAX_FREQS = 16  # NH_MAX_FREQS in csrc/nerf_heads.cu


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


def act_layout(nets):
    """The layout of the layer outputs K1 saves for K2: {(head, layer):
    floats per point before that layer's block}, the same for rgb_h, and
    the floats per point in all. Each block is a row-major (P, out) array
    at offset * P; the order is base, colour, rgb_h, visibility, feature."""
    offs, n = {}, 0
    for name in ("base", "color", "rgb_h", "vis", "feat"):
        if name == "rgb_h":
            offs[name] = n
            n += nets["rgb1"][0].shape[0]
            continue
        for i, w in enumerate(nets[name][0::2]):
            offs[(name, i)] = n
            n += w.shape[0]
    return offs, n


def pack_layout(nets, cfg):
    """Where K1's pre-split weights go (nh_pack_kernel): {(head, layer),
    "rgb1", "rgb2": offset}, and the floats in all. A layer of N outputs and
    K inputs takes 2 N kp floats (hi, then lo), kp = K rounded up to 32."""
    offs, n = {}, 0
    layers = [((name, i), w.shape) for name in HEADS for i, w in enumerate(nets[name][0::2])]
    hc = nets["base"][-2].shape[0]
    layers += [("rgb1", (nets["rgb1"][0].shape[0], hc)), ("rgb2", nets["rgb2"][0].shape)]
    for key, (N, K) in layers:
        offs[key] = n
        n += 2 * N * (-(-K // 32) * 32)
    return offs, n


def _head_layers(x, window, wb, skips, freqs):
    """Every layer output of one head before its ReLU (ReLU between the
    layers, none after the last)."""
    X = fourier_embed(x, freqs, window)
    h, outs = X, []
    for i in range(len(wb) // 2):
        if i in skips:
            h = torch.cat([X, h], dim=-1)
        z = F.linear(h, wb[2 * i], wb[2 * i + 1])
        outs.append(z)
        h = torch.relu(z)
    return outs


def nerf_heads_forward_saved_reference(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp,
                                       pre_activations=False):
    """Plain version of K1 with its saved layer outputs: ((density, rgb,
    vis, feat), acts), acts the flat (P * floats per point,) buffer in
    act_layout's order, as K1 writes it when autograd needs it. With
    pre_activations, acts holds each layer's output before its ReLU
    instead (the inputs whose sign decides each ReLU's gradient)."""
    freqs = cfg.freqs
    zs = {}
    for name, win in (("base", win_b), ("color", win_c), ("vis", None), ("feat", None)):
        nf = getattr(cfg, _NET_FREQS[name])
        zs[name] = _head_layers(x, win, nets[name], getattr(cfg, _NET_SKIPS[name]), freqs[:nf])
    hs = {name: [torch.relu(z) for z in zl] for name, zl in zs.items()}
    feat = hs["base"][-1]
    hc = feat + hs["color"][-1]
    rep = appr_rows.repeat_interleave(spp, dim=0)
    z_rgbh = F.linear(torch.cat([hc, rep], dim=-1), *nets["rgb1"])
    rgb_h = torch.relu(z_rgbh)
    rgb = torch.sigmoid(F.linear(rgb_h, *nets["rgb2"]))
    sdf = F.linear(feat, *nets["sdf"])
    ib = ibeta.reshape(())
    density = (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) * ib)) * ib
    vis, f16 = zs["vis"][-1], zs["feat"][-1]
    feat_n = f16 / torch.clamp(torch.sqrt(torch.sum(f16 * f16, -1, keepdim=True) + 1e-12), min=1e-6)
    if pre_activations:
        blocks = zs["base"] + zs["color"] + [z_rgbh] + zs["vis"] + zs["feat"]
    else:
        blocks = (hs["base"] + hs["color"] + [rgb_h] + hs["vis"][:-1] + [vis] + hs["feat"][:-1]
                  + [f16])
    acts = torch.cat([b.reshape(-1) for b in blocks])
    return (density, rgb, vis, feat_n), acts


def nerf_heads_backward_saved_reference(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp,
                                        acts, rgb):
    """Plain version of K2's dataflow: (dx, dappr, dnets, dibeta) of
    nerf_heads_reference from the saved layer outputs `acts` (act_layout)
    and the forward's rgb, layer by layer in reverse, as K2 runs it."""
    P = x.shape[0]
    offs, _ = act_layout(nets)
    gd, grgb, gvis, gfeat = g

    def saved(key, width):
        return acts[offs[key] * P: (offs[key] + width) * P].view(P, width)

    def last(name):
        n = len(nets[name]) // 2 - 1
        return saved((name, n), nets[name][2 * n].shape[0])

    dn = {name: [None] * len(arrs) for name, arrs in nets.items()}
    feat, col, f16 = last("base"), last("color"), last("feat")
    rh = nets["rgb1"][0].shape[0]
    rgb_h = saved("rgb_h", rh)
    ib = ibeta.reshape(())
    s = F.linear(feat, *nets["sdf"])
    e = torch.exp(-torch.abs(s) * ib)
    g_sdf = gd * (-0.5 * ib * ib * e)
    dibeta = (gd * (0.5 + 0.5 * torch.sign(s) * torch.expm1(-torch.abs(s) * ib) - 0.5 * ib * s * e)).sum()
    dn["sdf"] = [g_sdf.T @ feat, g_sdf.sum(0)]
    g_rgb = grgb * rgb * (1 - rgb)
    dn["rgb2"] = [g_rgb.T @ rgb_h, g_rgb.sum(0)]
    g_rgbh = (g_rgb @ nets["rgb2"][0]) * (rgb_h > 0)
    hc = feat + col
    w_hc = nets["rgb1"][0][:, : hc.shape[1]]
    w_appr = nets["rgb1"][0][:, hc.shape[1]:]
    gpair = g_rgbh.view(-1, spp, rh).sum(1)
    dappr = gpair @ w_appr
    dn["rgb1"] = [torch.cat([g_rgbh.T @ hc, gpair.T @ appr_rows], dim=1), gpair.sum(0)]
    dhc = g_rgbh @ w_hc
    nrm = torch.clamp(torch.sqrt(torch.sum(f16 * f16, -1, keepdim=True) + 1e-12), min=1e-6)
    fv = f16 / nrm
    g_f16 = (gfeat - fv * (fv * gfeat).sum(-1, keepdim=True)) / nrm
    g_start = {"base": (dhc + g_sdf * nets["sdf"][0]) * (feat > 0), "color": dhc * (col > 0),
               "vis": gvis, "feat": g_f16}
    dx = torch.zeros_like(x)
    for name, win in (("base", win_b), ("color", win_c), ("vis", None), ("feat", None)):
        nf = getattr(cfg, _NET_FREQS[name])
        skips = getattr(cfg, _NET_SKIPS[name])
        with torch.enable_grad():
            xl = x.detach().requires_grad_(True)
            X = fourier_embed(xl, cfg.freqs[:nf], win)
        Xd = X.detach()
        dX = torch.zeros_like(Xd)
        gcur = g_start[name]
        wb = nets[name]
        for i in range(len(wb) // 2 - 1, -1, -1):
            hprev = saved((name, i - 1), wb[2 * i - 2].shape[0]) if i > 0 else None
            A = Xd if i == 0 else (torch.cat([Xd, hprev], dim=-1) if i in skips else hprev)
            dn[name][2 * i] = gcur.T @ A
            dn[name][2 * i + 1] = gcur.sum(0)
            din = gcur @ wb[2 * i]
            if i == 0 or i in skips:
                dX = dX + din[:, : Xd.shape[1]]
                din = din[:, Xd.shape[1]:]
            if i > 0:
                gcur = din * (hprev > 0)
        dx = dx + torch.autograd.grad(X, xl, dX)[0]
    return dx, dappr, dn, dibeta.reshape(1)


# ---------------------------------------------------------- launch planning


TILE_ROWS = 64  # NH_TR: points per K1 block
MAX_WIDTH = 128  # NH_NMAX: widest layer output
SLAB_LD = 36  # NH_LDS: row stride of a staged weight slab
MAX_CHUNKS = 128  # K2's split of the points for dW / db
CHUNK_ALIGN = 32  # HM_KS: points per k-slab of K2's dW products


class HeadsPlan(NamedTuple):
    tile_rows: int  # K1: points per block
    smem_bytes: int  # K1's shared memory per block
    grid: int  # K1's blocks
    n_chunks: int  # K2: chunks of the points, one workspace slice each


class HeadsDims(NamedTuple):
    """Widths that size the kernels' buffers (NhArgs in csrc/nerf_heads.cu)."""
    width: int  # output width of base and colour (hc)
    rgb_hidden: int
    max_cx: int  # widest embedding
    g_width: int  # widest layer output


def heads_dims(nets, cfg) -> HeadsDims:
    c_x = {n: 3 * (2 * getattr(cfg, _NET_FREQS[n]) + 1) for n in HEADS}
    outs = [w.shape[0] for n in HEADS for w in nets[n][0::2]]
    width, rgb_hidden = nets["base"][-2].shape[0], nets["rgb1"][0].shape[0]
    return HeadsDims(width=width, rgb_hidden=rgb_hidden, max_cx=max(c_x.values()),
                     g_width=max(rgb_hidden, *outs))


def _ld(n: int) -> int:
    """hm_ld in csrc/heads_mma.cuh: a row stride of 4 mod 8 floats."""
    return (n + 3) // 8 * 8 + 4


def heads_smem(d: HeadsDims) -> int:
    """Shared memory of a K1 block (nh_fwd_smem), bytes: the 64 points'
    embedding and three layer buffers, two stages of hi / lo weight slabs,
    the rgb1 bias row."""
    return 4 * (TILE_ROWS * (_ld(d.max_cx) + 3 * _ld(d.g_width)) + 4 * MAX_WIDTH * SLAB_LD
                + (d.rgb_hidden + 3) // 4 * 4)


def heads_plan(d: HeadsDims, spp: int, rows: int) -> HeadsPlan:
    """K1: one block per 64 points (a divisor of the samples of a pair);
    K2: the most chunks (at most 128) that split the points into whole
    k-slabs, for its dW / db partial sums."""
    if rows % spp:
        raise ValueError(f"{rows} points are not whole pairs of {spp}")
    if spp % TILE_ROWS:
        raise ValueError(f"{spp} samples per pair are not whole tiles of {TILE_ROWS} points")
    if d.g_width > MAX_WIDTH:
        raise ValueError(f"layers wider than {MAX_WIDTH} are not supported")
    smem = heads_smem(d)
    if smem > SMEM_PER_SM:
        raise ValueError(f"K1 needs {smem} bytes of shared memory, more than {SMEM_PER_SM}")
    n_chunks = next(c for c in range(min(MAX_CHUNKS, rows // CHUNK_ALIGN), 0, -1)
                    if rows % c == 0 and (rows // c) % CHUNK_ALIGN == 0)
    return HeadsPlan(TILE_ROWS, smem, rows // TILE_ROWS, n_chunks)


# ------------------------------------------------------------- the library


class _NhHead(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("n_layers", "skip_mask", "n_freqs", "c_x")] + [
        (n, ctypes.c_int * MAX_LAYERS)
        for n in ("in_dim", "out_dim", "k1", "off_w1", "off_w2", "off_b", "act_off", "pk_off")
    ] + [("window", ctypes.c_void_p)] + [
        (n, ctypes.c_void_p * MAX_LAYERS) for n in ("w1", "w2", "b")
    ]


_ARG_INTS = ("rows", "spp", "tr", "n_chunks", "width", "rgb_hidden", "appr_dim", "feat_dim",
             "max_cx", "g_width", "off_w_sdf", "off_b_sdf", "off_w_hc", "off_w_rgb2", "off_b_rgb2",
             "off_dibeta", "n_slice", "act_rgbh", "act_total", "pk_hc", "pk_rgb2", "pk_total")
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
    lib.lab4d_nerf_heads_fwd.argtypes = [vp] * 11
    lib.lab4d_nerf_heads_fwd.restype = i32
    lib.lab4d_nerf_heads_bwd.argtypes = [vp] * 15 + [i32, vp, vp]
    lib.lab4d_nerf_heads_bwd.restype = i32
    lib.lab4d_nerf_heads_bwd_scratch.argtypes = [vp]
    lib.lab4d_nerf_heads_bwd_scratch.restype = ctypes.c_size_t
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
    layer tables, the gradients' workspace offsets and the saved outputs'
    layout."""
    a = _NhArgs()
    windows = {"base": win_b, "color": win_c}
    acts, act_total = act_layout(nets)
    pk, pk_total = pack_layout(nets, cfg)
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
            h.out_dim[i], h.act_off[i], h.pk_off[i] = w1.shape[0], acts[(name, i)], pk[(name, i)]
            if i in skips:
                w2 = snets[name][pos + 1]
                h.w2[i], h.off_w2[i] = w2.data_ptr(), offs[(name, pos + 1)]
                h.in_dim[i] = w1.shape[1] + w2.shape[1]
                pos += 1
            else:
                h.w2[i], h.in_dim[i], h.off_w2[i] = None, w1.shape[1], offs[(name, pos)]
            h.b[i], h.off_b[i] = snets[name][pos + 1].data_ptr(), offs[(name, pos + 1)]
            pos += 2
    ints = dict(rows=x.shape[0], spp=spp, tr=plan.tile_rows, n_chunks=plan.n_chunks,
                width=dims.width, rgb_hidden=dims.rgb_hidden, appr_dim=appr.shape[1],
                feat_dim=nets["feat"][-2].shape[0], max_cx=dims.max_cx, g_width=dims.g_width,
                off_w_sdf=offs[("sdf", 0)], off_b_sdf=offs[("sdf", 1)], off_w_hc=offs[("rgb1", 0)],
                off_w_rgb2=offs[("rgb2", 0)], off_b_rgb2=offs[("rgb2", 1)],
                off_dibeta=offs["dibeta"], n_slice=n_slice, act_rgbh=acts["rgb_h"],
                act_total=act_total, pk_hc=pk["rgb1"], pk_rgb2=pk["rgb2"], pk_total=pk_total)
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


def _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp):
    _check_inputs(x, appr, win_b, win_c, nets, ibeta, cfg, spp)
    ibeta = ibeta.reshape(1).contiguous()
    snets = split_nets(nets, cfg, appr.shape[1])
    dims = heads_dims(nets, cfg)
    plan = heads_plan(dims, spp, x.shape[0])
    offs, n_slice, n_grads = _grad_offsets(snets, dims.rgb_hidden, appr.shape[1])
    args = _build_args(x, appr, win_b, win_c, nets, snets, ibeta, cfg, spp, plan, dims, offs, n_slice)
    # snets and ibeta hold the memory that args points to
    return args, snets, offs, n_slice, n_grads, ibeta


def _launch_fwd(lib, x, appr, win_b, win_c, nets, ibeta, cfg, spp, stream, save=False):
    """Run K1; returns (density, rgb, vis, feat), and the saved layer
    outputs (act_layout) as a last element when save. The CUDA launches
    made are left in `fused_nerf_heads.cuda_launches`."""
    args, _snets, _, _, _, _ibeta = _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp)
    P = x.shape[0]
    outs = [torch.empty((P, c), device=x.device, dtype=x.dtype) for c in OUT_DIMS[:3]]
    outs.append(torch.empty((P, nets["feat"][-2].shape[0]), device=x.device, dtype=x.dtype))
    acts = torch.empty(P * args.act_total, device=x.device, dtype=x.dtype) if save else None
    wpk = torch.empty(args.pk_total, device=x.device, dtype=x.dtype)
    n_launches = ctypes.c_int(0)
    err = lib.lab4d_nerf_heads_fwd(ctypes.addressof(args), x.data_ptr(), appr.data_ptr(),
                                   wpk.data_ptr(), *[o.data_ptr() for o in outs], _ptr(acts),
                                   ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "nerf_heads_fwd")
    fused_nerf_heads.cuda_launches = n_launches.value
    return tuple(outs) + ((acts,) if save else ())


def _launch_bwd(lib, x, g, appr, win_b, win_c, nets, ibeta, cfg, spp, acts, rgb, stream,
                events=None):
    """Run K2 (its sequence of launches) from K1's saved outputs acts and
    rgb; returns (dx, dappr, dnets, dibeta, kinds): kinds lists each CUDA
    launch's kind (csrc/nerf_heads.cu:lab4d_nerf_heads_bwd). events: CUDA
    events (created, as torch.cuda.Event after one record) recorded before
    the first launch and after each launch."""
    P = x.shape[0]
    feat_dim = nets["feat"][-2].shape[0]
    for gi, c in zip(g, OUT_DIMS[:3] + (feat_dim,)):
        if gi.shape != (P, c) or gi.dtype != x.dtype or gi.device != x.device or not gi.is_contiguous():
            raise ValueError(f"each cotangent must be a contiguous ({P}, {c}) float32 tensor")
    args, snets, offs, n_slice, n_grads, _ibeta = _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp)
    if acts.shape != (P * args.act_total,) or rgb.shape != (P, 3) or acts.device != x.device:
        raise ValueError(f"acts must hold {args.act_total} floats per point and rgb be ({P}, 3)")
    dev = x.device
    dx = torch.empty_like(x)
    dappr = torch.empty_like(appr)
    grads = torch.empty(n_grads, device=dev, dtype=x.dtype)
    scratch = torch.empty(lib.lab4d_nerf_heads_bwd_scratch(ctypes.addressof(args)), device=dev,
                          dtype=x.dtype)
    n_ev = 64 if events is None else len(events)
    kinds = (ctypes.c_int * n_ev)()
    handles = None if events is None else (ctypes.c_void_p * n_ev)(*[e.cuda_event for e in events])
    n_launches = ctypes.c_int(0)
    err = lib.lab4d_nerf_heads_bwd(
        ctypes.addressof(args), x.data_ptr(), appr.data_ptr(), acts.data_ptr(), rgb.data_ptr(),
        *[t.data_ptr() for t in g], dx.data_ptr(), grads.data_ptr(), dappr.data_ptr(),
        scratch.data_ptr(), handles, kinds, n_ev, ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "nerf_heads_bwd")
    dsplit = {name: [grads[offs[(name, i)]: offs[(name, i)] + a.numel()].view(a.shape)
                     for i, a in enumerate(arrs)] for name, arrs in snets.items()}
    dibeta = grads[offs["dibeta"]: offs["dibeta"] + 1]
    kinds = list(kinds[: min(n_launches.value, n_ev - 1)])
    return dx, dappr, merge_net_grads(dsplit, nets, cfg), dibeta, kinds


# ------------------------------------------------------------------ K1, K2


def nerf_heads_forward_saved(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp):
    """K1 with its saved layer outputs: ((density, rgb, vis, feat), acts).
    A CUDA tensor runs K1 (counted in `fused_nerf_heads.launches`); a CPU
    tensor nerf_heads_forward_saved_reference."""
    if x.device.type == "cpu":
        return nerf_heads_forward_saved_reference(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp)
    if x.device.type != "cuda":
        raise NotImplementedError(f"nerf_heads_forward_saved has no kernel for device {x.device}")
    *outs, acts = _launch_fwd(_kernel_lib(), x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp,
                              _stream(x.device), save=True)
    fused_nerf_heads.launches += 1
    return tuple(outs), acts


class _FusedNerfHeads(torch.autograd.Function):
    """Forward through K1, saving every layer output when `save` (the
    caller's needs_saved); backward through K2 from them; zeros for the
    windows. On CPU tensors (the tests) both run their plain versions of
    that dataflow."""

    @staticmethod
    def forward(ctx, x, appr, win_b, win_c, ibeta, cfg, spp, order, save, *flat):
        nets = unflatten_nets(flat, order)
        if save:
            outs, acts = nerf_heads_forward_saved(x, appr, win_b, win_c, nets, ibeta, cfg, spp)
        elif x.device.type == "cuda":
            outs, acts = _launch_fwd(_kernel_lib(), x, appr, win_b, win_c, nets, ibeta, cfg, spp,
                                     _stream(x.device)), None
            fused_nerf_heads.launches += 1
        else:
            outs, acts = nerf_heads_reference(x, appr, win_b, win_c, nets, ibeta, cfg, spp), None
        ctx.cfg, ctx.spp, ctx.order = cfg, spp, order
        ctx.save_for_backward(x, appr, win_b, win_c, ibeta, acts, outs[1], *flat)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *g):
        x, appr, win_b, win_c, ibeta, acts, rgb, *flat = ctx.saved_tensors
        if acts is None:
            raise RuntimeError("fused_nerf_heads ran without saving its layer outputs (no input "
                               "required a gradient, or grad mode was off)")
        nets = unflatten_nets(flat, ctx.order)
        dx, dappr, dnets, dibeta = fused_nerf_heads_backward(
            x, [t.contiguous() for t in g], appr, win_b, win_c, nets, ibeta, ctx.cfg, ctx.spp,
            saved=(acts, rgb))
        zeros = [None if w is None else torch.zeros_like(w) for w in (win_b, win_c)]
        return (dx, dappr, *zeros, dibeta.reshape(ibeta.shape), None, None, None, None,
                *flatten_nets(dnets)[0])


def fused_nerf_heads(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp):
    """Every per-point head of the field in one pass.

    Args:
        x: (P, 3) canonical points, P a multiple of spp
        appr_rows: (P / spp, Ca) appearance code of each pair of spp points
        win_b / win_c: (nf_base,) / (nf_color,) annealing windows or None
        nets: {head: [W0, b0, ...]} in the (out, in) layout; ibeta: (1,)
        cfg: FieldCfg; spp: samples per pair, a multiple of 64 on the card
    Returns:
        density (P,1), sigmoid rgb (P,3), visibility logit (P,1),
        normalised feature (P,16)

    A CUDA tensor goes through K1 (one count in `fused_nerf_heads.launches`
    for its CUDA launches, whose number is left in
    `fused_nerf_heads.cuda_launches`), which saves its layer outputs when
    autograd needs a gradient (needs_saved), and its gradient through K2;
    a CPU tensor through nerf_heads_reference.
    """
    if x.device.type == "cuda":
        flat, order = flatten_nets(nets)
        save = needs_saved(x, appr_rows, ibeta, *flat)
        return _FusedNerfHeads.apply(x, appr_rows, win_b, win_c, ibeta, cfg, spp, order, save,
                                     *flat)
    if x.device.type == "cpu":
        return nerf_heads_reference(x, appr_rows, win_b, win_c, nets, ibeta, cfg, spp)
    raise NotImplementedError(f"fused_nerf_heads has no kernel for device {x.device}")


fused_nerf_heads.launches = 0
fused_nerf_heads.cuda_launches = 0


def fused_nerf_heads_backward(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp, saved=None):
    """VJP of fused_nerf_heads for the cotangents g = (g_density, g_rgb,
    g_vis, g_feat): (dx, dappr, dnets, dibeta), dnets in the shapes of nets.
    saved: (acts, rgb) of nerf_heads_forward_saved, which K2 needs.
    A CUDA tensor runs K2 (one count in `fused_nerf_heads_backward.launches`
    for its sequence of CUDA launches, whose number is left in
    `fused_nerf_heads_backward.cuda_launches`); a CPU tensor
    nerf_heads_backward_saved_reference, or nerf_heads_backward_reference
    when saved is None."""
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"fused_nerf_heads_backward has no kernel for device {x.device}")
    if saved is None:
        if x.device.type == "cuda":
            raise ValueError("K2 needs the layer outputs of nerf_heads_forward_saved (saved=)")
        return nerf_heads_backward_reference(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp)
    if x.device.type == "cpu":
        return nerf_heads_backward_saved_reference(x, g, appr_rows, win_b, win_c, nets, ibeta, cfg,
                                                   spp, *saved)
    *out, kinds = _launch_bwd(_kernel_lib(), x, g, appr_rows, win_b, win_c, nets, ibeta, cfg, spp,
                              *saved, _stream(x.device))
    fused_nerf_heads_backward.launches += 1
    fused_nerf_heads_backward.cuda_launches = len(kinds)
    return tuple(out)


fused_nerf_heads_backward.launches = 0
fused_nerf_heads_backward.cuda_launches = 0
