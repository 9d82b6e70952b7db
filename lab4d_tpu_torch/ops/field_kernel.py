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
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lab4d_tpu_torch.nnutils.embedding import fourier_embed
from lab4d_tpu_torch.ops.mlp_kernel import (SMEM_PER_SM, _n_sm, _raise_on, _stream, _vjp,
                                            mlp_reference, needs_saved)

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


TILE_ROWS = 64  # NH_HALF: a warpgroup's points of the engine's tile; a pair's samples are whole multiples
ENGINE_ROWS = 128  # NH_TR: points per tile of K1 / K2's engine
MAX_WIDTH = 128  # NH_NMAX: widest layer output
SLAB_K = 16  # NH_KS: k-depth of a weight slab
SLOT_FLOATS = 32 * MAX_WIDTH  # NH_SLAB: a ring slot, the widest slab's hi and lo
G_ROWS = 32  # NH_RS: rows of a G slab of K2's dW
DW_M = 128  # NH_DW_M: dW inputs per block
DW_SMEM = 4 * (32 + 3 * (64 * MAX_WIDTH + 2 * 8 * (4 * MAX_WIDTH + 8)))  # NH_DW_SMEM: 3 slots of G and A
MAX_PASSES, MAX_DW = 68, 36  # NH_MAX_PASSES, NH_MAX_DW
MAX_CHUNKS = 512  # K2's split of the points for dW / db
WGMMA_WIDTHS = (8, 16, 32, 64, 128)  # the wgmma widths the engine instantiates
EPI = ("hid", "base", "col", "rgb1", "rgb2", "vis", "feat", "dhc", "dx", "dh")  # NH_E_*, in order
A_KINDS = ("x", "xh", "h", "hc")  # NH_A_*: dW's A operand


def _cdiv(a, b):
    return -(-a // b)


def _r16(n):
    return _cdiv(n, SLAB_K) * SLAB_K


def wgmma_width(n: int) -> int:
    """The narrowest wgmma of the engine that holds n columns."""
    return next(w for w in WGMMA_WIDTHS if w >= n)


class HeadShape(NamedTuple):
    n_layers: int
    skips: tuple
    n_freqs: int
    c_x: int  # embedding columns, 3 (2 n_freqs + 1)
    in_dims: tuple
    out_dims: tuple

    def has_x(self, layer):
        return layer == 0 or layer in self.skips


class HeadsShapes(NamedTuple):
    """The widths K1 / K2's passes and dW layers follow (hashable)."""
    heads: tuple  # HeadShape of base, colour, visibility, feature
    width: int  # output width of base and colour (hc)
    rgb_hidden: int
    feat_dim: int


def heads_shapes(nets, cfg) -> HeadsShapes:
    heads = []
    for name in HEADS:
        ws = nets[name][0::2]
        nf = getattr(cfg, _NET_FREQS[name])
        skips = tuple(i for i in getattr(cfg, _NET_SKIPS[name]) if i < len(ws))
        heads.append(HeadShape(len(ws), skips, nf, 3 * (2 * nf + 1), tuple(w.shape[1] for w in ws),
                               tuple(w.shape[0] for w in ws)))
    return HeadsShapes(tuple(heads), nets["base"][-2].shape[0], nets["rgb1"][0].shape[0],
                       nets["feat"][-2].shape[0])


class HeadPass(NamedTuple):
    """One pass of the engine (NhPass in csrc/nerf_heads.cu): a wgmma of nw
    columns (n real) over nsl slabs of SLAB_K of the reduction, its slabs
    at img floats in the packed weights."""
    img: int
    nsl: int
    n: int
    nxs: int  # K1: the first nxs slabs read the tile's Fourier ladder, the rest the A buffer
    nw: int
    epi: int  # what it computes: EPI
    head: int  # its head's index in HEADS, -1 for rgb1, rgb2 and K2's d hc
    layer: int
    src: int  # the A buffer: 0 H, 1 F (hc; K2: the colour head's last G)
    dw: int  # K2: the dW layer whose G it reads first, or -1
    first: int  # K2: the first pass of a head


@functools.lru_cache(maxsize=None)
def heads_passes(s: HeadsShapes, bwd: bool):
    """K1's passes (bwd False) or K2's, in the engine's order, and the
    floats of their packed weights. K1: every layer of base and colour,
    rgb1 (over hc in F), rgb2, visibility, feature; a layer with x reads the
    ladder's first round16(c_x) columns, then its h. K2: d hc = d rgb_h .
    W_hc, then each head from its last layer to its first: a layer's x
    columns (into dX) before its h columns (into the previous layer's G)."""
    out, img = [], 0

    def add(nsl, n, epi, head=-1, layer=0, nxs=0, src=0, dw=-1, first=0):
        nonlocal img
        nw = wgmma_width(n)
        out.append(HeadPass(img, nsl, n, nxs, nw, EPI.index(epi), head, layer, src, dw, first))
        img += nsl * 32 * nw

    if not bwd:
        last = ("base", "col", "vis", "feat")
        for hi, h in enumerate(s.heads):
            for l in range(h.n_layers):
                nxs = _r16(h.c_x) // SLAB_K if h.has_x(l) else 0
                kh = h.in_dims[l] - (h.c_x if h.has_x(l) else 0)
                add(nxs + _cdiv(kh, SLAB_K), h.out_dims[l],
                    last[hi] if l == h.n_layers - 1 else "hid", hi, l, nxs)
            if hi == 1:
                add(_cdiv(s.width, SLAB_K), s.rgb_hidden, "rgb1", src=1)
                add(_cdiv(s.rgb_hidden, SLAB_K), OUT_DIMS[1], "rgb2")
    else:
        add(_cdiv(s.rgb_hidden, SLAB_K), s.width, "dhc")
        dw = 3  # heads_dw: sdf, rgb2, rgb1, then the heads' layers
        for hi, h in enumerate(s.heads):
            for l in range(h.n_layers - 1, -1, -1):
                src = int(hi == 1 and l == h.n_layers - 1)
                nsl = _cdiv(h.out_dims[l], SLAB_K)
                lead = dict(dw=dw + l, first=int(l == h.n_layers - 1))
                if h.has_x(l):
                    add(nsl, h.c_x, "dx", hi, l, src=src, **lead)
                    lead = {}
                if l > 0:
                    add(nsl, h.in_dims[l] - (h.c_x if h.has_x(l) else 0), "dh", hi, l, src=src, **lead)
            dw += h.n_layers
    if len(out) > MAX_PASSES:
        raise ValueError(f"the heads take {len(out)} passes, more than {MAX_PASSES}")
    return tuple(out), img


class DwLayer(NamedTuple):
    """One layer of K2's dW (NhDw): dW = G^T A over K inputs and N outputs,
    G's fp32 slabs (32 rows x nwo) at goff floats in each 32-row group of
    the G image."""
    goff: int
    blk0: int  # its first dW block of a chunk
    K: int
    N: int
    nwo: int
    kind: int  # A: A_KINDS
    head: int  # its head, or -1 sdf, -2 rgb2, -3 rgb1's W_hc
    layer: int


@functools.lru_cache(maxsize=None)
def heads_dw(s: HeadsShapes):
    """K2's dW layers (sdf, rgb2, rgb1's W_hc, then every head layer in
    order), the floats of one 32-row group of the G image, and dW's blocks
    per chunk of rows (DW_M inputs each)."""
    out, goff, blk = [], 0, 0

    def add(K, N, kind, head, layer=0):
        nonlocal goff, blk
        nwo = wgmma_width(N)
        out.append(DwLayer(goff, blk, K, N, nwo, A_KINDS.index(kind), head, layer))
        goff += 32 * nwo
        blk += _cdiv(K, DW_M)

    add(s.width, 1, "h", -1)
    add(s.rgb_hidden, OUT_DIMS[1], "h", -2)
    add(s.width, s.rgb_hidden, "hc", -3)
    for hi, h in enumerate(s.heads):
        for l in range(h.n_layers):
            add(h.in_dims[l], h.out_dims[l], "x" if l == 0 else "xh" if l in h.skips else "h", hi, l)
    if len(out) > MAX_DW:
        raise ValueError(f"the heads take {len(out)} dW layers, more than {MAX_DW}")
    return tuple(out), goff, blk


class HeadsPlan(NamedTuple):
    tile_rows: int  # points per tile of the engine
    smem_bytes: int  # the engine's shared memory per block (K1 and K2's dIn)
    grid: int  # the engine's blocks: one per SM, at most one per tile
    stages: int  # weight slabs in flight
    ldx: int  # shared-memory row stride of the ladder (K2: dX)
    ldh: int  # and of H and F
    n_chunks: int  # K2's dW: chunks of the points, one workspace slice each
    chunk_rows: int


class HeadsDims(NamedTuple):
    """Widths that size the kernels' buffers and dW's grid."""
    width: int  # output width of base and colour (hc)
    rgb_hidden: int
    max_cx: int  # widest embedding
    g_width: int  # widest layer output
    dw_blocks: int  # K2's dW blocks per chunk of rows
    row_align: int  # gcd of the saved widths dW's A reads (hidden layers, width, rgb_hidden)


def heads_dims(nets, cfg) -> HeadsDims:
    s = heads_shapes(nets, cfg)
    outs = [o for h in s.heads for o in h.out_dims]
    hidden = [o for h in s.heads for o in h.out_dims[:-1]]
    return HeadsDims(width=s.width, rgb_hidden=s.rgb_hidden, max_cx=max(h.c_x for h in s.heads),
                     g_width=max(s.rgb_hidden, *outs), dw_blocks=heads_dw(s)[2],
                     row_align=math.gcd(s.width, s.rgb_hidden, *hidden))


def _ld(n: int) -> int:
    """hm_ld in csrc/heads_mma.cuh: a row stride of 4 mod 8 floats."""
    return (n + 3) // 8 * 8 + 4


def heads_smem(ldx: int, ldh: int, stages: int) -> int:
    """Shared memory of an engine block (nh_engine_smem), bytes: the ring's
    barriers and slots, the tile's ladder, H and F, K2's per-row terms."""
    return 4 * (32 + stages * SLOT_FLOATS + ENGINE_ROWS * (ldx + 2 * ldh) + 2 * ENGINE_ROWS)


def heads_plan(d: HeadsDims, spp: int, rows: int, n_sm: int = 132) -> HeadsPlan:
    """The engine: tiles of 128 points (two halves of 64, each within a
    pair), one persistent block per SM, 3 weight slabs in flight where
    they fit; K2's dW: chunks of whole G slabs, about eight waves of its
    blocks over n_sm SMs, at most MAX_CHUNKS."""
    if rows % spp:
        raise ValueError(f"{rows} points are not whole pairs of {spp}")
    if spp % TILE_ROWS:
        raise ValueError(f"{spp} samples per pair are not whole tiles of {TILE_ROWS} points")
    if d.g_width > MAX_WIDTH:
        raise ValueError(f"layers wider than {MAX_WIDTH} are not supported")
    if d.row_align % 4:
        raise ValueError("K2's dW copies saved rows of 16 bytes: hidden widths, the heads' width "
                         "and rgb1's must be multiples of 4")
    ldx, ldh = _ld(_r16(d.max_cx)), _ld(_r16(d.g_width))
    stages = 3 if heads_smem(ldx, ldh, 3) <= SMEM_PER_SM else 2
    smem = heads_smem(ldx, ldh, stages)
    if smem > SMEM_PER_SM:
        raise ValueError(f"K1 needs {smem} bytes of shared memory, more than {SMEM_PER_SM}")
    n = max(1, min(_cdiv(rows, G_ROWS), _cdiv(8 * n_sm, d.dw_blocks), MAX_CHUNKS))
    chunk = _cdiv(_cdiv(rows, n), G_ROWS) * G_ROWS
    return HeadsPlan(ENGINE_ROWS, smem, min(_cdiv(rows, ENGINE_ROWS), n_sm), stages, ldx, ldh,
                     _cdiv(rows, chunk), chunk)


def ladder_order(n_freqs: int):
    """The embedding column [x, sin (F x 3), cos (F x 3)] at each position
    of the shared ladder [x | sin, cos of frequency 0 | ...], and each
    position's frequency (-1 for x)."""
    cols, freq = [0, 1, 2], [-1, -1, -1]
    for f in range(n_freqs):
        cols += [3 + 3 * f + c for c in range(3)] + [3 + 3 * n_freqs + 3 * f + c for c in range(3)]
        freq += [f] * 6
    return cols, freq


def _layer_arrays(snets, name, skips, layer):
    """(w1, w2 or None, b) of a layer in split_nets' layout."""
    pos = 0
    for i in range(layer):
        pos += 3 if i in skips else 2
    arrs = snets[name]
    return (arrs[pos], arrs[pos + 1], arrs[pos + 2]) if layer in skips else (arrs[pos], None, arrs[pos + 1])


def _pass_matrix(p, s, snets, windows):
    """B of a pass, (nsl * SLAB_K, nw): the forward's B[k, n] = W[n, k] over
    [ladder, padded to SLAB_K nxs | h], K2's W[k, n] (d hc: W_hc; a layer's
    x columns in ladder order, or its h columns); the embedding's columns
    times the head's window; zero elsewhere (nh_pack_value)."""
    B = torch.zeros(p.nsl * SLAB_K, p.nw, dtype=torch.float32)
    epi, W, RH = EPI[p.epi], s.width, s.rgb_hidden
    w_hc = snets["rgb1"][0]
    if epi == "rgb1":
        B[:W, :RH] = w_hc.T
    elif epi == "rgb2":
        B[:RH, :OUT_DIMS[1]] = snets["rgb2"][0].T
    elif epi == "dhc":
        B[:RH, :W] = w_hc
    else:
        name, h, l = HEADS[p.head], s.heads[p.head], p.layer
        w1, w2, _ = _layer_arrays(snets, name, h.skips, l)
        N, cx = h.out_dims[l], h.c_x if h.has_x(l) else 0
        wh = w2 if w2 is not None else (None if cx else w1)
        if cx:
            cols, freq = ladder_order(h.n_freqs)
            win = windows.get(name)
            scale = torch.ones(cx) if win is None else torch.cat(
                [torch.ones(3), win.detach().cpu().float().repeat_interleave(6)])
            wl = w1.detach().cpu().float()[:, cols] * scale
        if epi == "dx":
            B[:N, :cx] = wl
        elif epi == "dh":
            B[:N, : wh.shape[1]] = wh.detach().cpu().float()
        else:
            if cx:
                B[:cx, :N] = wl.T
            if wh is not None:
                k0 = SLAB_K * p.nxs
                B[k0: k0 + wh.shape[1], :N] = wh.detach().cpu().float().T
    return B


def _tf32_cut(t):
    """fp32 cut to TF32 (its low 13 mantissa bits cleared): rw_split's hi."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def pack_reference(nets, cfg, appr_dim, win_b=None, win_c=None, bwd=False):
    """Plain version of nh_pack_kernel's weights (on the CPU): every pass's
    B split into hi (cut to TF32) and lo (the rest), each 16-deep slab hi
    then lo, [k / 4][n / 8][n % 8][k % 4]."""
    s = heads_shapes(nets, cfg)
    snets = split_nets(nets, cfg, appr_dim)
    windows = {"base": win_b, "color": win_c}
    out = []
    for p in heads_passes(s, bwd)[0]:
        B = _pass_matrix(p, s, snets, windows)
        hi = _tf32_cut(B)
        for sl in range(p.nsl):
            for half in (hi, B - hi):
                blk = half[SLAB_K * sl: SLAB_K * (sl + 1)]
                out.append(blk.reshape(4, 4, p.nw // 8, 8).permute(0, 2, 3, 1).reshape(-1))
    return torch.cat(out)


# ------------------------------------------------------------- the library


class _NhHead(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("n_layers", "skip_mask", "n_freqs", "c_x")] + [
        (n, ctypes.c_int * MAX_LAYERS)
        for n in ("in_dim", "out_dim", "off_w1", "off_w2", "off_b", "act_off")
    ] + [("window", ctypes.c_void_p)] + [
        (n, ctypes.c_void_p * MAX_LAYERS) for n in ("w1", "w2", "b")
    ]


class _NhPass(ctypes.Structure):
    _fields_ = [("img", ctypes.c_int), ("nsl", ctypes.c_short), ("n", ctypes.c_short),
                ("nxs", ctypes.c_ubyte), ("nw", ctypes.c_ubyte)] + [
        (n, ctypes.c_byte) for n in ("epi", "head", "layer", "src", "dw", "first")]


class _NhDw(ctypes.Structure):
    _fields_ = [("goff", ctypes.c_int), ("blk0", ctypes.c_int)] + [
        (n, ctypes.c_short) for n in ("K", "N", "nwo")] + [
        (n, ctypes.c_byte) for n in ("kind", "head", "layer")]


_ARG_INTS = ("n_pass", "n_dw", "rows", "spp", "n_tiles", "n_chunks", "pc", "dw_blocks", "width",
             "rgb_hidden", "appr_dim", "feat_dim", "n_freqs", "img_total", "stages", "ldx", "ldh",
             "ldl", "gstride", "off_w_sdf", "off_b_sdf", "off_w_hc", "off_w_rgb2", "off_b_rgb2",
             "off_dibeta", "n_slice", "act_rgbh", "act_total", "dw_sdf", "dw_rgb2", "dw_rgb1")
_ARG_PTRS = ("w_sdf", "b_sdf", "w_hc", "w_appr", "b_rgb1", "w_rgb2", "b_rgb2", "ibeta")


class _NhArgs(ctypes.Structure):
    _fields_ = [("head", _NhHead * len(HEADS)), ("pass_", _NhPass * MAX_PASSES),
                ("dw", _NhDw * MAX_DW)] + [(n, ctypes.c_int) for n in _ARG_INTS] + [
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
    lib.lab4d_nerf_heads_layout.argtypes = [vp, i32, vp]
    lib.lab4d_nerf_heads_layout.restype = i32
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
    dW_appr and db_rgb1, which the last launch writes."""
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


def _build_args(x, appr, win_b, win_c, nets, snets, ibeta, cfg, spp, plan, shapes, offs, n_slice, bwd):
    """The NhArgs of a launch: every pointer of the split nets, the heads'
    layer tables, K1's or K2's passes (bwd), K2's dW layers, the gradients'
    workspace offsets and the saved outputs' layout."""
    a = _NhArgs()
    windows = {"base": win_b, "color": win_c}
    acts, act_total = act_layout(nets)
    for hi, name in enumerate(HEADS):
        h, hs = a.head[hi], shapes.heads[hi]
        h.n_layers, h.n_freqs, h.c_x = hs.n_layers, hs.n_freqs, hs.c_x
        h.skip_mask = sum(1 << i for i in hs.skips)
        h.window = _ptr(windows.get(name))
        pos = 0
        for i in range(hs.n_layers):
            w1 = snets[name][pos]
            h.w1[i], h.off_w1[i] = w1.data_ptr(), offs[(name, pos)]
            h.in_dim[i], h.out_dim[i], h.act_off[i] = hs.in_dims[i], hs.out_dims[i], acts[(name, i)]
            if i in hs.skips:
                h.w2[i], h.off_w2[i] = snets[name][pos + 1].data_ptr(), offs[(name, pos + 1)]
                pos += 1
            else:
                h.w2[i], h.off_w2[i] = None, offs[(name, pos)]
            h.b[i], h.off_b[i] = snets[name][pos + 1].data_ptr(), offs[(name, pos + 1)]
            pos += 2
    passes, img_total = heads_passes(shapes, bwd)
    for i, p in enumerate(passes):
        for k, v in p._asdict().items():
            setattr(a.pass_[i], k, v)
    dws, gstride, dw_blocks = heads_dw(shapes)
    for i, d in enumerate(dws):
        for k, v in d._asdict().items():
            setattr(a.dw[i], k, v)
    ints = dict(n_pass=len(passes), n_dw=len(dws), rows=x.shape[0], spp=spp,
                n_tiles=_cdiv(x.shape[0], ENGINE_ROWS), n_chunks=plan.n_chunks, pc=plan.chunk_rows,
                dw_blocks=dw_blocks, width=shapes.width, rgb_hidden=shapes.rgb_hidden,
                appr_dim=appr.shape[1], feat_dim=shapes.feat_dim,
                n_freqs=max(h.n_freqs for h in shapes.heads), img_total=img_total,
                stages=plan.stages, ldx=plan.ldx, ldh=plan.ldh,
                ldl=_cdiv(3 + 6 * max(h.n_freqs for h in shapes.heads), 4) * 4, gstride=gstride,
                off_w_sdf=offs[("sdf", 0)], off_b_sdf=offs[("sdf", 1)], off_w_hc=offs[("rgb1", 0)],
                off_w_rgb2=offs[("rgb2", 0)], off_b_rgb2=offs[("rgb2", 1)],
                off_dibeta=offs["dibeta"], n_slice=n_slice, act_rgbh=acts["rgb_h"],
                act_total=act_total, dw_sdf=0, dw_rgb2=1, dw_rgb1=2)
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


def _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp, bwd):
    _check_inputs(x, appr, win_b, win_c, nets, ibeta, cfg, spp)
    ibeta = ibeta.reshape(1).contiguous()
    snets = split_nets(nets, cfg, appr.shape[1])
    shapes = heads_shapes(nets, cfg)
    plan = heads_plan(heads_dims(nets, cfg), spp, x.shape[0], _n_sm(x.device))
    offs, n_slice, n_grads = _grad_offsets(snets, shapes.rgb_hidden, appr.shape[1])
    args = _build_args(x, appr, win_b, win_c, nets, snets, ibeta, cfg, spp, plan, shapes, offs,
                       n_slice, bwd)
    # snets and ibeta hold the memory that args points to
    return args, snets, offs, n_slice, n_grads, ibeta


def heads_layout(lib, args, bwd):
    """The library's layout of a launch (lab4d_nerf_heads_layout): the
    engine's shared memory per block and its blocks, dW's shared memory,
    K2's scratch floats, sizeof(NhArgs); raises where the library refuses
    the shapes."""
    sizes = (ctypes.c_longlong * 5)()
    _raise_on(lib, lib.lab4d_nerf_heads_layout(ctypes.addressof(args), int(bwd), sizes),
              "nerf_heads_layout")
    return list(sizes)


def _launch_fwd(lib, x, appr, win_b, win_c, nets, ibeta, cfg, spp, stream, save=False, wpk=None):
    """Run K1; returns (density, rgb, vis, feat), and the saved layer
    outputs (act_layout) as a last element when save. The CUDA launches
    made are left in `fused_nerf_heads.cuda_launches`. wpk: scratch for the
    split weights and rgb1's bias rows (img_total + pairs x rgb_hidden
    floats), or None."""
    args, _snets, _, _, _, _ibeta = _prepare(x, appr, win_b, win_c, nets, ibeta, cfg, spp, False)
    P = x.shape[0]
    outs = [torch.empty((P, c), device=x.device, dtype=x.dtype) for c in OUT_DIMS[:3]]
    outs.append(torch.empty((P, nets["feat"][-2].shape[0]), device=x.device, dtype=x.dtype))
    acts = torch.empty(P * args.act_total, device=x.device, dtype=x.dtype) if save else None
    if wpk is None:
        wpk = torch.empty(args.img_total + (P // spp) * args.rgb_hidden, device=x.device, dtype=x.dtype)
    n_launches = ctypes.c_int(0)
    err = lib.lab4d_nerf_heads_fwd(ctypes.addressof(args), x.data_ptr(), appr.data_ptr(),
                                   wpk.data_ptr(), *[o.data_ptr() for o in outs], _ptr(acts),
                                   ctypes.byref(n_launches), stream)
    _raise_on(lib, err, "nerf_heads_fwd")
    fused_nerf_heads.cuda_launches = n_launches.value
    return tuple(outs) + ((acts,) if save else ())


def _launch_bwd(lib, x, g, appr, win_b, win_c, nets, ibeta, cfg, spp, acts, rgb, stream,
                events=None):
    """Run K2 (its launches) from K1's saved outputs acts and rgb; returns
    (dx, dappr, dnets, dibeta, kinds): kinds lists each CUDA launch's kind
    (csrc/nerf_heads.cu:lab4d_nerf_heads_bwd). events: CUDA events
    (created, as torch.cuda.Event after one record) recorded before the
    first launch and after each launch."""
    P = x.shape[0]
    feat_dim = nets["feat"][-2].shape[0]
    for gi, c in zip(g, OUT_DIMS[:3] + (feat_dim,)):
        if gi.shape != (P, c) or gi.dtype != x.dtype or gi.device != x.device or not gi.is_contiguous():
            raise ValueError(f"each cotangent must be a contiguous ({P}, {c}) float32 tensor")
    args, snets, offs, n_slice, n_grads, _ibeta = _prepare(x, appr, win_b, win_c, nets, ibeta, cfg,
                                                           spp, True)
    if acts.shape != (P * args.act_total,) or rgb.shape != (P, 3) or acts.device != x.device:
        raise ValueError(f"acts must hold {args.act_total} floats per point and rgb be ({P}, 3)")
    dev = x.device
    dx = torch.empty_like(x)
    dappr = torch.empty_like(appr)
    grads = torch.empty(n_grads, device=dev, dtype=x.dtype)
    scratch = torch.empty(lib.lab4d_nerf_heads_bwd_scratch(ctypes.addressof(args)), device=dev,
                          dtype=x.dtype)
    n_ev = 8 if events is None else len(events)
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
