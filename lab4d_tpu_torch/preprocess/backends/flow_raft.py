"""RAFT-lite neural optical flow (port of preprocess/backends/flow_raft.py).

A compact recurrent all-pairs flow net in the spirit of RAFT (Teed &
Deng, ECCV 2020):

  shared feature encoder (1/8 res) + context encoder -> all-pairs
  correlation pyramid (3 levels) -> radius-3 lookup -> 6 conv-GRU
  iterations -> bilinear 8x upsample.

Weights load from the local cache only (``database/weights/
flow_raft.msgpack`` or ``$LAB4D_WEIGHTS_DIR/flow_raft.msgpack``), read
with the port's msgpack reader. When absent or unusable, the flow stage
runs the classical pyramid flow (flow_classical.py). The net takes a
batch of pairs (B, 3, H, W) and returns (B, 2, H, W) flow in pixels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.flow_classical import with_occlusion
from lab4d_tpu_torch.preprocess.backends.layers import Conv, load_net, resize_bilinear, to_nchw

FDIM = 64          # correlation feature width
HDIM = 64          # GRU hidden width
CDIM = 48          # context width
ITERS = 6
LEVELS = 3         # correlation pyramid levels
RADIUS = 3         # lookup radius per level
WEIGHTS_NAME = "flow_raft.msgpack"
RES = 256          # working resolution of the flow stage


# ------------------------------------------------------------------ modules


class Encoder(nn.Module):
    """3-stage stride-2 conv encoder: (B, 3, H, W) -> (B, out, H/8, W/8)."""

    def __init__(self, out: int):
        super().__init__()
        convs, prev = [], 3
        for ch in (32, 48, 64):
            convs += [Conv(prev, ch, 3, stride=2), Conv(ch, ch)]
            prev = ch
        convs.append(Conv(prev, out, 1))
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        self.n_convs = len(convs)

    def forward(self, x):
        for i in range(self.n_convs - 1):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.n_convs - 1}")(x)


class ConvGRU(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.Conv_0 = Conv(HDIM + cin, HDIM)
        self.Conv_1 = Conv(HDIM + cin, HDIM)
        self.Conv_2 = Conv(HDIM + cin, HDIM)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.Conv_0(hx))
        r = torch.sigmoid(self.Conv_1(hx))
        q = torch.tanh(self.Conv_2(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class UpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(LEVELS * (2 * RADIUS + 1) ** 2, 64, 1)
        self.Conv_1 = Conv(64 + 2, 48)
        self.ConvGRU_0 = ConvGRU(48 + CDIM)
        self.Conv_2 = Conv(64, 2)   # flax creates the outer conv first
        self.Conv_3 = Conv(HDIM, 64)

    def forward(self, h, corr, flow, ctx):
        mf = F.relu(self.Conv_0(corr))
        mf = F.relu(self.Conv_1(torch.cat([mf, flow], 1)))
        h = self.ConvGRU_0(h, torch.cat([mf, ctx], 1))
        delta = self.Conv_2(F.relu(self.Conv_3(h)))
        return h, delta


class RAFTLite(nn.Module):
    """Pairs of frames (B, 3, H, W) in [0,1] -> flow (B, 2, H, W) in pixels."""

    def __init__(self, iters: int = ITERS):
        super().__init__()
        self.iters = iters
        self.fnet = Encoder(FDIM)
        self.cnet = Encoder(HDIM + CDIM)
        self.update = UpdateBlock()

    def forward(self, im0, im1):
        b = im0.shape[0]
        f = self.fnet(torch.cat([im0, im1]))  # one encoder, both frames
        f0, f1 = f[:b], f[b:]
        cx = self.cnet(im0)
        h = torch.tanh(cx[:, :HDIM])
        ctx = F.relu(cx[:, HDIM:])

        corr_pyr = _corr_pyramid(f0, f1)
        hh, ww = f0.shape[-2:]
        coords0 = _coords_grid(hh, ww, f0.device)
        flow8 = torch.zeros((b, 2, hh, ww), dtype=torch.float32, device=f0.device)
        for _ in range(self.iters):
            corr = _corr_lookup(corr_pyr, coords0 + flow8.permute(0, 2, 3, 1))
            h, delta = self.update(h, corr, flow8, ctx)
            flow8 = flow8 + delta
        return resize_bilinear(flow8 * 8.0, im0.shape[-2:])


# ------------------------------------------------------- correlation volume


def _coords_grid(h, w, device):
    y, x = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    return torch.stack([x, y], -1).float()


def _corr_pyramid(f0, f1):
    """All-pairs correlation (B * h * w, 1, h, w) and its 2x2 average pools."""
    b, c, h, w = f0.shape
    corr = torch.einsum("bcij,bckl->bijkl", f0, f1) / math.sqrt(c)
    corr = corr.reshape(b * h * w, 1, h, w)
    pyr = [corr]
    for _ in range(LEVELS - 1):
        corr = F.avg_pool2d(corr, 2, 2)
        pyr.append(corr)
    return pyr


def _bilinear_rows(img, x, y):
    """img (N, H, W); x / y (N, K) -> (N, K). The corner indices and the
    weights are clamped as flow_raft.py's _bilinear_nhwc clamps them."""
    n, hgt, wid = img.shape
    x0 = torch.clamp(torch.floor(x), 0, wid - 1)
    y0 = torch.clamp(torch.floor(y), 0, hgt - 1)
    x1 = torch.clamp(x0 + 1, 0, wid - 1)
    y1 = torch.clamp(y0 + 1, 0, hgt - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)
    wy = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(n, hgt * wid)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * wid + xx).long())

    return (
        at(y0, x0) * (1 - wx) * (1 - wy)
        + at(y0, x1) * wx * (1 - wy)
        + at(y1, x0) * (1 - wx) * wy
        + at(y1, x1) * wx * wy
    )


def _corr_lookup(pyr, coords):
    """Sample a (2R+1)^2 window around coords at each pyramid level.

    coords (B, h, w, 2) in level-0 feature pixels -> (B, LEVELS*(2R+1)^2, h, w).
    """
    b, h, w = coords.shape[:3]
    d = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dx, dy = dx.reshape(-1), dy.reshape(-1)
    flat = coords.reshape(b * h * w, 2)
    out = []
    for lvl, corr in enumerate(pyr):
        scale = 0.5 ** lvl
        cx = flat[:, :1] * scale + dx[None]
        cy = flat[:, 1:2] * scale + dy[None]
        out.append(_bilinear_rows(corr[:, 0], cx, cy))
    return torch.cat(out, -1).reshape(b, h, w, -1).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ host API


def weights_path() -> str:
    from lab4d_tpu_torch.preprocess.backends.weights import resolve_weights

    return resolve_weights(WEIGHTS_NAME)


def load_model(path: Optional[str] = None, device="cpu") -> Optional[RAFTLite]:
    """The net with the cached weights on `device`, or None when absent/corrupt."""
    return load_net(RAFTLite, path or weights_path(), "flow_raft", "classical fallback",
                    device)


def available() -> bool:
    return load_model() is not None


def compute_flows(imgs0: Sequence[np.ndarray], imgs1: Sequence[np.ndarray], res: int = RES,
                  model: Optional[RAFTLite] = None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 RGB frames, pair by pair -> (fw, bw) float32 (B, res, res, 3)
    [u, v, occ], as flow_classical.compute_flows; both directions of every
    pair go through the net in one batch."""
    import cv2

    dev = resolve_device(device)
    model = model if model is not None else load_model(device=dev)
    if model is None:
        raise FileNotFoundError(f"flow_raft weights missing or unusable: {weights_path()}")
    i0 = to_nchw(np.stack([cv2.resize(f, (res, res)) for f in imgs0]) / np.float32(255.0), dev)
    i1 = to_nchw(np.stack([cv2.resize(f, (res, res)) for f in imgs1]) / np.float32(255.0), dev)
    b = i0.shape[0]
    with torch.no_grad():
        flow = model(torch.cat([i0, i1]), torch.cat([i1, i0])).permute(0, 2, 3, 1)
        fw, bw = with_occlusion(flow[:b], flow[b:], float(res))
    return fw.cpu().numpy(), bw.cpu().numpy()

