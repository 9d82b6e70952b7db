"""Dense optical flow without weights: coarse-to-fine pyramidal
Lucas-Kanade with Gaussian-aggregated structure tensors and flow-field
smoothing (port of preprocess/backends/flow_jax.py; LAB4D_FLOW_BACKEND
"classical"). The frame filter always uses it, the RAFT-lite backend uses
its `_warp` for the occlusion channel, and it is the flow backend when
the RAFT weights do not load.

Images are resized to a fixed working resolution, the pyramid depth and
the per-level iteration counts are constants. Every function takes a
batch of pairs: (B, H, W) grayscale images, (B, H, W, 2) flows.
Occlusion is scored by forward-backward cycle error and stored in the
third channel: occ > 0 means occluded.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.layers import resize_bilinear

# working resolution (flow npys are stored at this res; loaders rescale)
DEFAULT_RES = 288  # multiple of 32; ~300^2 like the reference's filter res
NUM_LEVELS = 5
ITERS_PER_LEVEL = 4
WINDOW_SIGMA = 2.5
SMOOTH_SIGMA = 1.5
LAMBDA = 1e-3  # Tikhonov floor for the 2x2 LK solve
OCC_THRESH = 0.05  # cycle error threshold, fraction of image size


@functools.lru_cache(maxsize=32)
def _gauss_kernel1d(sigma: float, device: torch.device) -> torch.Tensor:
    r = max(1, int(3 * sigma))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur on (..., H, W): edge padding, then a 'valid'
    convolution along W, then along H."""
    k = _gauss_kernel1d(sigma, img.device)
    pad = (k.shape[0] - 1) // 2
    shape = img.shape
    x = img.reshape(-1, 1, shape[-2], shape[-1])
    x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="replicate"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="replicate"), k.view(1, 1, -1, 1))
    return x.reshape(shape)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    return _blur(img, 1.0)[..., ::2, ::2]


def _grad(img: torch.Tensor):
    """Central differences on (..., H, W), wrapping around at the borders."""
    gx = (torch.roll(img, -1, -1) - torch.roll(img, 1, -1)) * 0.5
    gy = (torch.roll(img, -1, -2) - torch.roll(img, 1, -2)) * 0.5
    return gx, gy


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W) images at float coords x, y (B, ...); clamped borders."""
    b, h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(b, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).reshape(b, -1)).reshape(x.shape)

    return (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x0 + 1) * fx * (1 - fy)
        + at(y0 + 1, x0) * (1 - fx) * fy
        + at(y0 + 1, x0 + 1) * fx * fy
    )


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) sampled at (x + u, y + v) of flow (B, H, W, 2)."""
    h, w = img.shape[-2:]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    return _bilinear(img, xx + flow[..., 0], yy + flow[..., 1])


def _lk_refine(i0: torch.Tensor, i1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """One windowed-LK update of flow (B, H, W, 2) at a single pyramid level."""
    i1w = _warp(i1, flow)
    gx, gy = _grad(i1w)
    it = i1w - i0
    # Gaussian-aggregated normal equations
    a11 = _blur(gx * gx, WINDOW_SIGMA) + LAMBDA
    a12 = _blur(gx * gy, WINDOW_SIGMA)
    a22 = _blur(gy * gy, WINDOW_SIGMA) + LAMBDA
    b1 = _blur(gx * it, WINDOW_SIGMA)
    b2 = _blur(gy * it, WINDOW_SIGMA)
    det = a11 * a22 - a12 * a12
    du = (-a22 * b1 + a12 * b2) / det
    dv = (a12 * b1 - a11 * b2) / det
    # clamp per-iteration update to keep the linearization honest
    du = torch.clamp(du, -2.0, 2.0)
    dv = torch.clamp(dv, -2.0, 2.0)
    flow = flow + torch.stack([du, dv], -1)
    # smooth the field (diffusion regularizer)
    return torch.stack(
        [_blur(flow[..., 0], SMOOTH_SIGMA), _blur(flow[..., 1], SMOOTH_SIGMA)], -1
    )


def _upsample_flow(flow: torch.Tensor, shape) -> torch.Tensor:
    h, w = shape
    scale = torch.tensor([w / flow.shape[2], h / flow.shape[1]], dtype=torch.float32,
                         device=flow.device)
    up = resize_bilinear(flow.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
    return up * scale


def flow_pyramid(i0: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
    """Dense flow i0 -> i1; both (B, H, W) grayscale in [0, 1]."""
    pyr0, pyr1 = [i0], [i1]
    for _ in range(NUM_LEVELS - 1):
        pyr0.append(_downsample2(pyr0[-1]))
        pyr1.append(_downsample2(pyr1[-1]))
    flow = torch.zeros(pyr0[-1].shape + (2,), dtype=torch.float32, device=i0.device)
    for lvl in range(NUM_LEVELS - 1, -1, -1):
        if lvl != NUM_LEVELS - 1:
            flow = _upsample_flow(flow, pyr0[lvl].shape[-2:])
        for _ in range(ITERS_PER_LEVEL):
            flow = _lk_refine(pyr0[lvl], pyr1[lvl], flow)
    return flow


def cycle_occlusion(f: torch.Tensor, g: torch.Tensor, size: float) -> torch.Tensor:
    """|f(p) + g(p + f(p))| / size - OCC_THRESH: the cycle error of
    following f then g; > 0 means occluded. f, g (B, H, W, 2)."""
    gx = _warp(g[..., 0], f)
    gy = _warp(g[..., 1], f)
    err = torch.linalg.vector_norm(f + torch.stack([gx, gy], -1), dim=-1)
    return err / size - OCC_THRESH


def with_occlusion(fw: torch.Tensor, bw: torch.Tensor, size: float):
    """(fw, bw) (B, H, W, 2) -> each (B, H, W, 3) [u, v, occ]."""
    fw3 = torch.cat([fw, cycle_occlusion(fw, bw, size)[..., None]], -1)
    bw3 = torch.cat([bw, cycle_occlusion(bw, fw, size)[..., None]], -1)
    return fw3, bw3


def flow_pair_with_occ(i0: torch.Tensor, i1: torch.Tensor):
    """Forward + backward flow with the cycle occlusion channel, one
    pyramid over both directions. Returns (fw, bw), each (B, H, W, 3)."""
    b = i0.shape[0]
    both = flow_pyramid(torch.cat([i0, i1]), torch.cat([i1, i0]))
    return with_occlusion(both[:b], both[b:], float(max(i0.shape[-2:])))


def to_gray(img_u8: np.ndarray, res: int = DEFAULT_RES) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> float32 grayscale at the working resolution."""
    import cv2

    g = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY).astype(np.float32) / 255.0
    return cv2.resize(g, (res, res), interpolation=cv2.INTER_AREA)


def compute_flows(imgs0: Sequence[np.ndarray], imgs1: Sequence[np.ndarray],
                  res: int = DEFAULT_RES, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 RGB frames, pair by pair -> (fw, bw) float32 (B, res, res, 3),
    flow vectors in working-resolution pixels (loaders rescale)."""
    dev = resolve_device(device)
    g0 = torch.from_numpy(np.stack([to_gray(f, res) for f in imgs0])).to(dev)
    g1 = torch.from_numpy(np.stack([to_gray(f, res) for f in imgs1])).to(dev)
    with torch.no_grad():
        fw, bw = flow_pair_with_occ(g0, g1)
    return fw.cpu().numpy(), bw.cpu().numpy()


def compute_pair_flow(img0_u8: np.ndarray, img1_u8: np.ndarray, res: int = DEFAULT_RES,
                      device=None) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 RGB pair -> (fw, bw) float32 (res, res, 3) [u, v, occ]."""
    fw, bw = compute_flows([img0_u8], [img1_u8], res, device)
    return fw[0], bw[0]

