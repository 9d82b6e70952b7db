"""Pixel-feature backends: 16-dim L2-normalised descriptor maps at
112x112 per frame, masked to the object, with one PCA basis fit over the
masked pixels of every video of a collection (port of
preprocess/backends/feat_backends.py).

Backends:
  dinov2     — torch.hub's dinov2_vits14 patch tokens (384-dim, 16x16 at
               224^2, bilinearly resized to 112^2), chosen only when the
               hub cache already holds its repo (nothing is downloaded)
  net        — the trained dense-descriptor U-Net (feat_net.py) when
               database/weights/feat_net.msgpack exists: 24-dim maps
               through the collection PCA
  filterbank — fallback: a multi-scale oriented filter bank (Gaussian
               colour pyramid + even/odd steerable responses) on the
               device, through the same PCA. Deterministic, no weights.

The PCA is the port's own (no scikit-learn on the card): the fit of
sklearn.decomposition.PCA(n_components=16) in the scikit-learn 1.9.0 the
JAX package's tests run with, its centring, its "covariance_eigh" solver
for tall inputs (n_samples >= 10 * n_features) else the full SVD, and its
component signs (svd_flip on the rows of Vt: each row's largest-magnitude
entry positive). The projection runs on the device.
"""

from __future__ import annotations

import functools
import os
from typing import List

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.flow_classical import _gauss_kernel1d
from lab4d_tpu_torch.preprocess.backends.layers import resize_bilinear, to_nchw

FEAT_RES = 112
NUM_PCA = 16
PCA_SAMPLES = 20000  # masked pixels drawn per video for the fit


# ---------------------------------------------------------------------------
# filter-bank backend
# ---------------------------------------------------------------------------


def _sep_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """(B, C, H, W) separable Gaussian blur: edge padding, a 'valid'
    convolution along H, then along W."""
    k = _gauss_kernel1d(sigma, img.device)
    pad = (len(k) - 1) // 2
    b, c, h, w = img.shape
    x = img.reshape(b * c, 1, h, w)
    x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="replicate"), k.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="replicate"), k.view(1, 1, 1, -1))
    return x.reshape(b, c, h, w)


def _dx(g):  # central difference along W, wrapping around
    return (torch.roll(g, -1, -1) - torch.roll(g, 1, -1)) * 0.5


def _dy(g):  # central difference along H, wrapping around
    return (torch.roll(g, -1, -2) - torch.roll(g, 1, -2)) * 0.5


def filterbank_features(rgb: torch.Tensor, out_res: int = FEAT_RES) -> torch.Tensor:
    """(B, 3, H, W) float in [0,1] -> (B, 20, out_res, out_res) raw responses."""
    img = resize_bilinear(rgb, (out_res * 2, out_res * 2))
    gray = img.mean(1, keepdim=True)
    chans = []
    # multi-scale color
    for sigma in (1.0, 3.0, 8.0):
        chans.append(_sep_blur(img, sigma))
    # oriented even/odd responses at two scales
    for sigma in (1.5, 4.0):
        g = _sep_blur(gray, sigma)
        gx, gy = _dx(g), _dy(g)
        chans += [gx, gy, _dx(gx), _dy(gy), _dy(gx)]
    # local contrast
    chans.append(_sep_blur(gray, 1.0) - _sep_blur(gray, 4.0))
    return resize_bilinear(torch.cat(chans, 1), (out_res, out_res))


def frames_features_filterbank(rgbs_u8: List[np.ndarray], device=None) -> torch.Tensor:
    """(H, W, 3) uint8 frames of one size -> (N, 20, FEAT_RES, FEAT_RES) on the device."""
    dev = resolve_device(device)
    with torch.no_grad():
        return torch.cat([
            filterbank_features(to_nchw(np.stack(rgbs_u8[i:i + 32]) / np.float32(255.0), dev))
            for i in range(0, len(rgbs_u8), 32)
        ])


# ---------------------------------------------------------------------------
# dinov2 backend (gated on the hub cache)
# ---------------------------------------------------------------------------


def probe_dinov2() -> bool:
    import torch

    return os.path.isdir(os.path.join(torch.hub.get_dir(), "facebookresearch_dinov2_main"))


_DINO_MEAN = np.array([0.485, 0.456, 0.406])
_DINO_STD = np.array([0.229, 0.224, 0.225])


@functools.lru_cache(maxsize=2)
def _dinov2(device: str):
    model = torch.hub.load("facebookresearch/dinov2", "dinov2_vits14")
    return model.to(device).eval()


def frames_features_dinov2(rgbs_u8: List[np.ndarray], device=None) -> torch.Tensor:
    """(H, W, 3) uint8 frames -> (N, C, FEAT_RES, FEAT_RES): each frame
    resized to 224^2 (cv2), normalised with ImageNet's mean and std (in
    float64, as the JAX package's backend), its 16x16 patch tokens
    bilinearly resized."""
    dev = resolve_device(device)
    model = _dinov2(str(dev))
    out = []
    with torch.no_grad():
        for rgb in rgbs_u8:
            img = cv2.resize(rgb, (224, 224)).astype(np.float32) / 255.0
            img = (img - _DINO_MEAN) / _DINO_STD
            x = torch.tensor(img.transpose(2, 0, 1)[None], dtype=torch.float32, device=dev)
            tok = model.forward_features(x)["x_norm_patchtokens"]
            feat = tok.reshape(1, 16, 16, -1).permute(0, 3, 1, 2)
            out.append(F.interpolate(feat, size=(FEAT_RES, FEAT_RES), mode="bilinear"))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# collection-level extraction with shared PCA
# ---------------------------------------------------------------------------


def pca_fit(pool: np.ndarray, n_components: int):
    """(mean, components) of sklearn's PCA(n_components).fit(pool) (see
    the module docstring), in pool's float dtype."""
    n, d = pool.shape
    mean = pool.mean(axis=0)
    if d <= 1000 and n >= 10 * d:  # sklearn's "covariance_eigh"
        cov = pool.T @ pool
        cov -= n * mean.reshape(-1, 1) * mean.reshape(1, -1)
        cov /= n - 1
        _, vecs = np.linalg.eigh(cov)
        vt = np.flip(vecs, axis=1).T
    else:  # "full"
        _, _, vt = np.linalg.svd(pool - mean, full_matrices=False)
    rows = np.arange(vt.shape[0])
    vt = vt * np.sign(vt[rows, np.argmax(np.abs(vt), axis=1)])[:, None]
    return mean, vt[:n_components]


def extract_features_collection(
    seq_frames: List[List[str]],
    crop_size: int,
    use_full: bool,
    component_id: int = 1,
    backend: str = "filterbank",
    rng_seed: int = 0,
    device=None,
):
    """seq_frames: per-video lists of raw frame paths. Returns per-video
    (N, 112, 112, 16) float16 arrays, masked + L2-normalized, with one
    PCA basis shared across the collection."""
    from lab4d_tpu_torch.preprocess.libs.io import load_frame_data

    dev = resolve_device(device)
    if backend == "dinov2":
        frames_fn = frames_features_dinov2
    elif backend == "net":
        from lab4d_tpu_torch.preprocess.backends.feat_net import frames_features_net

        frames_fn = frames_features_net
    elif backend == "filterbank":
        frames_fn = frames_features_filterbank
    else:
        raise ValueError(f"LAB4D_FEAT_BACKEND={backend!r}: not one of dinov2, net, filterbank")

    raw_feats, masks = [], []
    for paths in seq_frames:
        rgbs, vid_masks = [], []
        for p in paths:
            rgb, _, mask, _ = load_frame_data(p, crop_size, use_full, component_id)
            rgbs.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            vid_masks.append(
                cv2.resize(
                    mask.astype(np.uint8), (FEAT_RES, FEAT_RES),
                    interpolation=cv2.INTER_NEAREST,
                ).astype(bool)
            )
        # (N, H, W, C) on the device, as the pixels are ordered for the draw
        raw_feats.append(frames_fn(rgbs, device=dev).permute(0, 2, 3, 1).contiguous())
        masks.append(torch.from_numpy(np.stack(vid_masks)).to(dev))

    # fit the shared PCA over subsampled masked pixels
    rng = np.random.default_rng(rng_seed)
    samples = []
    for vf, vm in zip(raw_feats, masks):
        px = vf[vm]
        if len(px) == 0:
            px = vf.reshape(-1, vf.shape[-1])
        take = min(len(px), PCA_SAMPLES)
        pick = torch.from_numpy(rng.choice(len(px), take, replace=False)).to(dev)
        samples.append(px[pick].cpu().numpy())
    pool = np.concatenate(samples, 0)
    mean, comps = pca_fit(pool, min(NUM_PCA, pool.shape[-1]))
    comps_t = torch.from_numpy(np.ascontiguousarray(comps)).to(dev)
    offset = torch.from_numpy(mean.reshape(1, -1) @ comps.T).to(dev)

    out = []
    with torch.no_grad():
        for vf, vm in zip(raw_feats, masks):
            flat = vf.reshape(-1, vf.shape[-1]) @ comps_t.T - offset
            if flat.shape[-1] < NUM_PCA:  # pad if the bank is narrow
                flat = F.pad(flat, (0, NUM_PCA - flat.shape[-1]))
            feat = flat.reshape(vf.shape[0], FEAT_RES, FEAT_RES, NUM_PCA)
            feat = feat / torch.clamp(torch.linalg.vector_norm(feat, dim=-1, keepdim=True),
                                      min=1e-6)
            feat = feat * vm[..., None]
            out.append(feat.cpu().numpy().astype(np.float16))
    return out
