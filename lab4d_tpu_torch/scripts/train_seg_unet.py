"""Distill the video-segmentation U-Net's weights from synthetic scenes
with analytic masks (the raw scene of tools/synthetic_scene.py and the
articulated object of tools/synthetic_adversarial.py): the port of
scripts/train_seg_unet.py, the same samples from the same seed, the same
loss and optimizer.

    python -m lab4d_tpu_torch.scripts.train_seg_unet [steps] [res] [out_path] [--device cpu]

Writes database/weights/seg_unet.msgpack under the current directory (or
$LAB4D_WEIGHTS_DIR); the segmentation stage loads it. Each sample pairs a
rendered frame with a corrupted previous-frame mask in the conditioning
channel (random shift / dilation / erosion / dropout, sometimes blank),
so the net learns drift-correcting propagation, not mask copying. Prints
held-out IoU for the trained net vs the classical GrabCut backend.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lab4d_tpu_torch.scripts.train_flow_raft import _rand_pose
from lab4d_tpu_torch.tools.synthetic_scene import FG_RADIUS, render_raw_frame

PEAK_LR = 3e-4


def _render_raw(rng, res: int):
    """Raw-scene frame (textured fg sphere inside a textured bg sphere)
    with a random fg size, camera and texture."""
    K = (res * rng.uniform(0.8, 1.3), res * rng.uniform(0.8, 1.3),
         res / 2, res / 2)
    rt = _rand_pose(rng, rng.uniform(0, 1))
    f = rng.uniform(2.0, 12.0, 3)
    radius = FG_RADIUS * rng.uniform(0.5, 1.6)
    rgb, mask, _, _ = render_raw_frame(rt, K, res, tex_freqs=f, fg_radius=radius)
    return rgb.astype(np.float32), mask.astype(np.float32)


def _render_adversarial(rng, res: int):
    """Articulated two-part object composited over a textured background
    (the adversarial renderer leaves misses black, which would make the
    task trivial)."""
    from lab4d_tpu_torch.tools.synthetic_adversarial import render_frame

    K = (res * rng.uniform(0.9, 1.4), res * rng.uniform(0.9, 1.4),
         res / 2, res / 2)
    rgb, mask, _, _, _, _ = render_frame(rng.uniform(0, 1), K, res)
    bg_rgb, bg_mask = _render_raw(rng, res)
    # the raw scene's fg sphere, darkened, reads as clutter, not the target
    bg = np.where(bg_mask[..., None] > 0, bg_rgb * 0.6, bg_rgb)
    rgb = np.where(mask[..., None], rgb, bg)
    return rgb.astype(np.float32), mask.astype(np.float32)


def _random_crop(rng, rgb, mask, res: int):
    """Random crop + resize: translation/scale augmentation."""
    import cv2

    h = rgb.shape[0]
    s = int(h * rng.uniform(0.6, 1.0))
    y0 = rng.integers(0, h - s + 1)
    x0 = rng.integers(0, h - s + 1)
    rgb_c = cv2.resize(rgb[y0:y0 + s, x0:x0 + s], (res, res))
    mask_c = cv2.resize(mask[y0:y0 + s, x0:x0 + s], (res, res),
                        interpolation=cv2.INTER_NEAREST)
    return rgb_c, mask_c


def _corrupt_prev(rng, mask, res: int):
    """Simulated previous-frame prediction: shifted/eroded/dilated GT,
    occasionally blank (first-frame bootstrap)."""
    import cv2

    r = rng.uniform()
    if r < 0.25:
        return np.full((res, res), 0.5, np.float32)
    m = mask.astype(np.float32)
    dx, dy = rng.integers(-res // 12, res // 12 + 1, 2)
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    m = cv2.warpAffine(m, M, (res, res))
    k = int(rng.integers(1, res // 24 + 2))
    kern = np.ones((k, k), np.uint8)
    if rng.uniform() < 0.5:
        m = cv2.dilate(m, kern)
    else:
        m = cv2.erode(m, kern)
    if rng.uniform() < 0.3:  # speckle dropout
        drop = rng.random((res, res)) < 0.05
        m = np.where(drop, 1.0 - m, m)
    return np.clip(m + rng.normal(0, 0.05, m.shape), 0, 1).astype(np.float32)


def gen_sample(rng, res: int):
    if rng.uniform() < 0.5:
        rgb, mask = _render_raw(rng, res)
    else:
        rgb, mask = _render_adversarial(rng, res)
    rgb, mask = _random_crop(rng, rgb, mask, res)
    prev = _corrupt_prev(rng, mask, res)
    x = np.concatenate([rgb, prev[..., None]], axis=-1)
    return x.astype(np.float32), mask.astype(np.float32)


def make_batch(rng, B, res):
    out = [gen_sample(rng, res) for _ in range(B)]
    return tuple(np.stack([o[i] for o in out]) for i in range(2))


def iou(pred, gt) -> float:
    p = np.asarray(pred) > 0.5
    g = np.asarray(gt) > 0.5
    inter = (p & g).sum()
    union = (p | g).sum()
    return float(inter / max(union, 1))


def make_model(generator: torch.Generator):
    """SegUNet at flax's initialisation, drawn from `generator`."""
    from lab4d_tpu_torch.preprocess.backends.layers import flax_init_
    from lab4d_tpu_torch.preprocess.backends.seg_unet import SegUNet

    return flax_init_(SegUNet(), generator)


def loss_fn(model, x, gt):
    """BCE plus Dice on the clipped foreground probability."""
    prob = torch.clamp(model(x.permute(0, 3, 1, 2)), 1e-6, 1 - 1e-6)
    bce = -(gt * torch.log(prob) + (1 - gt) * torch.log(1 - prob)).mean()
    inter = (prob * gt).sum(dim=(1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (prob.sum(dim=(1, 2)) + gt.sum(dim=(1, 2)) + 1.0)
    return bce + dice.mean()


def train(model, pool, steps, log_every=50, step_ms=None):
    from lab4d_tpu_torch.scripts.optim import fit

    return fit(model, pool, steps, loss_fn, PEAK_LR, log_every, ".4f", "", step_ms)


def heldout(model, res, seed=0):
    """Mean IoU of the net and of GrabCut on a short held-out orbit clip
    (the GrabCut backend needs motion)."""
    from lab4d_tpu_torch.preprocess.backends.seg_backends import segment_video_grabcut
    from lab4d_tpu_torch.preprocess.backends.seg_unet import segment_video_unet

    dev = next(model.parameters()).device
    ev_rng = np.random.default_rng(seed + 1234)
    K = (res * 1.1, res * 1.1, res / 2, res / 2)
    frames, gts = [], []
    for i in range(6):
        rgb, mask, _, _ = render_raw_frame(_rand_pose(ev_rng, 0.1 + 0.08 * i), K, res)
        frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        gts.append(mask)
    m_net = segment_video_unet(frames, model=model, res=res, device=dev)
    m_gc = segment_video_grabcut(frames, res=res, device=dev)
    i_net = np.mean([iou(a, b) for a, b in zip(m_net, gts)])
    i_gc = np.mean([iou(a, b) for a, b in zip(m_gc, gts)])
    print(f"held-out IoU: unet={i_net:.3f}, grabcut={i_gc:.3f}")
    return float(i_net), float(i_gc)


def main(steps=1500, res=128, out_path=None, batch=4, seed=0, log_every=50, model=None,
         device=None, stats=None):
    """Train, write the weights, print the held-out IoU; returns (net IoU,
    GrabCut IoU). `model` and `stats` as in optim.run_main."""
    from lab4d_tpu_torch.scripts.optim import run_main

    return run_main("seg_unet.msgpack", lambda rng: make_batch(rng, batch, res), make_model,
                    train, lambda m: heldout(m, res, seed), steps, out_path, seed, log_every,
                    model, device, stats)


if __name__ == "__main__":
    from lab4d_tpu_torch.scripts.optim import cli_args

    a, device = cli_args(sys.argv[1:])
    main(
        steps=int(a[0]) if len(a) > 0 else 1500,
        res=int(a[1]) if len(a) > 1 else 128,
        out_path=a[2] if len(a) > 2 else None,
        device=device,
    )
