"""Distill the monocular-depth U-Net's weights from synthetic scenes with
analytic depth (the raw scene of tools/synthetic_scene.py): the port of
scripts/train_depth_unet.py, the same frames from the same seed, the same
loss and optimizer.

    python -m lab4d_tpu_torch.scripts.train_depth_unet [steps] [res] [out_path] [--device cpu]

Writes database/weights/depth_unet.msgpack under the current directory
(or $LAB4D_WEIGHTS_DIR); the depth stage loads it. Prints held-out
scale-invariant RMSE for the trained net vs the classical motion-parallax
proxy.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lab4d_tpu_torch.scripts.train_flow_raft import _rand_pose
from lab4d_tpu_torch.tools.synthetic_scene import render_raw_frame

PEAK_LR = 3e-4


def gen_frame(rng: np.random.Generator, res: int):
    """One random textured frame + GT depth (camera z, metric)."""
    K = (res * rng.uniform(0.8, 1.3), res * rng.uniform(0.8, 1.3),
         res / 2, res / 2)
    rt = _rand_pose(rng, rng.uniform(0, 1))
    f = rng.uniform(2.0, 12.0, 3)
    rgb, _, depth, _ = render_raw_frame(rt, K, res, tex_freqs=f)
    return rgb.astype(np.float32), depth.astype(np.float32)


def make_batch(rng, B, res):
    out = [gen_frame(rng, res) for _ in range(B)]
    return tuple(np.stack([o[i] for o in out]) for i in range(2))


def silog_rmse(pred, gt) -> float:
    """Scale-invariant log RMSE (Eigen et al.) over valid gt."""
    pred = np.maximum(np.asarray(pred, np.float64), 1e-3)
    m = gt > 1e-3
    d = np.log(pred[m]) - np.log(gt[m])
    return float(np.sqrt(np.mean(d**2) - np.mean(d) ** 2))


def make_model(generator: torch.Generator):
    """DepthUNet at flax's initialisation (output bias 3.0), drawn from `generator`."""
    from lab4d_tpu_torch.preprocess.backends.depth_unet import DepthUNet
    from lab4d_tpu_torch.preprocess.backends.layers import flax_init_

    return flax_init_(DepthUNet(), generator)


def loss_fn(model, rgb, gt):
    """Scale-invariant log loss plus half the edge-aware gradient term."""
    pred = model(rgb.permute(0, 3, 1, 2))
    valid = (gt > 1e-3).float()
    logd = torch.log(torch.clamp(pred, min=1e-3)) - torch.log(torch.clamp(gt, min=1e-3))
    n = torch.clamp(valid.sum(dim=(1, 2)), min=1.0)
    mse = (valid * logd**2).sum(dim=(1, 2)) / n
    mean = (valid * logd).sum(dim=(1, 2)) / n
    silog = mse - 0.5 * mean**2
    # edge-aware gradient matching keeps boundaries crisp
    gx = torch.abs(torch.diff(logd, dim=2)) * valid[:, :, 1:]
    gy = torch.abs(torch.diff(logd, dim=1)) * valid[:, 1:, :]
    grad = gx.mean(dim=(1, 2)) + gy.mean(dim=(1, 2))
    return (silog + 0.5 * grad).mean()


def train(model, pool, steps, log_every=50, step_ms=None):
    from lab4d_tpu_torch.scripts.optim import fit

    return fit(model, pool, steps, loss_fn, PEAK_LR, log_every, ".4f", "", step_ms)


def heldout(model, res, seed=0):
    """Mean siLog-RMSE of the net and of the motion-parallax proxy on 4
    held-out frames (the proxy gets a second frame for its motion)."""
    from lab4d_tpu_torch.preprocess.backends.depth_backends import depth_video_flowdisp

    dev = next(model.parameters()).device
    ev_rng = np.random.default_rng(seed + 1234)
    e_net, e_classic = [], []
    for _ in range(4):
        rgb, gt = gen_frame(ev_rng, res)
        with torch.no_grad():
            pred = model(torch.from_numpy(rgb).to(dev).permute(2, 0, 1)[None])[0]
        e_net.append(silog_rmse(pred.cpu().numpy(), gt))
        rgb2, _ = gen_frame(ev_rng, res)
        frames8 = [(np.clip(r, 0, 1) * 255).astype(np.uint8) for r in (rgb, rgb2)]
        d_classic = depth_video_flowdisp(frames8, res=res, device=dev)[0]
        e_classic.append(silog_rmse(d_classic, gt))
    print(f"held-out siLog-RMSE: unet={np.mean(e_net):.3f}, "
          f"classical={np.mean(e_classic):.3f}")
    return float(np.mean(e_net)), float(np.mean(e_classic))


def main(steps=1200, res=128, out_path=None, batch=4, seed=0, log_every=50, model=None,
         device=None, stats=None):
    """Train, write the weights, print the held-out siLog-RMSE; returns
    (net, classical). `model` and `stats` as in optim.run_main."""
    from lab4d_tpu_torch.scripts.optim import run_main

    return run_main("depth_unet.msgpack", lambda rng: make_batch(rng, batch, res), make_model,
                    train, lambda m: heldout(m, res, seed), steps, out_path, seed, log_every,
                    model, device, stats)


if __name__ == "__main__":
    from lab4d_tpu_torch.scripts.optim import cli_args

    a, device = cli_args(sys.argv[1:])
    main(
        steps=int(a[0]) if len(a) > 0 else 1200,
        res=int(a[1]) if len(a) > 1 else 128,
        out_path=a[2] if len(a) > 2 else None,
        device=device,
    )
