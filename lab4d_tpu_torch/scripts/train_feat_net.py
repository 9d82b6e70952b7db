"""Train the dense-descriptor net self-supervised on synthetic multi-view
correspondences: the port of scripts/train_feat_net.py, the same pairs
from the same seed, the same loss and optimizer.

Pairs come from the flow trainer's renderer (train_flow_raft.gen_pair):
two views of a textured scene with analytic dense correspondence and an
occlusion-aware validity mask. The loss is symmetric InfoNCE over
flow-matched pixels: the descriptor of a point in view 0 must match the
descriptor at its reprojection in view 1 against the K-1 other matches
of the pair.

    python -m lab4d_tpu_torch.scripts.train_feat_net [steps] [out_path] [--device cpu]

Writes database/weights/feat_net.msgpack under the current directory (or
$LAB4D_WEIGHTS_DIR); the feature stage loads it. Prints held-out top-1
correspondence accuracy for the net vs the classical filter bank.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from lab4d_tpu_torch.scripts.train_flow_raft import gen_pair

RES = 112
K = 192  # matched pixels per pair (positives; each is a negative for the rest)
TEMP = 0.07
PEAK_LR = 3e-4


def photometric_jitter(rng, rgb):
    """Per-channel gain/offset + gamma: the exposure / white-balance
    shifts of real video between views."""
    gain = rng.uniform(0.7, 1.3, 3)
    bias = rng.uniform(-0.1, 0.1, 3)
    gamma = rng.uniform(0.8, 1.25)
    out = np.clip(rgb, 0, 1) ** gamma
    return np.clip(out * gain + bias, 0.0, 1.0).astype(np.float32)


def sample_correspondences(rng, flow, valid):
    """K source pixels (y, x) + their matched target pixels, valid only."""
    ys, xs = np.nonzero(valid > 0.5)
    if len(ys) < K:
        return None
    take = rng.choice(len(ys), K, replace=False)
    y0, x0 = ys[take], xs[take]
    disp = flow[y0, x0]
    x1 = np.clip(x0 + disp[:, 0], 0, RES - 1)
    y1 = np.clip(y0 + disp[:, 1], 0, RES - 1)
    return (
        np.stack([y0, x0], -1).astype(np.int32),
        np.stack([y1, x1], -1).astype(np.float32),
    )


def make_batch(rng, B):
    """B pairs; a pair with fewer than K valid pixels is drawn and dropped
    (its draws consumed), as in JAX."""
    out = []
    while len(out) < B:
        rgb0, rgb1, flow, valid = gen_pair(rng, RES)
        corr = sample_correspondences(rng, flow, valid)
        if corr is None:
            continue
        out.append((rgb0, photometric_jitter(rng, rgb1), corr[0], corr[1]))
    return tuple(np.stack([o[i] for o in out]) for i in range(4))


def bilinear(fmap, yx):
    """fmap (B, H, W, C), yx (B, K, 2) float (y, x) -> (B, K, C); the
    corners clamped to the map, the weights not."""
    b = torch.arange(fmap.shape[0], device=fmap.device)[:, None]
    y, x = yx[..., 0], yx[..., 1]
    y0 = torch.clamp(torch.floor(y).long(), 0, fmap.shape[1] - 2)
    x0 = torch.clamp(torch.floor(x).long(), 0, fmap.shape[2] - 2)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    f00 = fmap[b, y0, x0]
    f01 = fmap[b, y0, x0 + 1]
    f10 = fmap[b, y0 + 1, x0]
    f11 = fmap[b, y0 + 1, x0 + 1]
    return (
        f00 * (1 - wy) * (1 - wx)
        + f01 * (1 - wy) * wx
        + f10 * wy * (1 - wx)
        + f11 * wy * wx
    )


def make_model(seed: int = 0):
    """FeatNet at flax's init from PRNGKey(seed), as the JAX trainer's
    `FeatNet().init(PRNGKey(0), ...)` (seed 0)."""
    from lab4d_tpu_torch.preprocess.backends.feat_net import FeatNet
    from lab4d_tpu_torch.preprocess.backends.layers import flax_init_
    from lab4d_tpu_torch.utils import jax_random as jr

    return flax_init_(FeatNet(), jr.PRNGKey(seed))


def loss_fn(model, i0, i1, src, dst):
    """Symmetric InfoNCE at temperature 0.07 over each pair's K matches,
    averaged over the pairs."""
    B = i0.shape[0]
    f = model(torch.cat([i0, i1]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    f0, f1 = f[:B], f[B:]
    b = torch.arange(B, device=f.device)[:, None]
    src = src.long()
    d0 = f0[b, src[..., 0], src[..., 1]]            # (B, K, C)
    d1 = bilinear(f1, dst)                           # (B, K, C)
    d1 = d1 / torch.clamp(torch.linalg.vector_norm(d1, dim=-1, keepdim=True), min=1e-6)
    logits = d0 @ d1.transpose(1, 2) / TEMP          # (B, K, K)
    labels = torch.arange(K, device=f.device).repeat(B)
    ce = F.cross_entropy(logits.reshape(B * K, K), labels)
    ce_t = F.cross_entropy(logits.transpose(1, 2).reshape(B * K, K), labels)
    return 0.5 * (ce + ce_t)


def train(model, pool, steps, log_every=50, step_ms=None):
    from lab4d_tpu_torch.scripts.optim import fit

    return fit(model, pool, steps, loss_fn, PEAK_LR, log_every, ".3f", "", step_ms)


def eval_top1(desc_fn, seed: int = 999, n_pairs: int = 8) -> float:
    """Held-out top-1 correspondence accuracy among the K in-pair
    candidates, under photometric jitter on view 1. Re-seeds its own rng,
    so two backends evaluated with the same seed see the same pairs."""
    ev = np.random.default_rng(seed)
    accs = []
    for _ in range(n_pairs):
        rgb0, rgb1, flow, valid = gen_pair(ev, RES)
        rgb1 = photometric_jitter(ev, rgb1)
        corr = sample_correspondences(ev, flow, valid)
        if corr is None:
            continue
        src, dst = corr
        f0 = np.asarray(desc_fn(rgb0))
        f1 = np.asarray(desc_fn(rgb1))
        f0 = f0 / np.maximum(np.linalg.norm(f0, axis=-1, keepdims=True), 1e-6)
        f1 = f1 / np.maximum(np.linalg.norm(f1, axis=-1, keepdims=True), 1e-6)
        d0 = f0[src[:, 0], src[:, 1]]
        di = np.round(dst).astype(int)
        d1 = f1[np.clip(di[:, 0], 0, RES - 1), np.clip(di[:, 1], 0, RES - 1)]
        sim = d0 @ d1.T
        accs.append(float((sim.argmax(1) == np.arange(K)).mean()))
    return float(np.mean(accs))


def heldout(model, seed=0):
    """Paired top-1 accuracy of the net and of the filter bank."""
    from lab4d_tpu_torch.preprocess.backends.feat_backends import filterbank_features

    dev = next(model.parameters()).device

    def run(fn):
        def desc(im):
            x = torch.from_numpy(im.astype(np.float32)).to(dev).permute(2, 0, 1)[None]
            with torch.no_grad():
                return fn(x)[0].permute(1, 2, 0).cpu().numpy()
        return desc

    acc_net = eval_top1(run(model), seed=seed + 999, n_pairs=8)
    acc_fb = eval_top1(run(filterbank_features), seed=seed + 999, n_pairs=8)
    print(f"held-out top-1 correspondence acc (K={K}): "
          f"net={acc_net:.3f}, filterbank={acc_fb:.3f}")
    return acc_net, acc_fb


def main(steps=1200, out_path=None, batch=4, seed=0, log_every=50, model=None, device=None,
         stats=None):
    """Train, write the weights, print the held-out accuracy; returns (net,
    filter bank). `model` and `stats` as in optim.run_main."""
    from lab4d_tpu_torch.scripts.optim import run_main

    return run_main("feat_net.msgpack", lambda rng: make_batch(rng, batch), make_model, train,
                    lambda m: heldout(m, seed), steps, out_path, seed, log_every, model, device,
                    stats)


if __name__ == "__main__":
    from lab4d_tpu_torch.scripts.optim import cli_args

    a, device = cli_args(sys.argv[1:])
    main(steps=int(a[0]) if len(a) > 0 else 1200,
         out_path=a[1] if len(a) > 1 else None, device=device)
