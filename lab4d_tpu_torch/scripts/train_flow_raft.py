"""Distill the RAFT-lite flow net's weights from synthetic scenes with
analytic ground-truth flow (the raw scene of tools/synthetic_scene.py):
the port of scripts/train_flow_raft.py, the same pairs from the same
seed, the same loss and optimizer.

    python -m lab4d_tpu_torch.scripts.train_flow_raft [steps] [res] [out_path] [--device cpu]

Writes database/weights/flow_raft.msgpack under the current directory (or
$LAB4D_WEIGHTS_DIR), in flax's msgpack layout; the flow stage loads it.
Prints held-out EPE for the trained net vs the classical pyramid flow.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lab4d_tpu_torch.tools.synthetic_scene import (CAM_DIST, orbit_pose, project_points,
                                                   render_raw_frame)

PEAK_LR = 2e-4


def _pose(t, el, dd):
    """Orbit pose at phase t with elevation el (rad) and distance offset."""
    rt = orbit_pose(t, dist=CAM_DIST + dd)
    R_x = np.array(
        [
            [1, 0, 0],
            [0, np.cos(el), -np.sin(el)],
            [0, np.sin(el), np.cos(el)],
        ]
    )
    rt2 = np.eye(4)
    rt2[:3, :3] = R_x @ rt[:3, :3]
    rt2[:3, 3] = R_x @ rt[:3, 3]
    return rt2


def _rand_pose(rng, t):
    """Orbit pose with random elevation/distance jitter."""
    return _pose(t, rng.uniform(-0.5, 0.5), rng.uniform(-0.6, 0.9))


def gen_pair(rng: np.random.Generator, res: int):
    """One random textured pair + dense GT flow (px) + valid mask, in the
    JAX trainer's order of draws."""
    K = (res * rng.uniform(0.8, 1.3), res * rng.uniform(0.8, 1.3),
         res / 2, res / 2)
    t0 = rng.uniform(0, 1)
    dt = rng.uniform(0.005, 0.05) * rng.choice([-1, 1])
    # the scene's elevation and distance are shared by the two frames; the
    # camera drifts slightly within the pair
    el = rng.uniform(-0.5, 0.5)
    dd = rng.uniform(-0.6, 0.9)
    rt0 = _pose(t0, el, dd)
    rt1 = _pose(
        t0 + dt, el + rng.uniform(-0.03, 0.03), dd + rng.uniform(-0.05, 0.05)
    )
    f = rng.uniform(2.0, 12.0, 3)  # the fg texture's frequencies, per scene
    rgb0, _, _, pts0 = render_raw_frame(rt0, K, res, tex_freqs=f)
    rgb1, _, _, pts1 = render_raw_frame(rt1, K, res, tex_freqs=f)

    xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    px1 = project_points(pts0, rt1, K)
    flow = px1 - np.stack([xs, ys], -1)
    # occlusion: the supervision is wrong where frame 1 sees another
    # surface at the re-projected point; mask by the re-render's points
    inb = ((px1[..., 0] >= 0) & (px1[..., 0] < res - 1)
           & (px1[..., 1] >= 0) & (px1[..., 1] < res - 1))
    xi = np.clip(px1[..., 0].round().astype(int), 0, res - 1)
    yi = np.clip(px1[..., 1].round().astype(int), 0, res - 1)
    same_pt = np.linalg.norm(pts1[yi, xi] - pts0, axis=-1) < 0.08
    valid = (inb & same_pt).astype(np.float32)
    return (rgb0.astype(np.float32), rgb1.astype(np.float32),
            flow.astype(np.float32), valid)


def make_batch(rng, B, res):
    out = [gen_pair(rng, res) for _ in range(B)]
    return tuple(np.stack([o[i] for o in out]) for i in range(4))


def epe(pred, gt, valid):
    e = np.linalg.norm(np.asarray(pred) - gt, axis=-1)
    return float((e * valid).sum() / np.maximum(valid.sum(), 1))


def make_model(seed: int = 0):
    """RAFTLite at flax's init from PRNGKey(seed), as the JAX trainer's
    `RAFTLite().init(PRNGKey(0), ...)` (seed 0)."""
    from lab4d_tpu_torch.preprocess.backends.flow_raft import RAFTLite
    from lab4d_tpu_torch.preprocess.backends.layers import flax_init_
    from lab4d_tpu_torch.utils import jax_random as jr

    return flax_init_(RAFTLite(), jr.PRNGKey(seed))


def loss_fn(model, i0, i1, gt, valid):
    """L1 flow error summed over (u, v), averaged over the valid pixels.
    The gradient runs through the recurrent coordinates, as in JAX."""
    pred = model(i0.permute(0, 3, 1, 2), i1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    err = torch.abs(pred - gt).sum(-1)
    return (err * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def train(model, pool, steps, log_every=50, step_ms=None):
    from lab4d_tpu_torch.scripts.optim import fit

    return fit(model, pool, steps, loss_fn, PEAK_LR, log_every, ".3f", " px", step_ms)


def heldout(model, res, seed=0):
    """Mean EPE of the net and of the classical pyramid flow on 8 held-out pairs."""
    import cv2

    from lab4d_tpu_torch.preprocess.backends.flow_classical import flow_pyramid

    dev = next(model.parameters()).device
    ev_rng = np.random.default_rng(seed + 1234)
    e_raft, e_classic = [], []
    for _ in range(8):
        i0, i1, gt, valid = gen_pair(ev_rng, res)
        with torch.no_grad():
            pred = model(torch.from_numpy(i0).to(dev).permute(2, 0, 1)[None],
                         torch.from_numpy(i1).to(dev).permute(2, 0, 1)[None])
        e_raft.append(epe(pred[0].permute(1, 2, 0).cpu().numpy(), gt, valid))
        g0 = cv2.cvtColor((i0 * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
        g1 = cv2.cvtColor((i1 * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
        with torch.no_grad():
            fc = flow_pyramid(torch.from_numpy(g0).to(dev)[None].float() / 255.0,
                              torch.from_numpy(g1).to(dev)[None].float() / 255.0)
        e_classic.append(epe(fc[0].cpu().numpy(), gt, valid))
    print(f"held-out EPE: raft={np.mean(e_raft):.2f} px, "
          f"classical={np.mean(e_classic):.2f} px")
    return float(np.mean(e_raft)), float(np.mean(e_classic))


def main(steps=1500, res=128, out_path=None, batch=4, seed=0, log_every=50, model=None,
         device=None, stats=None):
    """Train, write the weights, print the held-out EPE; returns (raft EPE,
    classical EPE). `model` starts the run from given weights (else flax's
    init); `stats` as in optim.run_main."""
    from lab4d_tpu_torch.scripts.optim import run_main

    return run_main("flow_raft.msgpack", lambda rng: make_batch(rng, batch, res), make_model,
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
