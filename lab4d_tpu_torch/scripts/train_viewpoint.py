"""Distill the canonical-viewpoint CNN's weights from the articulated
synthetic object (tools/synthetic_adversarial.py) seen from random
viewpoints with a known canonical pose: the port of
scripts/train_viewpoint.py, the same samples from the same seed, the same
loss and optimizer.

    python -m lab4d_tpu_torch.scripts.train_viewpoint [steps] [out_path] [--device cpu]

Writes database/weights/viewpoint_net.msgpack under the current directory
(or $LAB4D_WEIGHTS_DIR); canonical registration loads it. Prints the
held-out median geodesic rotation error vs the random-rotation chance
level (~126 deg).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lab4d_tpu_torch.preprocess.backends.viewpoint_net import RES

PEAK_LR = 3e-4


def _rand_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def gen_sample(rng: np.random.Generator, res: int = RES):
    """The articulated object from a random viewpoint: (masked rgb crop,
    canonical-to-camera rotation). An object out of frame is drawn again
    from the same rng."""
    from lab4d_tpu_torch.preprocess.backends.viewpoint_net import crop_masked
    from lab4d_tpu_torch.tools.synthetic_adversarial import render_frame

    R = _rand_rotation(rng)
    rt = np.eye(4)
    rt[:3, :3] = R
    rt[2, 3] = rng.uniform(2.0, 3.4)

    t = rng.uniform(0, 1)  # random articulation phase
    K = (res * rng.uniform(0.9, 1.4), res * rng.uniform(0.9, 1.4),
         res / 2, res / 2)
    rgb, hit, _, _, _, _ = render_frame(t, K, res, cam_rt=rt)
    crop = crop_masked(
        (np.clip(rgb, 0, 1) * 255).astype(np.uint8), hit.astype(np.int8)
    )
    if crop is None:  # object out of frame: resample
        return gen_sample(rng, res)
    return crop.astype(np.float32), R.astype(np.float32)


def make_batch(rng, B):
    out = [gen_sample(rng) for _ in range(B)]
    return tuple(np.stack([o[i] for o in out]) for i in range(2))


def geodesic_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    tr = np.trace(np.asarray(Ra).T @ np.asarray(Rb))
    return float(np.rad2deg(np.arccos(np.clip((tr - 1) / 2, -1, 1))))


def make_model(generator: torch.Generator):
    """ViewpointNet at flax's initialisation, drawn from `generator`."""
    from lab4d_tpu_torch.preprocess.backends.layers import flax_init_
    from lab4d_tpu_torch.preprocess.backends.viewpoint_net import ViewpointNet

    return flax_init_(ViewpointNet(), generator)


def loss_fn(model, imgs, Rs):
    """The squared Frobenius distance of the rotations (geodesic-equivalent)."""
    pred = model(imgs.permute(0, 3, 1, 2))
    return torch.mean(torch.sum((pred - Rs) ** 2, dim=(-2, -1)))


def train(model, pool, steps, log_every=50, step_ms=None):
    """fit with the card's convs through ATen, not cuDNN: cuDNN's fp32
    convs move this net's gradients by up to 1.6e-3 of a leaf's max from
    the CPU's (at flax's zero biases they also round the exact zeros over
    the masked crops' background to either side of the ReLUs), and the
    nets trained through them end far from the CPU's and JAX's from the
    same inits (PERF.md §6)."""
    from lab4d_tpu_torch.scripts.optim import fit

    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        return fit(model, pool, steps, loss_fn, PEAK_LR, log_every, ".4f", "", step_ms)
    finally:
        torch.backends.cudnn.enabled = enabled


def heldout(model, seed=0):
    """Median geodesic error over 32 held-out samples."""
    dev = next(model.parameters()).device
    ev = np.random.default_rng(seed + 1234)
    errs = []
    for _ in range(32):
        img, R = gen_sample(ev)
        with torch.no_grad():
            pred = model(torch.from_numpy(img).to(dev).permute(2, 0, 1)[None])[0]
        errs.append(geodesic_deg(pred.cpu().numpy(), R))
    print(f"held-out geodesic error: median={np.median(errs):.1f} deg "
          f"(chance ~126 deg)")
    return float(np.median(errs))


def main(steps=1500, out_path=None, batch=16, seed=0, log_every=50, model=None, device=None,
         stats=None):
    """Train, write the weights, print the held-out median geodesic error
    and return it. `model` and `stats` as in optim.run_main."""
    from lab4d_tpu_torch.scripts.optim import run_main

    return run_main("viewpoint_net.msgpack", lambda rng: make_batch(rng, batch), make_model,
                    train, lambda m: heldout(m, seed), steps, out_path, seed, log_every, model,
                    device, stats)


if __name__ == "__main__":
    from lab4d_tpu_torch.scripts.optim import cli_args

    a, device = cli_args(sys.argv[1:])
    main(steps=int(a[0]) if len(a) > 0 else 1500,
         out_path=a[1] if len(a) > 1 else None, device=device)
