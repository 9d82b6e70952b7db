"""How far the five preprocessing-net trainers' first-step gradients on
the card lie from the CPU's, at flax's init, with cuDNN's convs, cuDNN's
deterministic ones and ATen's (cuDNN off).

    python3 -m lab4d_tpu_torch.tools.net_grad_devices [--seeds 0 1]

For each trainer (lab4d_tpu_torch/scripts/train_<net>.py) and each seed
S: make_model(S) (flax's PRNGKey(S) init), one batch of make_batch from
seed 0 at the trainer's default size, the gradient of its loss_fn on the
CPU (ATen's convs, fp32 and fp64) and on the card (TF32 off) under each
conv setting. Prints, per pair, the worst leaf's max |difference| in its
max |g|. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import sys

import numpy as np
import torch

from lab4d_tpu_torch.scripts.optim import direct_convs

NETS = {"flow_raft": (4, 128), "seg_unet": (4, 128), "depth_unet": (4, 128),
        "feat_net": (4, None), "viewpoint": (16, None)}
CONVS = (("cudnn", True, False), ("cudnn deterministic", True, True), ("aten", False, False))


def grads(mod, init, batch, dev, dtype=torch.float32):
    """{parameter: gradient (fp64, CPU)} of mod.loss_fn on `batch`."""
    model = copy.deepcopy(init).to(dev).to(dtype)
    xs = [torch.from_numpy(x).to(dev) for x in batch]
    xs = [x.to(dtype) if x.is_floating_point() else x for x in xs]
    with direct_convs():
        mod.loss_fn(model, *xs).backward()
    return {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}


def worst(got, want) -> str:
    errs = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30))
            for k in want}
    k = max(errs, key=errs.get)
    return f"{errs[k]:.2e} ({k})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("net_grad_devices: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (size, res) in NETS.items():
        mod = importlib.import_module(f"lab4d_tpu_torch.scripts.train_{name}")
        batch = mod.make_batch(np.random.default_rng(0), size, *((res,) if res else ()))
        for seed in args.seeds:
            init = mod.make_model(seed).train()
            cpu, cpu64 = grads(mod, init, batch, "cpu"), grads(mod, init, batch, "cpu",
                                                                 torch.float64)
            out = {"cpu fp32 vs fp64": worst(cpu, cpu64)}
            for label, enabled, deterministic in CONVS:
                torch.backends.cudnn.enabled = enabled
                torch.backends.cudnn.deterministic = deterministic
                try:
                    g = grads(mod, init, batch, "cuda")
                finally:
                    torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic = True, False
                out[label] = f"vs cpu {worst(g, cpu)}, vs fp64 {worst(g, cpu64)}"
            print(f"[net-grads] {name} PRNGKey({seed}): "
                  + "; ".join(f"{k} {v}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main()
