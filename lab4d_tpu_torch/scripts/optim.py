"""The optimizer and the loop the five preprocessing-net trainers share
(scripts/train_*.py of the JAX package):

    optax.chain(optax.clip_by_global_norm(1.0),
                optax.adamw(warmup_cosine_decay_schedule(0, peak, min(100, steps // 10),
                                                         steps), weight_decay=1e-5))

- the clip is optax's, `where(norm < 1, g, g / norm)`, which
  torch.nn.utils.clip_grad_norm_ is not (it divides by norm + 1e-6 and
  scales below the threshold too);
- update k runs at the schedule's value at k, read from the chain's own
  count: with a warmup of w >= 1 steps update 0 has lr 0, and with w = 0
  (steps < 10) update 0 runs at the peak;
- torch.optim.AdamW with that lr set before each step is optax's adamw:
  Adam's bias-corrected step plus the decoupled decay lr * wd * p.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

WEIGHT_DECAY = 1e-5
MAX_NORM = 1.0


def warmup_cosine(peak: float, steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0.0, peak, min(100, steps // 10), steps)
    (end value 0, exponent 1): a linear ramp over the warmup, then a
    cosine from peak to 0 over the remaining steps."""
    warmup = min(100, steps // 10)
    decay = steps - warmup

    def sched(k: int) -> float:
        if k < warmup:
            return peak * k / warmup
        if decay <= 0:
            return peak
        c = min(k - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return sched


class Chain:
    """clip_by_global_norm(1.0) then adamw(sched, weight_decay=1e-5) over
    `params`; `step()` reads the gradients in .grad."""

    def __init__(self, params, peak: float, steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.sched = warmup_cosine(peak, steps)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=WEIGHT_DECAY)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def clip(self) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < MAX_NORM
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * MAX_NORM))
        return norm

    def lr(self) -> float:
        return self.sched(self.count)

    def step(self) -> torch.Tensor:
        norm = self.clip()
        for group in self.opt.param_groups:
            group["lr"] = self.lr()
        self.opt.step()
        self.count += 1
        return norm


@contextlib.contextmanager
def direct_convs():
    """On the CPU, the block's convs through ATen's im2col + GEMM (oneDNN
    and NNPACK off); the card's cuDNN is left as it is. oneDNN's fp32
    conv gradients of the descriptor net at flax's init are off by up to
    4e-3 of a leaf's largest (ATen's 9e-7, against fp64), and NNPACK's
    Winograd leaves rounding where the exact output is 0, which at flax's
    zero biases flips the ReLUs over a masked crop's zero background."""
    before = (torch.backends.mkldnn.enabled, torch._C._get_nnpack_enabled())
    torch.backends.mkldnn.enabled = False
    torch._C._set_nnpack_enabled(False)
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = before[0]
        torch._C._set_nnpack_enabled(before[1])


def fit(model: torch.nn.Module, pool: Sequence[Tuple[torch.Tensor, ...]], steps: int,
        loss_fn, peak: float, log_every: int = 50, fmt: str = ".4f", unit: str = "",
        step_ms: Optional[List[float]] = None) -> List[Tuple[int, float]]:
    """`steps` updates of `model` on the batches of `pool` in turn, each
    the loss_fn(model, *batch) gradient through Chain, the convs under
    direct_convs(); prints "step i: loss=... (Ns)" every `log_every`
    steps and at the last, as the JAX trainers do, and returns those
    (step, loss) pairs. With `step_ms` a list and the model on the card,
    each step's time in ms (CUDA events) is appended to it."""
    opt = Chain(model.parameters(), peak, steps)
    cuda = step_ms is not None and next(model.parameters()).is_cuda
    events = []
    logged = []
    t0 = time.time()
    for it in range(steps):
        batch = pool[it % len(pool)]
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        opt.zero_grad()
        with direct_convs():
            loss = loss_fn(model, *batch)
            loss.backward()
        opt.step()
        if cuda:
            end.record()
            events.append((start, end))
        if it % log_every == 0 or it == steps - 1:
            val = float(loss.detach())
            logged.append((it, val))
            print(f"step {it}: loss={val:{fmt}}{unit} ({time.time() - t0:.0f}s)", flush=True)
    if cuda:
        torch.cuda.synchronize()
        step_ms.extend(a.elapsed_time(b) for a, b in events)
    return logged


def make_pool(make_batch: Callable[[], tuple], steps: int, device) -> Tuple[list, float]:
    """The JAX trainers' fixed pool of min(96, steps) batches, made once
    from the trainer's rng and cycled, on `device`; and its seconds."""
    n_pool = min(96, max(steps, 1))
    print(f"generating {n_pool} batches ...", flush=True)
    t0 = time.time()
    pool = [tuple(torch.from_numpy(x).to(device) for x in make_batch()) for _ in range(n_pool)]
    return pool, time.time() - t0


def write_weights(model: torch.nn.Module, out_path: str):
    """The net's parameters as flax.serialization.to_bytes writes them
    (layers.state_dict_to_flax through bridge.msgpack_dumps)."""
    import os

    from lab4d_tpu_torch.bridge import msgpack_dumps
    from lab4d_tpu_torch.preprocess.backends.layers import state_dict_to_flax

    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(msgpack_dumps(state_dict_to_flax(model)))
    print(f"wrote {out_path}")


def run_main(weights_name: str, make_batch, make_model, train, heldout, steps: int,
             out_path=None, seed: int = 0, log_every: int = 50, model=None, device=None,
             stats=None):
    """A trainer's main, as the JAX trainers run it: flax's init from seed 0
    (or `model`), the pool from `seed`, `steps` updates, the weights to
    `out_path` (default train_out_path(weights_name)), then heldout(model),
    whose result it returns. On the card unless `device` says otherwise;
    `stats`, a dict, receives the pool's seconds, each step's ms on the card
    and the logged losses."""
    import numpy as np

    from lab4d_tpu_torch.preprocess import resolve_device
    from lab4d_tpu_torch.preprocess.backends.weights import train_out_path

    dev = resolve_device(device)
    out_path = out_path or train_out_path(weights_name)
    rng = np.random.default_rng(seed)
    model = model if model is not None else make_model(torch.Generator().manual_seed(0))
    model = model.to(dev).train().requires_grad_(True)
    print("params:", sum(p.numel() for p in model.parameters()))

    pool, pool_s = make_pool(lambda: make_batch(rng), steps, dev)
    step_ms = []
    logged = train(model, pool, steps, log_every, step_ms)
    write_weights(model, out_path)
    result = heldout(model)
    if stats is not None:
        stats.update(pool_s=pool_s, step_ms=step_ms, logged=logged, out_path=out_path)
    return result


def cli_args(argv: Sequence[str]) -> Tuple[List[str], Optional[str]]:
    """The positional arguments of a trainer's command line and the
    `--device` value (None: the card)."""
    args, device = list(argv), None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    return args, device
