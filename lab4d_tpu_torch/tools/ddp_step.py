"""The training step over ranks against the one-process step on the same
global batch, params and draws (parallel/dist.py).

A case file (save_case) holds a model's constructor arguments and
params, one global batch with its geometry state, and optionally the
step's random draws at the global batch's shape (without them, each side
derives the step's draws from its index, as the trainer does, so the
draws' global shapes are checked too). run_case runs `steps`
training steps on it in this process, on one rank's block where a
process group is up; run_sharded starts `world` ranks (gloo on the CPU,
or NCCL / gloo on the card, several ranks sharing one card through
gloo) and collects rank 0's result and every rank's param checksum.
compare holds a sharded result against the one-process one.
chip_smoke.py's [ddp] phase and tests/test_torch_ddp.py run it.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from lab4d_tpu_torch.parallel import dist

MODEL_KEYS = ("field_type", "fg_motion", "num_inst", "intrinsics_init", "rtmat_fg", "rtmat_bg",
              "train_res", "loss_weights", "joint_angles_init")
# the optimizer's schedule (the JAX one-step tests': a 20-round run of 400
# steps at 5e-4)
LEARNING_RATE, NUM_ROUNDS, TOTAL_STEPS = 5e-4, 20, 400


def save_case(path: str, frame_info, model_kwargs: Dict, state: Dict[str, np.ndarray],
              batch: Dict[str, np.ndarray], geo: Dict, step: int, draws: Optional[Dict] = None):
    """Write a case: frame_info (frame_offset, frame_offset_raw,
    frame_mapping), DVRModel's keyword arguments (MODEL_KEYS), its params
    (numpy, by state-dict name), the global batch ((M, 2, N, ...) numpy)
    and its geo state ({cate: {aabb, near_far_table, proxy_corners}}), the
    step index and the draws ({cate: {name: array}}, "swap" a list of
    (rand_id, u) pairs)."""
    torch.save({
        "frame_info": [np.asarray(frame_info.frame_offset), np.asarray(frame_info.frame_offset_raw),
                       list(frame_info.frame_mapping)],
        "model": {k: model_kwargs[k] for k in MODEL_KEYS if k in model_kwargs},
        "state": {k: np.asarray(v) for k, v in state.items()},
        "batch": {k: np.asarray(v) for k, v in batch.items()},
        "geo": {c: {k: np.asarray(v) for k, v in g.items()} for c, g in geo.items()},
        "draws": draws, "step": step,
    }, path)


def load_case(path: str) -> Dict:
    return torch.load(path, weights_only=False)


def build_trainer(case: Dict, device):
    """The case's model on `device` with the trainer's optimizer and step
    (a Trainer without a dataset)."""
    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.engine.model import DVRModel
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo

    model = DVRModel(FrameInfo(*case["frame_info"]), device=device, **case["model"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    trainer = Trainer.__new__(Trainer)
    trainer.model, trainer.device = model, torch.device(device)
    trainer.opts = {"learning_rate": LEARNING_RATE, "num_rounds": NUM_ROUNDS}
    trainer.total_steps = TOTAL_STEPS
    trainer.optimizer_init()
    return trainer


def _draws_to(draws, device):
    if draws is None:
        return None
    return {c: {k: [tuple(torch.as_tensor(a, device=device) for a in p) for p in v]
                if k == "swap" else torch.as_tensor(v, device=device) for k, v in d.items()}
            for c, d in draws.items()}


def run_case(case: Dict, device, steps: int = 1) -> Dict:
    """`steps` training steps on the case's batch (on this rank's block of
    it where a process group is up). Returns the first step's loss terms
    (summed over the ranks: the global batch's), its gradients (summed
    over the ranks) and the params after it, the params' checksum after
    the last step, ms per step (CUDA events on the card, wall on the
    CPU) and the gradient bytes reduced per step."""
    trainer = build_trainer(case, device)
    rank, world = dist.rank(), dist.world_size()
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in dist.batch_block(case["batch"], rank, world).items()}
    batch["geo"] = {c: {k: torch.as_tensor(v).to(device) for k, v in g.items()}
                    for c, g in case["geo"].items()}
    draws = _draws_to(case["draws"], device)
    on_card = torch.device(device).type == "cuda"
    out, ms = {}, []
    for i in range(steps):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        loss, gnorm = trainer.train_step(batch, case["step"] + i, draws=draws)
        if on_card:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            keys = sorted(loss)
            terms = dist.all_reduce_sum_(torch.stack([loss[k] for k in keys]))
            out["loss"] = dict(zip(keys, terms.tolist()))
            out["gnorm"] = float(gnorm)
            out["grads"] = {n: p.grad.detach().cpu().numpy().copy()
                            for n, p in trainer.model.named_parameters()}
            out["new"] = {n: p.detach().cpu().numpy().copy()
                          for n, p in trainer.model.named_parameters()}
            out["lrs"] = {n: trainer.learning_rate(case["step"]) *
                          (10.0 if trainer.labels[n] == "explicit" else 1.0)
                          for n in out["new"]}
    out["checksum"] = dist.checksum(list(trainer.model.parameters()))
    out["ms"] = ms
    out["grad_bytes"] = trainer.grad_bytes_reduced
    return out


def _rank_main(rank, case_path, init, world, device, backend, local_rank, steps, out_path):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    else:  # fp32 products in full precision, as train.py sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = dist.init_distributed(device, init, world, rank, local_rank, backend=backend)
    try:
        res = run_case(load_case(case_path), dev, steps)
        if rank != 0:  # the others return their checksum alone
            res = {"checksum": res["checksum"], "ms": res["ms"]}
        torch.save(res, f"{out_path}.{rank}")
    finally:
        dist.shutdown()


def run_sharded(case_path: str, world: int, device: str = "cpu", backend: Optional[str] = None,
                steps: int = 1, share_card: bool = False) -> Dict:
    """The case over `world` ranks, each in a process started here. Returns
    rank 0's run_case result with "checksums" (every rank's) and
    "ms_by_rank". share_card: every rank on cuda:0 (with gloo)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        init = f"tcp://localhost:{dist.free_port()}"
        local = 0 if share_card else None
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(case_path, init, world, device, backend, local, steps, out))
        results = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    res = results[0]
    res["checksums"] = [r["checksum"] for r in results]
    res["ms_by_rank"] = [r["ms"] for r in results]
    return res


def term_bound(s: float, npix: int) -> float:
    """A loss term's allowance: 2e-4 relative and one flip of its nonzero
    count (which moves a nonzero-mean term by at most |s| / npix), as
    tests/test_sharding.py allows the JAX package's sharded step."""
    return 2e-4 * abs(s) + abs(s) / npix + 1e-9


def adam_first_step(g: np.ndarray, lr: float, eps: float = 1e-8) -> np.ndarray:
    """AdamW's first update from fresh moments, without the decay:
    lr * g / (|g| + eps)."""
    g = g.astype(np.float64)
    return lr * g / (np.abs(g) + eps)


GRAD_RTOL, NORM_RTOL, UPDATE_RTOL = 1e-2, 1e-3, 1e-4  # compare's bounds


def compare(one: Dict, sharded: Dict, npix: int) -> Dict:
    """Hold a sharded run against the one-process run; returns the worst
    ratio of each check to its bound (<= 1 passes) and the failures.

    - loss terms: term_bound;
    - the whole gradient: ||d||_2 <= NORM_RTOL * ||g||_2;
    - each gradient leaf: max |d| <= GRAD_RTOL * max |g| + 1e-8. Between
      the two steps the products round differently (the batch's shapes
      differ), and a ReLU unit of a field MLP within rounding of 0 at one
      of the samples can take the other side; at the positional
      encoding's highest frequency that sample's gradient is large
      against the row's sum, which moves the leaves upstream of the
      sample points (cameras, warp, the fields' first layers) by up to
      about 1% of their largest element. A term that used its count-flip
      allowance (off by more than 2e-4 relative) scales its part of the
      gradient by up to 1/npix: each such term widens every leaf's bound
      by max |g| / npix;
    - the AdamW update: the sharded params minus the one-process params
      equal the difference of AdamW's first steps on the two gradients
      (adam_first_step; the one-process step's minus the sharded one's:
      an update is subtracted) within UPDATE_RTOL of the learning rate plus 8
      ulps of the param: each rank applies the one-process update to the
      ranks' summed gradient;
    - the ranks' param checksums after the last step: equal."""
    fails, worst = [], {"loss": 0.0, "grad_norm": 0.0, "grads": 0.0, "update": 0.0}
    flips = 0
    for k, s in one["loss"].items():
        d = abs(sharded["loss"][k] - s)
        r = d / term_bound(s, npix)
        worst["loss"] = max(worst["loss"], r)
        flips += d > 2e-4 * abs(s) + 1e-9
        if r > 1:
            fails.append(f"loss {k}: {sharded['loss'][k]} vs {s}")
    sq_d = sq_g = 0.0
    for n, g in one["grads"].items():
        d = sharded["grads"][n].astype(np.float64) - g
        sq_d, sq_g = sq_d + float((d * d).sum()), sq_g + float((g.astype(np.float64) ** 2).sum())
        gmax = float(np.abs(g).max())
        r = float(np.abs(d).max()) / (GRAD_RTOL * gmax + 1e-8 + flips * gmax / npix)
        worst["grads"] = max(worst["grads"], r)
        if r > 1:
            fails.append(f"grad {n}: {r:.3f} of the bound")
        lr = one["lrs"][n]
        want = adam_first_step(g, lr) - adam_first_step(sharded["grads"][n], lr)
        have = sharded["new"][n].astype(np.float64) - one["new"][n]
        bound = UPDATE_RTOL * lr + 8 * np.spacing(np.abs(one["new"][n])).astype(np.float64)
        r = float((np.abs(have - want) / bound).max())
        worst["update"] = max(worst["update"], r)
        if r > 1:
            fails.append(f"update {n}: {r:.3f} of the bound")
    worst["grad_norm"] = float(np.sqrt(sq_d) / (NORM_RTOL * np.sqrt(sq_g)))
    if worst["grad_norm"] > 1:
        fails.append(f"gradient norm of the difference: {worst['grad_norm']:.3f} of the bound")
    cs = sharded.get("checksums", [])
    if any(c != cs[0] for c in cs):
        fails.append(f"rank checksums differ: {cs}")
    return {"worst": worst, "flips": int(flips), "fails": fails}
