"""Full-length runs of the five preprocessing-net trainers on the card,
beside the shipped weights (database/weights/) evaluated on the same
held-out draws.

    python -m lab4d_tpu_torch.tools.train_nets_report [--nets flow_raft,seg_unet,...]
        [--steps N] [--init_seed S | --init DIR] [--device cpu] [--out train_nets.json]

For each trainer (lab4d_tpu_torch/scripts/train_<net>.py): its main at its
default steps, resolution and batch (--steps cuts them), the weights
written to a temporary directory, never database/weights/; the wall time,
the pool's seconds, ms/step (CUDA events: median and mean), peak device
memory, the logged losses and the held-out metric of the trained net and
of the classical backend; then the shipped weights through the same
held-out function (the same seed, so the same draws). Prints one line per
net and writes the records as JSON. Each trainer starts from flax's init
drawn by make_model from torch seed `--init_seed` (0, as main does), or
from the weights `DIR/<net>.msgpack` (`--init`), e.g. flax's own init
written on the CPU by `python -m tests.test_torch_train_optim DIR [KEY]`.
`--device cpu` runs the trainers on the CPU (no ms/step).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import subprocess
import tempfile
import time

import numpy as np

NETS = {  # trainer: (the weights file's backend module, held-out takes res)
    "flow_raft": ("flow_raft", True),
    "seg_unet": ("seg_unet", True),
    "depth_unet": ("depth_unet", True),
    "feat_net": ("feat_net", False),
    "viewpoint": ("viewpoint_net", False),
}
DEFAULT_RES = 128  # main's default for the nets that take a resolution


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def run_net(name: str, steps=None, init_seed: int = 0, init_dir: str = "",
            device: str = "cuda") -> dict:
    import torch

    mod = importlib.import_module(f"lab4d_tpu_torch.scripts.train_{name}")
    backend, takes_res = NETS[name]
    net = importlib.import_module(f"lab4d_tpu_torch.preprocess.backends.{backend}")
    if init_dir:
        model = net.load_model(path=os.path.join(init_dir, f"{backend}.msgpack"), device=device)
        if model is None:
            raise FileNotFoundError(f"no {backend}.msgpack under {init_dir}")
    else:
        model = mod.make_model(torch.Generator().manual_seed(init_seed))
    kw = {"model": model, "device": device}
    if steps is not None:
        kw["steps"] = steps
    stats, buf = {}, io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        with contextlib.redirect_stdout(buf):
            trained = mod.main(out_path=os.path.join(tmp, f"{backend}.msgpack"), stats=stats, **kw)
        wall = time.time() - t
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    shipped_model = net.load_model(device=device)
    if shipped_model is None:
        raise FileNotFoundError(f"no shipped weights for {backend}")
    args = (DEFAULT_RES,) if takes_res else ()
    with contextlib.redirect_stdout(io.StringIO()):
        shipped = mod.heldout(shipped_model, *args)
    log = buf.getvalue().splitlines()
    return {
        "net": name, "wall_s": wall, "pool_s": stats["pool_s"],
        "steps": stats["logged"][-1][0] + 1,
        "ms_per_step_median": float(np.median(stats["step_ms"])) if stats["step_ms"] else None,
        "ms_per_step_mean": float(np.mean(stats["step_ms"])) if stats["step_ms"] else None,
        "peak_gib": None if peak is None else peak / 2**30, "logged": stats["logged"],
        "heldout_line": next(ln for ln in log if ln.startswith("held-out")),
        "trained": trained, "shipped": shipped,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nets", default=",".join(NETS))
    ap.add_argument("--steps", type=int, default=None, help="cut every trainer to N steps")
    ap.add_argument("--init_seed", type=int, default=0, help="torch seed of make_model's init")
    ap.add_argument("--init", default="", help="start from DIR/<net>.msgpack instead")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from lab4d_tpu_torch.preprocess import resolve_device

    resolve_device(args.device)  # TF32 off on the card
    records = {"card": card() if args.device == "cuda" else "cpu",
               "init": args.init or f"make_model seed {args.init_seed}", "nets": []}
    print(f"card: {records['card']}; init: {records['init']}", flush=True)
    for name in args.nets.split(","):
        rec = run_net(name, args.steps, args.init_seed, args.init, args.device)
        records["nets"].append(rec)
        step = ("" if rec["ms_per_step_median"] is None else
                f"{rec['ms_per_step_median']:.2f} ms/step median ({rec['ms_per_step_mean']:.2f} "
                f"mean), peak {rec['peak_gib']:.3f} GiB, ")
        print(f"[{name}] {rec['steps']} steps, wall {rec['wall_s']:.1f} s (pool "
              f"{rec['pool_s']:.1f} s), {step}loss "
              f"{rec['logged'][0][1]:.4f} -> {rec['logged'][-1][1]:.4f}; {rec['heldout_line']}; "
              f"shipped weights: {rec['shipped']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
