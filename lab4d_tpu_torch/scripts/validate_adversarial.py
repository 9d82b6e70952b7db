"""Adversarial-scene validation run of the port: the train CLI
(`python -m lab4d_tpu_torch.train`) on the adversarial synthetic scene
(tools/synthetic_adversarial.py: an articulated, fast-moving, textured
object with occlusions and noisy camera priors) at the flagship
configuration (skel-quad, 20 rounds x 200 iterations, 256 px data), with
the arguments of scripts/validate_adversarial.py; prints the same JSON
(final and best PSNR, final SSIM, wall clock).

    python -m lab4d_tpu_torch.scripts.validate_adversarial [--workdir DIR] [--cpu]
        [--rounds N] [--res R] [--frames F] [--fg_motion M] [train flags ...]

The run trains on the card; `--cpu` trains on the CPU at the small
iteration counts of the JAX script's `--cpu`. Flags it does not know go
to the train CLI as they are (e.g. `--iters_per_round 50`).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "adversarial_val"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--fg_motion", default="skel-quad")
    return ap.parse_known_args(argv)


def prepare(args) -> str:
    """The scene under <workdir>/database (written once per res x frames);
    returns its root."""
    from lab4d_tpu_torch.tools.synthetic_adversarial import make_adversarial_dataset

    data_root = f"{args.workdir}/database"
    os.makedirs(args.workdir, exist_ok=True)
    marker = f"{data_root}/.generated-{args.res}-{args.frames}"
    if not os.path.exists(marker):
        print(f"generating adversarial dataset at {args.res}px...", flush=True)
        make_adversarial_dataset(
            data_root,
            num_frames=args.frames,
            res=args.res,
            feat_res=112 if args.res >= 224 else args.res // 4,
        )
        open(marker, "w").close()
    return data_root


def train_argv(args, extra=()) -> list:
    """The train CLI's arguments (those of the JAX script, the database and
    log roots under the workdir)."""
    argv = [
        "--seqname", "adversarial", "--logname", f"val-{args.fg_motion}",
        "--fg_motion", args.fg_motion,
        "--train_res", str(args.res),
        "--num_rounds", str(args.rounds),
        "--database_root", f"{args.workdir}/database",
        "--logroot", f"{args.workdir}/logdir",
    ]
    if args.cpu:
        argv += [
            "--use_cpu", "--iters_per_round", "20", "--imgs_per_gpu", "8",
            "--eval_res", "64",
        ]
    return argv + list(extra)


def summary(args, wall: float) -> dict:
    """The JSON of the JAX script, from the run's metrics.jsonl."""
    metrics = f"{args.workdir}/logdir/adversarial-val-{args.fg_motion}/metrics.jsonl"
    psnrs, ssims = [], []
    with open(metrics) as f:
        for line in f:
            rec = json.loads(line)
            if "eval/psnr" in rec:
                psnrs.append(rec["eval/psnr"])
            if "eval/ssim" in rec:
                ssims.append(rec["eval/ssim"])
    return {
        "scene": "adversarial (articulated+textured+occlusions+noisy cams)",
        "fg_motion": args.fg_motion,
        "rounds": args.rounds,
        "res": args.res,
        "wall_clock_min": round(wall / 60, 2),
        "psnr_first": round(psnrs[0], 2) if psnrs else None,
        "psnr_best": round(max(psnrs), 2) if psnrs else None,
        "psnr_final": round(psnrs[-1], 2) if psnrs else None,
        "ssim_final": round(ssims[-1], 3) if ssims else None,
    }


def main(argv=None) -> dict:
    """Write the scene, train (the train CLI in this process), print and
    return the summary."""
    from lab4d_tpu_torch import train

    args, extra = parse_args(argv)
    prepare(args)
    t0 = time.time()
    train.main(train_argv(args, extra))
    out = summary(args, time.time() - t0)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
