"""Where the time of a training step goes, on one CUDA device.

    python3 -m lab4d_tpu_torch.tools.profile_train [--field_type {bg,fg,comp}]
        [--fg_motion MOTION] [--nosingle_inst] [--load_path CKPT] [--steps N]
        [--out FILE] [--turns DIR]

Run from the root of a checkout. It writes the synthetic scene of
chip_smoke.py (one orbit video, 32 frames at 64^2), builds the trainer of
`python -m lab4d_tpu_torch.train --field_type bg` (with --field_type fg
the flagship `--field_type fg --fg_motion skel-quad`, with comp
`--field_type comp --fg_motion comp_skel-human_dense`; --fg_motion picks
another warp: dense, nvp, bob, skel-human, comp_skel-quad_dense, ...) at
full width (128 images x 2 frames x 16 pixels x 64 samples = 262,144
points per field and step; the prior fits are cut to 50 geometry steps).
`--nosingle_inst`: chip_smoke.py's category model instead, `--field_type
fg --fg_motion comp_skel-human_dense --nosingle_inst` (one instance code
per video) on its category scene (8 videos of 16 frames at 64^2, each
video's sphere its own size). `--load_path CKPT`: the trainer starts from
that checkpoint (a transfer, or the same model resumed). Then:

1. times `--steps` training steps on batches drawn beforehand, so that no
   data loading overlaps them: ms/step from CUDA events (median), and
   the same steps' host time;
2. times `--steps` steps of `train_one_round`, with the threaded batch
   loader running as in training;
3. times one batch of the loader on its own, in this process;
4. traces `--trace` steps (pre-drawn batches) with torch.profiler and
   prints, per op, the device time of the kernels it launched itself and
   their share of the summed kernel time, the kernels K1/K2/K3f/K3b/K4f/K4b
   by name (K1 and K2 by each of their kernels) and K3's share of the
   step (its rm_* kernels), then that sum, the steps' wall time and the
   peak device memory of the steps. The device's idle share is the
   benchmark's (idle_share.train: the union of busy intervals).

`--out` also writes the profiler's full table to FILE.

`--loader`: the loader against the steps, in turns, in one process: for
the bg and the fg (skel-quad) trainers, `--steps` steps on batches drawn
beforehand and `--steps` steps of train_one_round with the threaded
loader, in the order pre-drawn, loader, loader, pre-drawn (ms/step from
CUDA events, median, and wall ms/step); then one batch of the flagship
loader (128 pairs x 16 px) through the native sampler and through its
numpy reference, in turns (native, reference, reference, native), 10
batches each (ms per batch, median, in this process, one thread).

`--turns DIR`: runs this tool (without --turns) on the package of the
checkout DIR and on this one in turns, each in a process of its own: DIR,
this, this, DIR. The scene is written once, here, and every turn runs
this file's code (so that a checkout without --nosingle_inst is measured
on the same category step; its trainer draws no code swap). Each run ends
with the peak device memory its process allocated
(torch.cuda.max_memory_allocated), printed by the runner.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

# runs the profile_train file argv[2] on the package of the checkout
# argv[1] with the arguments after them, then prints the process's peak
# device memory
_RUNNER = """
import os, runpy, sys
root, tool = sys.argv[1], sys.argv[2]
os.chdir(root)
sys.path.insert(0, root)
sys.argv = ["profile_train", "--checkout", root] + sys.argv[3:]
import torch
runpy.run_path(tool, run_name="__main__")
print(f"[memory] peak device memory of the run: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
"""
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the category model's training flags (chip_smoke.py's TRAIN_OPTS["category"])
CATEGORY_ARGV = ["--field_type", "fg", "--fg_motion", "comp_skel-human_dense", "--no-single_inst",
                 "--seqname", "cate", "--logname", "category", "--train_res", "64",
                 "--num_workers", "4"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--field_type", choices=("bg", "fg", "comp"), default="bg")
    parser.add_argument("--fg_motion", default=None,
                        help="the fg warp (default: skel-quad for fg, comp_skel-human_dense "
                             "for comp and the category model)")
    parser.add_argument("--nosingle_inst", action="store_true",
                        help="the multi-video category model on the category scene")
    parser.add_argument("--load_path", default="", help="checkpoint the trainer starts from")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--trace", type=int, default=3)
    parser.add_argument("--top", type=int, default=18)
    parser.add_argument("--out", default=None)
    parser.add_argument("--turns", default=None, help="root of another checkout to run in turns")
    parser.add_argument("--loader", action="store_true",
                        help="the loader against pre-drawn batches, bg and fg, in turns")
    parser.add_argument("--scene", default=None, help=argparse.SUPPRESS)  # a written database
    parser.add_argument("--checkout", default=ROOT, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    sys.path.insert(0, args.checkout)
    import chip_smoke

    if args.turns:
        rest = list(argv if argv is not None else sys.argv[1:])
        i = rest.index("--turns")
        rest = rest[:i] + rest[i + 2:]
        with tempfile.TemporaryDirectory() as tmp:
            db = _write_scene(chip_smoke, args, tmp)
            for n, (tag, root) in enumerate((("parent", args.turns), ("this", ROOT),
                                             ("this", ROOT), ("parent", args.turns))):
                run = subprocess.run([sys.executable, "-c", _RUNNER, os.path.abspath(root),
                                      os.path.abspath(__file__), *rest, "--scene", db],
                                     capture_output=True, text=True)
                for line in (run.stdout + (run.stderr if run.returncode else "")).splitlines():
                    print(f"[turn {n + 1} {tag}] {line}")
                if run.returncode:
                    sys.exit(f"profile_train: the {tag} run failed ({run.returncode})")
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_train: no CUDA device")
    card = chip_smoke.phase_env()
    with tempfile.TemporaryDirectory() as root:
        db = args.scene or _write_scene(chip_smoke, args, root)
        if args.loader:
            _loader_turns(args, card, db, root)
        else:
            _profile(args, card, db, root)


def _write_scene(chip_smoke, args, root):
    """chip_smoke.py's scene (one orbit video), or its category scene."""
    db = chip_smoke.write_scene(root)
    if args.nosingle_inst:
        chip_smoke.write_category_scene(db)
    return db


def _trainer(args, db, root, field_type, n_batches):
    """The trainer of the profiled step and n_batches of its batches on the
    device, drawn beforehand."""
    import torch

    import chip_smoke
    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.train import get_parser

    motion = [] if args.fg_motion is None else ["--fg_motion", args.fg_motion]
    base = CATEGORY_ARGV if args.nosingle_inst else chip_smoke.TRAIN_OPTS[field_type]
    load = ["--load_path", args.load_path] if args.load_path else []
    opts = vars(get_parser().parse_args(base + motion + load + [
        "--geo_init_steps", "50", "--num_rounds", "1", "--iters_per_round", str(args.steps),
        "--database_root", db, "--logroot", os.path.join(root, "logdir")]))
    trainer = Trainer(opts)
    geo = trainer.geo_for_batch()
    batches = []
    for _ in range(n_batches):
        b = trainer.batch_to_device(trainer.trainloader.next_batch())
        b["geo"] = geo
        batches.append(b)
    trainer.trainloader.stop()
    torch.cuda.synchronize()
    return trainer, opts, batches


def _predrawn_steps(trainer, batches, step):
    """CUDA-event ms of a training step on each of `batches`."""
    import torch

    events = []
    for b in batches:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        trainer.train_step(b, step)
        e.record()
        events.append((s, e))
        step += 1
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def _loader_turns(args, card, db, root):
    import numpy as np

    import chip_smoke

    for field_type in ("bg", "fg"):
        trainer, opts, batches = _trainer(args, db, root, field_type, args.steps + 2)
        try:
            _predrawn_steps(trainer, batches[:2], 0)  # warm-up
            for turn, kind in enumerate(("pre-drawn", "loader", "loader", "pre-drawn")):
                if kind == "pre-drawn":
                    t = time.perf_counter()
                    ms = _predrawn_steps(trainer, batches[2:], trainer.current_steps)
                    wall = (time.perf_counter() - t) * 1e3 / len(ms)
                else:
                    trainer.trainloader.start()
                    trainer.step_ms = []
                    t = time.perf_counter()
                    trainer.train_one_round(0)
                    wall = (time.perf_counter() - t) * 1e3 / args.steps
                    trainer.trainloader.stop()
                    ms = trainer.step_ms[1:]
                print(f"[loader-turns] {field_type} turn {turn + 1} {kind}: {np.median(ms):.2f} "
                      f"ms/step (CUDA events, median of {len(ms)}), {wall:.2f} ms/step wall")
        finally:
            trainer.close()
    for turn, gather in enumerate(("native", "reference", "reference", "native")):
        loader = chip_smoke._seeded_loader(db, gather)
        rng = np.random.default_rng(0)
        loader._make_batch(rng)
        times = []
        for _ in range(10):
            t = time.perf_counter()
            loader._make_batch(rng)
            times.append((time.perf_counter() - t) * 1e3)
        print(f"[loader-turns] batch of {chip_smoke.LOADER_PAIRS} pairs x {chip_smoke.LOADER_PIXELS} "
              f"px, turn {turn + 1} {gather}: {np.median(times):.3f} ms (median of 10; min "
              f"{min(times):.3f}), one thread")
    print(card)


def _profile(args, card, db, root):
    trainer, opts, batches = _trainer(args, db, root, args.field_type, args.steps + args.trace)
    try:
        _measure(args, card, trainer, batches, opts)
    finally:
        trainer.close()


def _measure(args, card, trainer, batches, opts):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # 1. pre-drawn batches
    step = 0
    for b in batches[:2]:  # warm-up: allocator pools, cuBLAS handles
        trainer.train_step(b, step)
        step += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, host = [], []
    for b in batches[2 : args.steps]:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        s.record()
        trainer.train_step(b, step)
        e.record()
        host.append((time.perf_counter() - t) * 1e3)
        events.append((s, e))
        step += 1
    torch.cuda.synchronize()
    dev = [s.elapsed_time(e) for s, e in events]
    print(f"[steps] pre-drawn batches: {np.median(dev):.2f} ms/step (median of {len(dev)}; "
          f"min {min(dev):.2f}, max {max(dev):.2f}); host issue time {np.median(host):.2f} ms/step; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # 2. the training loop with the threaded loader
    trainer.trainloader.start()
    trainer.step_ms = []
    t = time.perf_counter()
    trainer.train_one_round(0)
    wall = (time.perf_counter() - t) * 1e3 / args.steps
    trainer.trainloader.stop()
    print(f"[steps] train_one_round with the loader: {np.median(trainer.step_ms[1:]):.2f} ms/step "
          f"(median after the first), {wall:.2f} ms/step wall")

    # 3. the loader alone
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    for _ in range(3):
        trainer.trainloader._make_batch(rng)
    print(f"[loader] one batch of {opts['imgs_per_gpu']} pairs: "
          f"{(time.perf_counter() - t) / 3 * 1e3:.1f} ms in this process (one thread)")

    # 4. trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches[args.steps : args.steps + args.trace]:
            trainer.train_step(b, step)
            step += 1
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    what = opts["field_type"] + ("" if opts["field_type"] == "bg" else f" / {opts['fg_motion']}")
    if not opts["single_inst"]:
        what += f", {trainer.model.fields.field_params['fg'].num_inst} instance codes"
    print(f"[trace] {what}, {args.trace} steps: summed kernel time {device_ms:.2f} ms, "
          f"{traced:.2f} ms wall (traced)")
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[: args.top]:
        ms = e.self_device_time_total / 1e3
        print(f"[op] {e.key}: {ms / args.trace:.2f} ms/step device, "
              f"{100 * ms / device_ms:.1f}%, {e.count // args.trace} calls/step")
    # nh_* are K1 (nh_pack_kernel, nh_fwd_kernel) and K2 (nh_pack_kernel,
    # nh_din_kernel, nh_dw_kernel, nh_reduce_kernel); pm_* are K4f
    # (pm_pack_kernel, pm_fwd_kernel) and K4b (pm_pack_kernel,
    # pm_din_kernel, pm_dw_kernel, and hm_reduce_kernel of
    # csrc/heads_mma.cuh, which also sums K3b's chunks past 512 rows); rm_*
    # are K3f (rm_fwd_kernel) and K3b (rm_din_kernel, rm_dw_rows_kernel,
    # rm_dw_kernel)
    for name in ("nh_pack_kernel", "nh_fwd_kernel", "nh_din_kernel", "nh_dw_kernel", "nh_reduce_kernel",
                 "rm_fwd_kernel", "rm_din_kernel", "rm_dw_rows_kernel", "rm_dw_kernel",
                 "pm_pack_kernel", "pm_fwd_kernel", "pm_din_kernel", "pm_dw_kernel",
                 "hm_reduce_kernel"):
        ks = [e.device_time for e in kernels if name in e.name]
        print(f"[kernel] {name}: {sum(ks) / 1e3 / args.trace:.2f} ms/step device, "
              f"{100 * sum(ks) / 1e3 / device_ms:.1f}%, {len(ks) // args.trace} calls/step")
    heads = sum(e.device_time for e in kernels if re.search(r"(^|[\s:])nh_\w*kernel", e.name))
    print(f"[kernel] K1 + K2 (nh_*): {heads / 1e3 / args.trace:.2f} ms/step device, "
          f"{100 * heads / 1e3 / device_ms:.1f}% of the step")
    # (pe_mlp_fwd_kernel and hm_dw_kernel: the names of the mma.sync K4,
    # for an older checkout in --turns)
    k4 = sum(e.device_time for e in kernels
             if re.search(r"(^|[\s:])(pm_\w*kernel|pe_mlp_fwd_kernel|hm_dw_kernel)", e.name))
    print(f"[kernel] K4f + K4b (pm_*; K4b's chunk sum is in hm_reduce_kernel): "
          f"{k4 / 1e3 / args.trace:.2f} ms/step device, {100 * k4 / 1e3 / device_ms:.1f}% of the step")
    k3 = sum(e.device_time for e in kernels if re.search(r"(^|[\s:])rm_\w*kernel", e.name))
    print(f"[kernel] K3f + K3b (rm_*; K3b's chunk sum past 1,024 rows is in hm_reduce_kernel): "
          f"{k3 / 1e3 / args.trace:.2f} ms/step device, "
          f"{100 * k3 / 1e3 / device_ms:.1f}% of the step")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=120))
    print(card)


if __name__ == "__main__":
    main()
