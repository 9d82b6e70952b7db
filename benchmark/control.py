"""The readings that a cell's limits are set from, in one process:

- the program against the reference on each of --seeds (the lower
  readings), through the cell's own set-up and timed path (training: the
  checked steps of set-up; frames: the first check_frames frames of a
  window);
- the control, the reference in TF32 against the reference, on the first
  --control_seeds of them (the upper readings);
- with --faults, the program with each fault planted (benchmark/loops/),
  on the first --control_seeds seeds.

    python3 benchmark/control.py --workload dense.train --seeds 1,2,3 \\
        --control_seeds 3 [--faults half_batch] --out readings.json

Runs on the card (the tests call `readings` on the CPU at a test's size).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean(d):
    return {k: float(v) for k, v in d.items() if not k.startswith("_")}


def readings(workload, seeds, control_seeds=3, faults=(), device="cuda", overrides=None,
             log=print):
    import torch

    from benchmark import run as run_mod
    from benchmark.spans import load_file

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, _, cfg, traffic = run_mod.load_cell(bench, workload)
    traffic = dict(traffic, **(overrides or {}))
    loop = load_file(os.path.join(ROOT, "benchmark", "loops", f"{traffic['loop']}.py"),
                     f"bench_loop_{traffic['loop']}")
    dev = torch.device(device)
    out = {"workload": workload, "program": {}, "control": {}, "faults": {}}

    def one(seed, fault=()):
        run = run_mod.Run(cell, cfg, traffic, seed, 0.0, 0, dev)
        state = loop.setup(run, faults=fault)
        loop.window(run, state, units=traffic.get("check_frames", 1))
        loop.release(run, state)
        del state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return run

    for k, seed in enumerate(seeds):
        t = time.time()
        run = one(seed)
        nums, ref = loop.numbers(run)
        out["program"][str(seed)] = _clean(nums)
        if k < control_seeds:
            out["control"][str(seed)] = _clean(loop.control_numbers(run, ref))
        log(f"[control] seed {seed}: program {out['program'][str(seed)]} control "
            f"{out['control'].get(str(seed))} ({time.time() - t:.1f} s)")
        del run, ref
        for fault in faults:
            if k >= control_seeds:
                continue
            frun = one(seed, (fault,))
            out["faults"].setdefault(fault, {})[str(seed)] = _clean(loop.numbers(frun)[0])
            log(f"[control] seed {seed} fault {fault}: {out['faults'][fault][str(seed)]}")
            del frun
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control_seeds", type=int, default=3)
    p.add_argument("--faults", default="", help="comma-separated fault names")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.run import cache_env

    cache_env()
    with contextlib.redirect_stdout(sys.stderr):
        out = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                       args.control_seeds, tuple(f for f in args.faults.split(",") if f))
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
