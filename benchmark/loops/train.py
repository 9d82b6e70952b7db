"""The training loop of a cell: the program's Trainer, the window driving
Trainer.train_one_round in chunks of the traffic's iters_per_round steps.

Set-up writes the seeded scene, builds the trainer with its threaded
loader and the run's weights (benchmark/weights.py, in place of the prior
fits), and drives the first `check_steps` steps one per call of
train_one_round, keeping the loader's batches, the gradient AdamW got at
the first step (its first moment over 1 - b1) and the parameters after
the last; then one chunk to warm up. The window runs whole chunks until
--seconds have passed, and its rate is the rays of all its steps over its
time, which ends in a synchronise. The check has the reference follow the
same steps from the same weights on the same batches.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import compare, limits, scene, spans, weights
from benchmark.reference import geometry as ref_geometry
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.precision import fp32_exact

ADAM_B1 = 0.9


def trainer_argv(run, db, logroot):
    cfg, tr = run.cfg, run.traffic
    argv = ["--field_type", cfg["field_type"], "--fg_motion", cfg["fg_motion"],
            "--seqname", "bench", "--logname", "run", "--database_root", db,
            "--logroot", logroot, "--train_res", str(tr["res"]),
            "--imgs_per_gpu", str(tr["imgs_per_gpu"]),
            "--pixels_per_image", str(tr["pixels_per_image"]),
            "--num_rounds", str(tr["num_rounds"]),
            "--iters_per_round", str(tr["schedule_iters_per_round"]),
            "--learning_rate", str(tr["learning_rate"]), "--device", str(run.device)]
    if tr.get("num_workers") is not None:
        argv += ["--num_workers", str(tr["num_workers"])]
    for k, v in cfg["loss_weights"].items():
        argv += [f"--{k}", repr(float(v))]
    return argv


def priors_of(run, params):
    n = params["num_frames"]
    return {"num_frames": n, "intrinsics": np.tile(params["K"], (n, 1)).astype(np.float32),
            "rtmat": scene.orbit(params).astype(np.float32), "train_res": run.traffic["res"]}


def setup(run, faults=()):
    from lab4d_tpu_torch import train as program_train
    from lab4d_tpu_torch.engine.trainer import Trainer
    from lab4d_tpu_torch.flagfile import parse_opts

    tr = run.traffic
    marks = [("start", time.perf_counter())]
    tmp = tempfile.mkdtemp(prefix="lab4d-bench-")
    params = scene.scene_params(run.seed, tr["frames"], tr["res"])
    db = scene.write_scene(os.path.join(tmp, "database"), "bench", params)
    priors = priors_of(run, params)
    marks.append(("scene", time.perf_counter()))
    state = weights.make_state(run.cfg, priors, run.seed, run.device)
    marks.append(("weights", time.perf_counter()))
    opts = parse_opts(program_train.get_parser(), trainer_argv(run, db, os.path.join(tmp, "logdir")))

    class BenchTrainer(Trainer):
        def mlp_init(self):  # the run's weights in place of the prior fits
            self.model.load_state_dict(state)

    trainer = BenchTrainer(opts)
    # the loader's draws from the run's seed: its pair stream (the loader's
    # seed) and worker 0's pixel and delta draws, which the datasets take
    # from the OS unless given a stream (views with draws of their own)
    loader = trainer.trainloader
    loader.rng = np.random.default_rng(run.seed)
    draw_seeds = np.random.SeedSequence(run.seed).generate_state(len(loader.datasets))
    loader.datasets = [ds.with_draws(int(s)) for ds, s in zip(loader.datasets, draw_seeds)]
    marks.append(("trainer", time.perf_counter()))
    fi = trainer.data_info["frame_info"]
    if not np.array_equal(fi.frame_mapping, np.arange(priors["num_frames"])):
        raise RuntimeError(f"the loader's frames {fi.frame_mapping} are not the scene's")
    if "state_unchanged" in faults:
        trainer.optimizer.step = lambda *a, **k: None
    if "half_batch" in faults:
        to_device = trainer.batch_to_device
        trainer.batch_to_device = lambda b: to_device(
            {k: v[: max(1, len(v) // 2)] for k, v in b.items()})

    # the checked steps, one per call of the window's own entry
    batches = []
    loader_next = trainer.trainloader.next_batch

    def keep(*a, **k):
        b = loader_next(*a, **k)
        batches.append({key: np.array(v, copy=True) for key, v in b.items()})
        return b

    trainer.trainloader.next_batch = keep
    named = dict(trainer.model.named_parameters())
    grad0 = None
    for step in range(tr["check_steps"]):
        trainer.opts["iters_per_round"] = 1
        trainer.train_one_round(step)
        if step == 0:
            # the gradient AdamW got: its first moment after one update over 1 - b1
            opt_state = trainer.optimizer.state
            grad0 = {n: (opt_state[p]["exp_avg"].detach() / (1 - ADAM_B1)
                         if "exp_avg" in opt_state.get(p, {}) else torch.zeros_like(p))
                     for n, p in named.items()}
    del trainer.trainloader.next_batch  # the class's method again
    prog = {
        "losses": [rec["total"] for rec in trainer.losses[: tr["check_steps"]]],
        "grad0": grad0,
        "change": {n: p.detach() - state[n] for n, p in named.items()},
    }
    marks.append(("checked steps", time.perf_counter()))
    trainer.opts["iters_per_round"] = tr["iters_per_round"]
    trainer.train_one_round(tr["check_steps"])  # warm-up: one whole chunk
    _sync(run)
    marks.append(("warm-up", time.perf_counter()))
    spans.print_marks(marks)
    return {"trainer": trainer, "tmp": tmp, "round": tr["check_steps"] + 1,
            "check": {"state": state, "batches": batches, "prog": prog, "priors": priors}}


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def window(run, state, units=None):
    """Whole chunks until --seconds have passed (units: that many chunks)."""
    trainer = state["trainer"]
    first = trainer.current_steps
    first_ms = len(trainer.step_ms)
    state["round_window"] = state["round"]
    _sync(run)
    t0 = time.perf_counter()
    while True:
        trainer.train_one_round(state["round"])
        state["round"] += 1
        done = state["round"] - state["round_window"]
        if (units is not None and done >= units) or (
                units is None and time.perf_counter() - t0 >= run.seconds):
            break
    _sync(run)
    elapsed = time.perf_counter() - t0
    steps = trainer.current_steps - first
    rays = steps * run.traffic["imgs_per_gpu"] * 2 * run.traffic["pixels_per_image"]
    run.counters["step_ms"] = list(trainer.step_ms[first_ms:])
    state["window_steps"] = (first, trainer.current_steps)
    return {"elapsed": elapsed, "steps": steps, "rays": rays}


def segment(run, state):
    trainer = state["trainer"]
    trainer.opts["iters_per_round"] = run.traffic["trace_units"]
    trainer.train_one_round(state["round"])
    state["round"] += 1
    trainer.opts["iters_per_round"] = run.traffic["iters_per_round"]


def counts(run, state):
    a, b = state["window_steps"]
    totals = [rec["total"] for rec in state["trainer"].losses[a:b]]
    return {"attempted": len(totals), "failed": int(sum(not np.isfinite(t) for t in totals))}


def release(run, state):
    trainer = state.pop("trainer")
    trainer.close()
    run.check_inputs = state["check"]
    shutil.rmtree(state["tmp"], ignore_errors=True)
    del trainer


def reference(run, lowered=False):
    """The reference's readings of the checked steps: losses, first
    gradient, change; `lowered`: in the control's precision."""
    from benchmark.reference.precision import lowered as lowered_ctx

    ci = run.check_inputs
    fp32_exact()
    cfg, tr = run.cfg, run.traffic
    model = ref_model.build(cfg, ci["priors"], run.device,
                            loss_weights=tuple(cfg["loss_weights"].items()))
    model.load_state_dict(ci["state"])
    geo = ref_geometry.geo_tensors(ref_geometry.geo_state(model, model.frame_info), run.device)
    batches = [{k: torch.from_numpy(v).to(run.device) for k, v in b.items()}
               for b in ci["batches"]]
    schedule = {"total_steps": tr["num_rounds"] * tr["schedule_iters_per_round"],
                "peak": tr["learning_rate"], "pct_start": 2.0 / tr["num_rounds"]}
    if lowered:
        with lowered_ctx(run.device):
            out = ref_train.run_steps(model, batches, geo, schedule)
    else:
        out = ref_train.run_steps(model, batches, geo, schedule)
    return {"losses": out["losses"], "grad0": out["grad0"], "gnorm": out["gnorm"],
            "change": {n: out["params"][n] - ci["state"][n] for n in out["params"]}}


def numbers(run):
    """(the program's numbers against the reference, the reference's readings)."""
    ref = reference(run)
    out = compare.train_numbers(run.check_inputs["prog"], ref)
    print(f"[check] losses program {run.check_inputs['prog']['losses']} reference "
          f"{ref['losses']} grad norms {ref['gnorm']}; worst grad leaf {out['_grad_leaf']}, "
          f"worst change leaf {out['_change_leaf']}", flush=True)
    return out, ref


def control_numbers(run, ref):
    """The control's numbers: the reference in TF32 against the reference."""
    return compare.train_numbers(reference(run, lowered=True), ref)


def check(run):
    return limits.checks(run.cell["name"], numbers(run)[0], run.root)
