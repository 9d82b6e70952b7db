"""The render loop of a cell: the program's render CLI path, one frame per
call of render.render_batch, through the scene's frames in the reference
view, closed loop (the next frame is issued when the last one returned).

Set-up draws the run's weights (benchmark/weights.py), builds the
program's model and the CLI's reference-view batch (construct_batch_from_opts),
and warms up on the traffic's first frames. The window renders frames
until --seconds have passed and keeps a sample of them drawn from the seed
(a reservoir, uniform over every frame of the window); the check renders
the sampled frames again with the reference and compares every channel.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, limits, scene, spans, weights
from benchmark.reference import geometry as ref_geometry
from benchmark.reference import model as ref_model
from benchmark.reference import render as ref_render
from benchmark.reference.precision import fp32_exact


def priors_of(run, params):
    n = params["num_frames"]
    return {"num_frames": n, "intrinsics": np.tile(params["K"], (n, 1)).astype(np.float32),
            "rtmat": scene.orbit(params).astype(np.float32), "train_res": run.traffic["res"]}


def geo_state():
    _, bounds, corners = ref_geometry.proxy_sphere()
    return {"fg": {"aabb": bounds.astype(np.float32), "corners": corners.astype(np.float32)}}


def _plant(model, faults):
    """Faults in the timed path, for the tests of the check."""
    if not faults:
        return
    evaluate = model.evaluate_rays

    def faulty(samples, *a, **k):
        out = dict(evaluate(samples, *a, **k))
        if "answer_altered" in faults:
            out["rgb"] = out["rgb"] + 0.05
        if "half_batch" in faults:
            for key, v in out.items():
                if v.ndim >= 3:
                    v = v.clone()
                    half = v.shape[1] // 2
                    v[:, half:] = v[:, :half][:, : v.shape[1] - half]
                    out[key] = v
        return out

    model.evaluate_rays = faulty


def setup(run, faults=()):
    from lab4d_tpu_torch.engine.model import DVRModel
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo
    from lab4d_tpu_torch.render import construct_batch_from_opts

    tr, cfg = run.traffic, run.cfg
    marks = [("start", time.perf_counter())]
    params = scene.scene_params(run.seed, tr["frames"], tr["res"])
    priors = priors_of(run, params)
    state = weights.make_state(cfg, priors, run.seed, run.device)
    marks.append(("scene and weights", time.perf_counter()))
    fi = FrameInfo.single_video(priors["num_frames"])
    model = DVRModel(fi, field_type=cfg["field_type"], fg_motion=cfg["fg_motion"], num_inst=1,
                     device=run.device, generator=torch.Generator().manual_seed(0),
                     intrinsics_init=priors["intrinsics"], rtmat_fg=priors["rtmat"],
                     rtmat_bg=priors["rtmat"], train_res=tr["res"])
    model.load_state_dict(state)
    model.eval().requires_grad_(False)
    _plant(model, faults)
    geo = geo_state()
    data_info = {"raw_size": np.array([[tr["res"], tr["res"]]]), "frame_info": fi}
    opts = {"inst_id": 0, "render_res": tr["render_res"], "viewpoint": "ref", "freeze_id": -1,
            "num_frames": -1, "noskip": False}
    batch, _ = construct_batch_from_opts(opts, model, geo, data_info, run.device)
    n = len(batch["frameid_sub"])
    subs = [{k: v[i : i + 1] for k, v in batch.items()} for i in range(n)]
    marks.append(("model and batch", time.perf_counter()))
    st = {"model": model, "geo": geo, "subs": subs, "frames": 0, "failed": 0,
          "rng": np.random.default_rng(run.seed), "sample": [],
          "check": {"state": state, "priors": priors, "geo": geo}}
    for i in range(tr["warm_frames"]):
        render_one(run, st, i % n)
    marks.append(("warm-up", time.perf_counter()))
    spans.print_marks(marks)
    return st


def render_one(run, st, i):
    from lab4d_tpu_torch import render

    tr = run.traffic
    return render.render_batch(st["model"], st["subs"][i], st["geo"], chunk=tr.get("chunk"),
                               topk=tr["topk"])


def window(run, state, units=None):
    """Frames until --seconds have passed (units: that many frames)."""
    n, k = len(state["subs"]), run.traffic["check_frames"]
    rng, sample = state["rng"], state["sample"]
    t0 = time.perf_counter()
    frames = 0
    while True:
        i = frames % n
        out = render_one(run, state, i)
        if not all(np.isfinite(v).all() for v in out.values()):
            state["failed"] += 1
        # reservoir sampling: a uniform sample of every frame of the window
        if len(sample) < k:
            sample.append((frames, i, out))
        else:
            j = int(rng.integers(0, frames + 1))
            if j < k:
                sample[j] = (frames, i, out)
        frames += 1
        if (units is not None and frames >= units) or (
                units is None and time.perf_counter() - t0 >= run.seconds):
            break
    elapsed = time.perf_counter() - t0
    state["frames"] = frames
    return {"elapsed": elapsed, "frames": frames}


def segment(run, state):
    n = len(state["subs"])
    for i in range(run.traffic["trace_units"]):
        render_one(run, state, i % n)


def counts(run, state):
    return {"attempted": state["frames"], "failed": state["failed"]}


def release(run, state):
    run.check_inputs = dict(state["check"],
                            sample=[(w, i, {k: v[0] for k, v in out.items()})
                                    for w, i, out in state["sample"]])
    state.pop("model")
    state.pop("subs")


def reference(run, lowered=False):
    """The reference's frames of the sample, {"frames": [...]}, and the
    program's; `lowered`: in the control's precision."""
    from benchmark.reference.precision import lowered as lowered_ctx

    ci, tr = run.check_inputs, run.traffic
    fp32_exact()
    model = ref_model.build(run.cfg, ci["priors"], run.device)
    model.load_state_dict(ci["state"])
    model.eval().requires_grad_(False)
    batch = ref_render.ref_view_batch(model, (tr["res"], tr["res"]), tr["render_res"], run.device)
    want = []
    for _, i, _ in ci["sample"]:
        if lowered:
            with lowered_ctx(run.device):
                want.append(ref_render.render_frame(model, batch, ci["geo"], i, tr["ref_chunk"],
                                                    topk=tr["topk"]))
        else:
            want.append(ref_render.render_frame(model, batch, ci["geo"], i, tr["ref_chunk"],
                                                topk=tr["topk"]))
    return want


def numbers(run):
    """(the program's numbers against the reference, the reference's frames)."""
    want = reference(run)
    got = [out for _, _, out in run.check_inputs["sample"]]
    out = compare.frame_numbers(got, want)
    print(f"[check] frames {[(w, i) for w, i, _ in run.check_inputs['sample']]}, worst p99 by "
          f"channel {out.get('_by_channel')}", flush=True)
    return out, want


def control_numbers(run, want):
    """The control's numbers: the reference's frames in TF32 against the reference's."""
    return compare.frame_numbers(reference(run, lowered=True), want)


def check(run):
    return limits.checks(run.cell["name"], numbers(run)[0], run.root)
