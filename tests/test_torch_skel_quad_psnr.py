"""The flagship model (--fg_motion skel-quad), or the rigid object, trained
by the port and by the JAX package on the CPU at matched steps: the
masked-PSNR trajectory of tools/compare_psnr.py's protocol (the same scene,
flags, step count and seeded loader draws; the two packages draw pixels in
the same order).

    python3 -m tests.test_torch_skel_quad_psnr [--fg_motion skel-quad|rigid]
        [--seeds 0,1,2,3] [--rounds 6] [--frames 32] [--jax_init] [--jax_draws]
        [--out psnr_torch.json]

The rigid protocol at its full settings: `--fg_motion rigid --rounds 20
--frames 81` (20 steps per round at 64^2).

Run from the root of a checkout. Each side starts from its own prior fits,
or with --jax_init the port starts from the JAX side's params and proxy
meshes right after its fits (the JAX trainer's checkpoint), so that the
two trajectories differ only in the steps' arithmetic and random draws.
With --jax_draws the port's steps also take the JAX side's in-step random
draws (the eikonal rays, the global-match candidates, the visibility-decay
and gauss-skin points that JAX derives from fold_in(PRNGKey(42), step)),
recorded from its jitted step through ordered debug callbacks, as the
one-step tests hand the same draws to both packages. Writes
"<motion>_cpu" (or "<motion>_cpu_jax_init", "..._jax_draws"; <motion> is
skel_quad or rigid) into --out: both trajectories per seed, each side's
render before the first step, the per-seed round-0 and final gaps, their
largest gap, and the final gaps' mean and sample std.

The init is held against JAX's: the instance codes' against flax
nn.Embed's, and every parameter leaf's spread at three model kinds. The
comparison test runs at a tiny size for skel-quad and for rigid, one
round on 9 frames at 16^2, from the JAX side's init: the port's first eval render, before any
step, equals the JAX side's to 1e-4 dB in masked PSNR, and both rounds
end finite.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pytest

from lab4d_tpu_torch.tools import compare_psnr as CP


def jax_trainer(db, workdir, seed, rounds, res, iters, frames, extra=(), fg_motion="skel-quad"):
    """The JAX package's Trainer on the protocol's flags, prior fits run and
    saved as ckpt_0000.flax; returns (trainer, checkpoint path)."""
    from lab4d_tpu.config_hier import validate
    from lab4d_tpu.engine.trainer import Trainer
    from lab4d_tpu_torch import flagfile
    from lab4d_tpu_torch.train import get_parser

    logroot = os.path.join(workdir, "logdir_jax")
    argv = CP.train_argv(db, logroot, f"jax{seed}", fg_motion, rounds, res, iters, frames, "cpu")
    opts = flagfile.absl_flags(vars(get_parser().parse_args(argv + list(extra))))
    validate(opts)
    trainer = Trainer(opts)
    trainer.save_checkpoint(round_count=0)
    return trainer, os.path.join(logroot, f"{CP.SEQNAME}-jax{seed}", "ckpt_0000.flax")


def jax_eval_psnr(trainer):
    out, ref = trainer.render_frames(trainer.eval_fid, return_ref=True)
    return CP.masked_psnr(np.asarray(out["rgb"]), ref["rgb"], ref["mask"][..., 0])


def jax_rounds(trainer, seed, rounds, record=None):
    """compare_psnr.train_rounds on the JAX trainer. record: a list that
    takes, per step, the (jax.random function, value) draws of the step in
    call order (the step is traced with the draws reported through ordered
    debug callbacks)."""
    import jax

    CP.seed_draws(trainer, seed)
    traj = []
    mp = pytest.MonkeyPatch()
    if record is not None:
        calls = []

        def recording(name, shape_arg):
            orig = getattr(jax.random, name)

            def f(*args, **kwargs):
                out = orig(*args, **kwargs)
                # flax's initializer shape check in apply calls uniform with bounds
                if not (name == "uniform" and len(args) > 2):
                    jax.debug.callback(lambda v: calls.append((name, np.asarray(v))), out,
                                       ordered=True)
                return out
            return f

        for name, arg in (("choice", 2), ("uniform", 1), ("randint", 1)):
            mp.setattr(jax.random, name, recording(name, arg))
    try:
        for r in range(rounds):
            start = trainer.current_steps
            trainer.train_one_round(r)
            if record is not None:
                jax.effects_barrier()
                steps = trainer.current_steps - start
                per = len(calls) // steps
                assert per * steps == len(calls), (len(calls), steps)
                record += [calls[i * per:(i + 1) * per] for i in range(steps)]
                calls.clear()
            trainer.current_round += 1
            trainer.update_geometry_aux()
            traj.append(jax_eval_psnr(trainer))
            print(f"[psnr jax] seed {seed} round {r}: {traj[-1]:.4f}", flush=True)
    finally:
        mp.undo()
    return traj


def port_draws(calls, fg_motion="skel-quad"):
    """One step's recorded JAX draws as the port's fg draws (the order of
    tests/test_torch_families.py jax_draw_order: eikonal rays, match
    candidates, visibility-decay points and ids, then the gauss-skin
    points, which the rigid warp does not draw)."""
    import torch

    names = ["eikonal_idx", "match_idx", "vis_u", "vis_inst", "gauss_u"]
    want = ["choice", "randint", "uniform", "randint", "uniform"]
    if fg_motion == "rigid":
        want = want[:4]
    assert [c[0] for c in calls] == want, [c[0] for c in calls]
    return {"fg": {k: torch.as_tensor(np.array(v)) for k, (_, v) in zip(names, calls)}}


def feed_draws(trainer, record, fg_motion="skel-quad"):
    """Hand each step of `trainer` the recorded draws of that step."""
    step = trainer.train_step

    def with_draws(batch, i, draws=None):
        return step(batch, i, draws=port_draws(record[i], fg_motion))

    trainer.train_step = with_draws


def load_init(trainer, path):
    """The port's trainer takes the params and proxy meshes of the JAX
    trainer's checkpoint, each field's geometry state reset from them."""
    from lab4d_tpu_torch import bridge
    from lab4d_tpu_torch.meshlib import Mesh

    ckpt = bridge.load_flax_checkpoint(path)
    trainer.model.load_state_dict(bridge.params_from_flax(ckpt["model"]))
    for cate, pm in ckpt["proxy"].items():
        trainer.proxy[cate] = Mesh(np.asarray(pm["vertices"], np.float32),
                                   np.asarray(pm["faces"], np.int64))
        trainer._reset_geo_state(cate, beta=0.0)


def run_pair(db, workdir, seed, rounds, res, iters, frames, jax_init, extra=(), on_init=None,
             jax_draws=False, fg_motion="skel-quad"):
    """Both packages' trajectories for one seed, the JAX side first.
    on_init(jax_trainer, port_trainer): called before the first step;
    jax_draws: the port's steps take the JAX steps' random draws."""
    jt, ckpt = jax_trainer(db, workdir, seed, rounds, res, iters, frames, extra, fg_motion)
    pt = CP.build_trainer(db, workdir, seed, rounds, res, iters, frames, "cpu", fg_motion, extra)
    try:
        if jax_init:
            load_init(pt, ckpt)
        if on_init is not None:
            on_init(jt, pt)
        record = [] if jax_draws else None
        jax_traj = jax_rounds(jt, seed, rounds, record)
        if jax_draws:
            feed_draws(pt, record, fg_motion)
        torch_traj = CP.train_rounds(pt, seed, rounds)
    finally:
        jt.trainloader.stop()
        pt.close()
    return torch_traj, jax_traj


def start_psnr(jt, pt):
    """Both trainers' eval render before the first step (masked PSNR)."""
    out, ref = pt.render_frames(pt.eval_fid)
    return CP.masked_psnr(out["rgb"], ref["rgb"], ref["mask"][..., 0]), jax_eval_psnr(jt)


def compare(args, workdir):
    db = CP.make_dataset(workdir, args.res, args.frames)
    out = {"settings": {"fg_motion": args.fg_motion, "rounds": args.rounds, "res": args.res,
                        "frames": args.frames,
                        "iters_effective": CP.effective_iters(args.iters, args.frames),
                        "device": "cpu", "init": "jax" if args.jax_init else "own",
                        "draws": "jax" if args.jax_draws else "own"},
           "torch": {}, "jax": {}, "start": {}}
    for seed in args.seeds:
        def on_init(jt, pt, s=str(seed)):
            out["start"][s] = dict(zip(("torch", "jax"), start_psnr(jt, pt)))

        out["torch"][str(seed)], out["jax"][str(seed)] = run_pair(
            db, workdir, seed, args.rounds, args.res, args.iters, args.frames, args.jax_init,
            on_init=on_init, jax_draws=args.jax_draws, fg_motion=args.fg_motion)
        print(f"[{args.fg_motion} cpu] seed {seed}: torch "
              f"{np.round(out['torch'][str(seed)], 4).tolist()}, jax "
              f"{np.round(out['jax'][str(seed)], 4).tolist()}", flush=True)
    diffs = [np.asarray(out["torch"][s]) - np.asarray(out["jax"][s]) for s in out["torch"]]
    finals = [d[-1] for d in diffs]
    out["max_abs_round_gap"] = float(np.max(np.abs(diffs)))
    out["round0_gap_by_seed"] = {s: float(d[0]) for s, d in zip(out["torch"], diffs)}
    out["final_gap_by_seed"] = {s: float(f) for s, f in zip(out["torch"], finals)}
    out["final_gap_mean"] = float(np.mean(finals))
    out["final_gap_std"] = float(np.std(finals, ddof=1)) if len(finals) > 1 else float("nan")
    key = args.fg_motion.replace("-", "_") + "_cpu" + ("_jax_init" if args.jax_init else "")
    return {key + ("_jax_draws" if args.jax_draws else ""): out}


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fg_motion", default="skel-quad", choices=("skel-quad", "rigid"))
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--jax_init", action="store_true",
                    help="start the port from the JAX side's fitted params and proxy")
    ap.add_argument("--jax_draws", action="store_true",
                    help="the port's steps take the JAX steps' recorded random draws")
    ap.add_argument("--out", default=os.path.join(CP.ROOT, "psnr_torch.json"))
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    args.seeds = [int(s) for s in args.seeds.split(",")]
    CP.write_result(args.out, lambda workdir: compare(args, workdir), args.workdir)


# ------------------------------------------------------------------ tests

TINY = dict(rounds=1, res=16, iters=20, frames=9)
TINY_FLAGS = ("--geo_init_steps", "2", "--eval_res", "8")


@pytest.mark.parametrize("num_inst,channels", [(1, 32), (1, 256), (64, 256), (300, 16)])
def test_inst_embedding_init_matches_flax(num_inst, channels):
    """The instance codes start as flax nn.Embed's do, normal with std
    1 / sqrt(channels) whatever the number of instances; a code of std 1
    at one instance started the port's fits away from JAX's."""
    import jax
    import torch
    from flax import linen as fnn

    from lab4d_tpu_torch.nnutils.embedding import InstEmbedding

    emb = fnn.Embed(num_inst, channels)
    want = np.asarray(emb.init(jax.random.PRNGKey(0), np.zeros((1,), np.int32))["params"][
        "embedding"])
    got = InstEmbedding(num_inst, channels, torch.Generator().manual_seed(0)).mapping.weight
    got = got.detach().numpy()
    assert got.shape == want.shape
    # the sample std of n normal draws is within 5 / sqrt(2n) of the true one
    # with overwhelming odds
    tol = 5.0 / np.sqrt(2 * got.size) + 5.0 / np.sqrt(2 * want.size)
    assert abs(got.std() * np.sqrt(channels) - 1.0) <= tol
    assert abs(got.std() / want.std() - 1.0) <= 2 * tol


@pytest.mark.parametrize("field_type,fg_motion", [("fg", "rigid"), ("fg", "skel-quad"),
                                                  ("bg", "rigid")])
def test_init_spread_matches_jax_leaf_by_leaf(field_type, fg_motion):
    """Every parameter leaf of a freshly built model is drawn as JAX's is:
    the same shape, a constant leaf the same constant, and a random leaf
    of n values a sample mean and std within 10 / sqrt(2n) of JAX's (in
    JAX's std; both are samples). Leaves of one value are one draw each,
    and the intrinsics' base is set from the data by mlp_init in both."""
    import jax
    import torch

    from lab4d_tpu.engine.schedules import compute_sched
    from lab4d_tpu_torch import bridge
    from lab4d_tpu_torch.engine.model import DVRModel
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo
    from tests.test_model import (LOSS_WEIGHTS, init_params_with_intrinsics_prior,
                                  make_model_and_batch)

    jmodel, batch = make_model_and_batch(field_type, fg_motion, M=2, N=4)
    want = dict(bridge._flatten(jax.tree.map(np.asarray, init_params_with_intrinsics_prior(
        jmodel, batch, compute_sched(0))["params"])))
    fi = jmodel.frame_info
    torch.manual_seed(0)
    pmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      field_type=field_type, fg_motion=fg_motion, device="cpu",
                      intrinsics_init=jmodel.intrinsics_init, rtmat_fg=jmodel.rtmat_fg,
                      rtmat_bg=jmodel.rtmat_bg, train_res=jmodel.train_res,
                      loss_weights=LOSS_WEIGHTS)
    got = dict(bridge._flatten(bridge.params_to_flax(
        {n: p.detach() for n, p in pmodel.named_parameters()})))
    assert set(got) == set(want)
    random_leaves = 0
    for key, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[key], np.float64)
        assert g.shape == w.shape, key
        if w.size == 1 or key[:2] in (("intrinsics", "base_logfocal"),
                                      ("intrinsics", "base_ppoint")):
            continue
        if w.std() == 0:
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=str(key))
            continue
        tol = 10.0 / np.sqrt(2 * w.size)
        assert abs(g.std() / w.std() - 1.0) <= tol, (key, g.std(), w.std())
        assert abs(g.mean() - w.mean()) <= tol * w.std(), (key, g.mean(), w.mean())
        random_leaves += 1
    assert random_leaves >= 40


def _first_step_losses(run_dir):
    """The step-0 record of a trainer's metrics.jsonl (its loss terms)."""
    import json

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rec = next(json.loads(line) for line in f if '"grad_norm"' in line)
    assert rec["step"] == 0
    return rec


@pytest.mark.parametrize("fg_motion", ["skel-quad", "rigid"])
def test_tiny_skel_quad_comparison(tmp_path, fg_motion):
    """The comparison at TINY for the flagship warp and the rigid one."""
    db = CP.make_dataset(str(tmp_path), TINY["res"], TINY["frames"])
    start = {}

    def first_render(jt, pt):
        out, ref = pt.render_frames(pt.eval_fid)
        start["torch"] = CP.masked_psnr(out["rgb"], ref["rgb"], ref["mask"][..., 0])
        start["jax"] = jax_eval_psnr(jt)
        # the between-round refresh from the same params: the marching-cubes
        # proxy and the aabb / near-far / corner EMA equal JAX's
        jt.update_geometry_aux()
        pt.update_geometry_aux()
        n_port, n_jax = len(pt.proxy["fg"].vertices), len(jt.proxy["fg"].vertices)
        assert n_jax > 0
        if fg_motion == "skel-quad":
            assert n_port == n_jax
        else:
            # the rigid init has 2 of the 64^3 grid's SDF values within
            # 1.1e-6 of the 0.005 level (the fields agree to 3e-5 there),
            # which add 7 vertices on one side: 1e-3 of the count
            assert abs(n_port - n_jax) <= 1e-3 * n_jax, (n_port, n_jax)
        for k in ("aabb", "near_far", "corners"):
            np.testing.assert_allclose(pt.geo_state["fg"][k], jt.geo_state["fg"][k], rtol=0,
                                       atol=1e-5, err_msg=k)

    torch_traj, jax_traj = run_pair(db, str(tmp_path), 0, jax_init=True, extra=TINY_FLAGS,
                                    on_init=first_render, jax_draws=True, fg_motion=fg_motion,
                                    **TINY)
    assert len(torch_traj) == len(jax_traj) == 1
    assert np.isfinite(torch_traj + jax_traj).all()
    assert abs(start["torch"] - start["jax"]) <= 1e-4, start
    # --jax_draws: the port's steps took the JAX steps' recorded draws, so the
    # first step's loss terms (both trainers' metrics.jsonl, the same batch)
    # agree as the one-step tests' do
    want = _first_step_losses(os.path.join(str(tmp_path), "logdir_jax", f"{CP.SEQNAME}-jax0"))
    got = _first_step_losses(os.path.join(str(tmp_path), "logdir", f"{CP.SEQNAME}-seed0"))
    terms = [k for k in want if k not in ("step", "grad_norm", "total")]
    assert len(terms) >= 16
    for k in terms:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-9, err_msg=k)


if __name__ == "__main__":
    main()
