"""The flagship model (--fg_motion skel-quad) trained by the port and by
the JAX package on the CPU at matched steps: the masked-PSNR trajectory of
tools/compare_psnr.py's protocol (the same scene, flags, step count and
seeded loader draws; the two packages draw pixels in the same order).

    python3 -m tests.test_torch_skel_quad_psnr [--seeds 0,1,2,3] [--rounds 6]
        [--frames 32] [--jax_init] [--out psnr_torch.json]

Run from the root of a checkout. Each side starts from its own prior fits,
or with --jax_init the port starts from the JAX side's params and proxy
meshes right after its fits (the JAX trainer's checkpoint), so that the
two trajectories differ only in the steps' arithmetic and random draws.
Writes "skel_quad_cpu" (or "skel_quad_cpu_jax_init") into --out.

The init is held against JAX's: the instance codes' against flax
nn.Embed's, and every parameter leaf's spread at three model kinds. The
comparison test runs at a tiny size, one round on 9 frames at
16^2, from the JAX side's init: the port's first eval render, before any
step, equals the JAX side's to 1e-4 dB in masked PSNR, and both rounds
end finite.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pytest

from lab4d_tpu_torch.tools import compare_psnr as CP


def jax_trainer(db, workdir, seed, rounds, res, iters, frames, extra=()):
    """The JAX package's Trainer on the protocol's flags, prior fits run and
    saved as ckpt_0000.flax; returns (trainer, checkpoint path)."""
    from lab4d_tpu.config_hier import validate
    from lab4d_tpu.engine.trainer import Trainer
    from lab4d_tpu_torch import flagfile
    from lab4d_tpu_torch.train import get_parser

    logroot = os.path.join(workdir, "logdir_jax")
    argv = CP.train_argv(db, logroot, f"jax{seed}", "skel-quad", rounds, res, iters, frames, "cpu")
    opts = flagfile.absl_flags(vars(get_parser().parse_args(argv + list(extra))))
    validate(opts)
    trainer = Trainer(opts)
    trainer.save_checkpoint(round_count=0)
    return trainer, os.path.join(logroot, f"{CP.SEQNAME}-jax{seed}", "ckpt_0000.flax")


def jax_eval_psnr(trainer):
    out, ref = trainer.render_frames(trainer.eval_fid, return_ref=True)
    return CP.masked_psnr(np.asarray(out["rgb"]), ref["rgb"], ref["mask"][..., 0])


def jax_rounds(trainer, seed, rounds):
    """compare_psnr.train_rounds on the JAX trainer."""
    CP.seed_draws(trainer, seed)
    traj = []
    for r in range(rounds):
        trainer.train_one_round(r)
        trainer.current_round += 1
        trainer.update_geometry_aux()
        traj.append(jax_eval_psnr(trainer))
        print(f"[psnr jax] seed {seed} round {r}: {traj[-1]:.4f}", flush=True)
    return traj


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


def run_pair(db, workdir, seed, rounds, res, iters, frames, jax_init, extra=(), on_init=None):
    """Both packages' trajectories for one seed, the JAX side first.
    on_init(jax_trainer, port_trainer): called before the first step."""
    jt, ckpt = jax_trainer(db, workdir, seed, rounds, res, iters, frames, extra)
    pt = CP.build_trainer(db, workdir, seed, rounds, res, iters, frames, "cpu", "skel-quad", extra)
    try:
        if jax_init:
            load_init(pt, ckpt)
        if on_init is not None:
            on_init(jt, pt)
        jax_traj = jax_rounds(jt, seed, rounds)
        torch_traj = CP.train_rounds(pt, seed, rounds)
    finally:
        jt.trainloader.stop()
        pt.close()
    return torch_traj, jax_traj


def compare(args, workdir):
    db = CP.make_dataset(workdir, args.res, args.frames)
    out = {"settings": {"fg_motion": "skel-quad", "rounds": args.rounds, "res": args.res,
                        "frames": args.frames,
                        "iters_effective": CP.effective_iters(args.iters, args.frames),
                        "device": "cpu", "init": "jax" if args.jax_init else "own"},
           "torch": {}, "jax": {}}
    for seed in args.seeds:
        out["torch"][str(seed)], out["jax"][str(seed)] = run_pair(
            db, workdir, seed, args.rounds, args.res, args.iters, args.frames, args.jax_init)
        print(f"[skel-quad cpu] seed {seed}: torch {np.round(out['torch'][str(seed)], 4).tolist()}"
              f", jax {np.round(out['jax'][str(seed)], 4).tolist()}", flush=True)
    diffs = [np.asarray(out["torch"][s]) - np.asarray(out["jax"][s]) for s in out["torch"]]
    out["max_abs_round_gap"] = float(np.max(np.abs(diffs)))
    out["final_gap_mean"] = float(np.mean([d[-1] for d in diffs]))
    return {"skel_quad_cpu_jax_init" if args.jax_init else "skel_quad_cpu": out}


def main(argv=None):
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--jax_init", action="store_true",
                    help="start the port from the JAX side's fitted params and proxy")
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


def test_tiny_skel_quad_comparison(tmp_path):
    db = CP.make_dataset(str(tmp_path), TINY["res"], TINY["frames"])
    start = {}

    def first_render(jt, pt):
        out, ref = pt.render_frames(pt.eval_fid)
        start["torch"] = CP.masked_psnr(out["rgb"], ref["rgb"], ref["mask"][..., 0])
        start["jax"] = jax_eval_psnr(jt)

    torch_traj, jax_traj = run_pair(db, str(tmp_path), 0, jax_init=True, extra=TINY_FLAGS,
                                    on_init=first_render, **TINY)
    assert len(torch_traj) == len(jax_traj) == 1
    assert np.isfinite(torch_traj + jax_traj).all()
    assert abs(start["torch"] - start["jax"]) <= 1e-4, start


if __name__ == "__main__":
    main()
