"""The training slice of the flagship model: the fg / skel-quad field of the
port against the JAX package, from the same numbers.

- step parity: the JAX DVRModel (built as tests/test_model.py builds it,
  with the trainer's intrinsics prior) and the port's DVRModel with the
  bridged params take one training step on the same batch (M=2 pairs, N=4
  pixels, 64 samples per ray) with the same random draws: numpy draws
  handed to the port and, through jax.random, to JAX (the eikonal ray
  subsample, the visibility-decay points and ids, the global-match
  candidates, the gauss-skin points). Compared: all 17 loss terms (rtol
  1e-4), the grad norm, every parameter gradient (per leaf, max|d| <=
  1e-5 + 1e-3 max|g_jax|), and the parameters after one AdamW update;
- the fused flow + cycle warp (Deformable.compute_flow_cycle) against
  JAX's, and against the port's separate compute_flow + cycle_loss;
- the param groups of the fg model against the JAX trainer's labels;
- the eval metrics (Trainer.compute_eval_metrics) against JAX's;
- the CLI: `python -m lab4d_tpu_torch.train --field_type fg --fg_motion
  skel-quad` on the CPU on a tiny synthetic scene: a checkpoint and a
  finite eval/psnr.

On the CPU the port's field heads take the plain version of K1 / K2 through
the same packed nets the kernels read (FeatureNeRF.pack_field_nets), and
JAX its per-module plain chain (its fused kernels run only on a TPU), so
the two sides compute the same function by different routes; the kernels
themselves are checked against the plain version in
tests/test_torch_field_kernel.py and on the card.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lab4d_tpu.engine import trainer as jtrainer
from lab4d_tpu.engine.schedules import compute_sched as jax_compute_sched
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.engine import trainer as T
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import (
    LOSS_WEIGHTS,
    RNGS,
    init_params_with_intrinsics_prior,
    make_model_and_batch,
)

M, N, STEP = 2, 4, 100  # pairs, pixels per image; step 100: alpha 0.61, a live window
LR, TOTAL_STEPS = 5e-4, 400
TERMS = ("mask", "rgb", "depth", "flow", "vis", "feature", "feat_reproj", "reg_gauss_mask",
         "reg_visibility", "reg_eikonal", "reg_deform_cyc", "reg_delta_skin",
         "reg_skin_entropy", "reg_soft_deform", "reg_gauss_skin", "reg_cam_prior",
         "reg_skel_prior")


def _draws():
    """The step's random draws, from numpy, keyed by the port's names."""
    rng = np.random.default_rng(7)
    rays = 2 * M * N
    return {
        "eikonal_idx": rng.permutation(rays)[: max(1, rays // 16)],
        "vis_u": rng.random((512, 3)).astype(np.float32),
        "vis_inst": np.zeros(512, np.int32),
        "match_idx": rng.integers(0, rays * 64, 1024).astype(np.int32),
        "gauss_u": rng.random((2048, 3)).astype(np.float32),
    }


def _port_model(jmodel, fg_motion="skel-quad"):
    fi = jmodel.frame_info
    return DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                    field_type="fg", fg_motion=fg_motion, device="cpu",
                    intrinsics_init=jmodel.intrinsics_init, rtmat_fg=jmodel.rtmat_fg,
                    rtmat_bg=jmodel.rtmat_bg, train_res=jmodel.train_res,
                    loss_weights=LOSS_WEIGHTS)


def _flax_leaves(tree):
    return dict(bridge._flatten(tree))


@pytest.fixture(scope="module")
def flagship():
    jmodel, batch = make_model_and_batch("fg", "skel-quad", M=M, N=N)
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]
    return jmodel, batch, params


@pytest.fixture(scope="module")
def fg_step(flagship):
    """One training step of both packages: loss terms, grads, and params
    after an AdamW update."""
    jmodel, batch, params = flagship
    return run_step(jmodel, batch, params, _draws(), "skel-quad",
                    {"choice": 1, "uniform": 2, "randint": 2})


def run_step(jmodel, batch, params, draws, fg_motion, want_calls):
    """One training step of the fg model of both packages on the same
    draws (keyed by the port's names; want_calls: how many times JAX draws
    from each jax.random function): loss terms, grads, and params after an
    AdamW update."""
    by_shape = {  # jax.random function -> {shape: the draw}
        "choice": {draws["eikonal_idx"].shape: draws["eikonal_idx"]},
        "uniform": {draws[k].shape: draws[k] for k in ("vis_u", "gauss_u") if k in draws},
        "randint": {(512,): draws["vis_inst"], (1024,): draws["match_idx"]},
    }
    calls = {k: 0 for k in by_shape}

    def fake(name, shape_arg):
        orig = getattr(jax.random, name)

        def f(*args, **kwargs):
            shape = kwargs.get("shape", args[shape_arg] if len(args) > shape_arg else None)
            if shape is None or tuple(shape) not in by_shape[name]:  # e.g. flax's param init
                return orig(*args, **kwargs)
            calls[name] += 1
            return jnp.asarray(by_shape[name][tuple(shape)])
        return f

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "choice", fake("choice", 2))
    mp.setattr(jax.random, "uniform", fake("uniform", 1))
    mp.setattr(jax.random, "randint", fake("randint", 1))
    sched = jax_compute_sched(STEP)

    def loss_fn(p):
        ld = jmodel.apply({"params": p}, batch, sched, train=True, rngs=RNGS)
        return sum(jax.tree.leaves(ld)), ld

    try:
        (total, jld), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        mp.undo()
    assert calls == want_calls
    labels = jtrainer.param_labels(params)

    def make_adamw(peak):
        sched_fn = lambda k: jtrainer.onecycle_linear(  # noqa: E731
            k + STEP, TOTAL_STEPS, peak, 2.0 / 20, 25.0, 1.0)
        return optax.adamw(sched_fn, b1=0.9, b2=0.999, weight_decay=1e-4)

    tx = optax.chain(jtrainer.clip_with_norm(5.0), optax.multi_transform(
        {"base": make_adamw(LR), "explicit": make_adamw(LR * 10), "frozen": optax.set_to_zero()},
        labels))
    updates, opt_state = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    pmodel = _port_model(jmodel, fg_motion)
    pmodel.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items() if k != "geo"}
    tbatch["geo"] = {c: {k: torch.tensor(np.asarray(v)) for k, v in g.items()}
                     for c, g in batch["geo"].items()}
    tdraws = {"fg": {k: torch.tensor(v) for k, v in draws.items()}}
    trainer = T.Trainer.__new__(T.Trainer)  # the optimizer and step, without a dataset
    trainer.model, trainer.opts = pmodel, {"learning_rate": LR, "num_rounds": 20}
    trainer.total_steps = TOTAL_STEPS
    trainer.optimizer_init()
    old = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    lrs = {n: trainer.learning_rate(STEP) * (10.0 if label == "explicit" else 1.0)
           for n, label in T.param_labels(pmodel).items()}
    pld, gnorm = trainer.train_step(tbatch, STEP, draws=tdraws)
    pgrads = {n: p.grad.detach().clone() for n, p in pmodel.named_parameters()}
    # JAX's optimizer on the port's own gradients
    pg_tree = jax.tree.map(jnp.asarray, bridge.params_to_flax(pgrads))
    jnew_port_grads = optax.apply_updates(params, tx.update(pg_tree, tx.init(params), params)[0])
    return {
        "jax_new_from_port_grads": jax.tree.map(np.asarray, jnew_port_grads),
        "jax_loss": {k: float(v) for k, v in jld.items()}, "jax_total": float(total),
        "port_loss": {k: float(v) for k, v in pld.items()},
        "jax_grads": jax.tree.map(np.asarray, jgrads), "port_grads": pgrads,
        "jax_new": jax.tree.map(np.asarray, jnew),
        "port_new": {n: p.detach().clone() for n, p in pmodel.named_parameters()},
        "port_old": old, "port_lrs": lrs,
        "jax_gnorm": float(opt_state[0].grad_norm), "port_gnorm": float(gnorm),
    }


def test_step_runs_all_17_terms(fg_step):
    want = fg_step["jax_loss"]
    got = fg_step["port_loss"]
    assert sorted(k for k in got if k != "total") == sorted(want) == sorted(TERMS)
    for k in TERMS:  # the comparison is not vacuous
        if k != "reg_soft_deform":  # zero for a skeleton warp
            assert want[k] > 0, k
    assert fg_step["jax_gnorm"] < 5.0


@pytest.mark.parametrize("term", TERMS + ("total",))
def test_loss_term_matches_jax(fg_step, term):
    want = fg_step["jax_total"] if term == "total" else fg_step["jax_loss"][term]
    np.testing.assert_allclose(fg_step["port_loss"][term], want, rtol=1e-4, atol=1e-12)


def test_grad_norm_matches_jax(fg_step):
    np.testing.assert_allclose(fg_step["port_gnorm"], fg_step["jax_gnorm"], rtol=1e-4)


def test_every_gradient_matches_jax(fg_step):
    check_every_gradient(fg_step, ("basefield", "colorfield", "vis_mlp", "feature_field",
                                   "rgb_head", "sdf_head", "skinning_model", "articulation",
                                   "logsigma", "appr_embedding"))


def check_every_gradient(step, parts):
    """Every gradient within 1e-5 + 1e-3 max|g_jax| of JAX's, per leaf, and
    each of `parts` received one."""
    got = step["port_grads"]
    leaves = _flax_leaves(step["jax_grads"])
    assert len(leaves) == len(got)
    for path, g_jax in leaves.items():
        key, transpose = bridge.flax_to_torch_key(path)
        want = g_jax.T if transpose else g_jax
        have = got[key].numpy()
        assert have.shape == want.shape, key
        err = float(np.abs(have - want).max())
        bound = 1e-5 + 1e-3 * float(np.abs(want).max())
        assert err <= bound, (key, err, bound)
    for part in parts:
        assert any(np.abs(g.numpy()).max() > 0 for k, g in got.items() if part in k), part


def test_params_after_one_adamw_step(fg_step):
    check_adamw_step(fg_step)


def check_adamw_step(step):
    """As tests/test_torch_train.py: elements whose gradient is well above
    its tolerance are held to 1e-6 (scaled by the group's learning rate);
    the others to the largest step an update can take."""
    got, old = step["port_new"], step["port_old"]
    lrs = step["port_lrs"]
    jgrads = _flax_leaves(step["jax_grads"])
    n_stable = n_all = 0
    for path, new in _flax_leaves(step["jax_new"]).items():
        key, transpose = bridge.flax_to_torch_key(path)
        want = (new.T if transpose else new) - old[key].numpy()
        have = got[key].numpy() - old[key].numpy()
        g = np.abs(jgrads[path].T if transpose else jgrads[path])
        stable = g >= max(1e-7, 1e-3 * g.max())
        np.testing.assert_allclose(have[stable], want[stable], atol=1e-6 * lrs[key] / LR, rtol=0,
                                   err_msg=key)
        bound = lrs[key] * (1 + 1e-3 + 1e-4 * np.abs(old[key].numpy()))
        assert np.all(np.abs(have) <= bound), key
        n_stable, n_all = n_stable + stable.sum(), n_all + stable.size
    assert n_stable > 0.3 * n_all


def test_param_groups_match_jax_labels(flagship):
    jmodel, _, params = flagship
    want = {bridge.flax_to_torch_key(path)[0]: label
            for path, label in _flax_leaves(jtrainer.param_labels(params)).items()}
    assert T.param_labels(_port_model(jmodel)) == want
    explicit = sorted(k for k, v in want.items() if v == "explicit")
    for name in ("logsigma", "log_gauss", "warp.logibeta", "articulation.shift",
                 "articulation.logscale"):
        assert any(name in k for k in explicit), name
    want_frozen = {bridge.flax_to_torch_key(path)[0]: label for path, label in
                   _flax_leaves(jtrainer.param_labels(params, freeze_bone_len=True)).items()}
    frozen = T.param_labels(_port_model(jmodel), freeze_bone_len=True)
    assert frozen == want_frozen and "frozen" in frozen.values()


def test_flow_cycle_matches_jax(flagship):
    """The fused flow + cycle warp of the canonical samples of a batch
    (forward skin weights cached once) against JAX's, and against the
    port's two separate warps."""
    jmodel, _, params = flagship
    rng = np.random.default_rng(3)
    Mf, Nf, Df = 4, 4, 8
    xyz = (rng.standard_normal((Mf, Nf, Df, 3)) * 0.1).astype(np.float32)
    xyz_t = xyz + (rng.standard_normal(xyz.shape) * 0.01).astype(np.float32)
    hxy = np.concatenate([rng.uniform(0, 64, (Mf, Nf, 2)), np.ones((Mf, Nf, 1))], -1).astype(np.float32)
    Kinv = np.tile(np.array([[0.01, 0, -0.32], [0, 0.01, -0.32], [0, 0, 1]], np.float32), (Mf, 1, 1))
    quat = rng.standard_normal((Mf, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    trans = np.tile(np.array([0, 0, 1.0], np.float32), (Mf, 1))
    frame_id = np.array([1, 3, 4, 6], np.int32)
    inst_id = np.zeros(Mf, np.int32)

    def jax_fc(m):
        fld = m.fields.field_params["fg"]
        t, rest = fld.warp.articulation.get_vals_and_mean(jnp.asarray(frame_id))
        sd = fld.prepare_forward_warp(jnp.asarray(xyz), jnp.asarray(inst_id),
                                      {"t_articulation": t, "rest_articulation": rest})
        return fld.compute_flow_cycle(jnp.asarray(hxy), jnp.asarray(xyz), jnp.asarray(xyz_t),
                                      jnp.asarray(frame_id), jnp.asarray(inst_id),
                                      (jnp.asarray(quat), jnp.asarray(trans)), jnp.asarray(Kinv),
                                      sd, flow_thresh=64)

    jflow, jcyc = jmodel.apply({"params": params}, method=jax_fc)
    pmodel = _port_model(jmodel)
    pmodel.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    fld = pmodel.fields.field_params["fg"]
    t = {k: torch.tensor(v) for k, v in dict(xyz=xyz, xyz_t=xyz_t, hxy=hxy, Kinv=Kinv).items()}
    fid, iid = torch.tensor(frame_id, dtype=torch.int64), torch.tensor(inst_id, dtype=torch.int64)
    with torch.no_grad():
        t_art, rest = fld.warp.articulation.get_vals_and_mean(fid)
        sd = {"t_articulation": t_art, "rest_articulation": rest}
        f2c = (torch.tensor(quat), torch.tensor(trans))
        args = (t["hxy"], t["xyz"], t["xyz_t"], fid, iid, f2c, t["Kinv"])
        flow, cyc = fld.compute_flow_cycle(*args, fld.prepare_forward_warp(t["xyz"], iid, sd), 64)
        flow_sep, cyc_sep = fld.compute_flow_cycle(*args, sd, 64)  # no cache: the separate path
    np.testing.assert_allclose(flow["flow"].numpy(), np.asarray(jflow["flow"]), atol=1e-4)
    assert sorted(cyc) == sorted(jcyc) == ["cyc_dist", "delta_skin", "skin_entropy"]
    for k in cyc:
        np.testing.assert_allclose(cyc[k].numpy(), np.asarray(jcyc[k]), atol=1e-5, err_msg=k)
        torch.testing.assert_close(cyc_sep[k], cyc[k], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(flow_sep["flow"], flow["flow"], atol=1e-5, rtol=1e-5)
    assert flow["flow"][..., 2].sum() > 0  # some projections are valid


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(0)
    rendered = {"rgb": rng.random((3, 16, 16, 3)).astype(np.float32),
                "depth": rng.random((3, 16, 16, 1)).astype(np.float32) + 0.5}
    ref = {"rgb": rng.random((3, 16, 16, 3)).astype(np.float32),
           "depth": rng.random((3, 16, 16, 1)).astype(np.float32) + 0.5,
           "mask": (rng.random((3, 16, 16, 1)) > 0.3).astype(np.float32)}
    want = jtrainer.Trainer.compute_eval_metrics(rendered, ref)
    got = T.Trainer.compute_eval_metrics(rendered, ref)
    assert sorted(got) == sorted(want) == ["eval/depth_err", "eval/psnr", "eval/ssim"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def fg_cli_run(tmp_path_factory):
    """`python -m lab4d_tpu_torch.train --field_type fg --fg_motion
    skel-quad` on the CPU: a tiny synthetic scene, 1 round of 2 steps."""
    from lab4d_tpu_torch import train as train_cli
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("train_fg_cli")
    make_synthetic_dataset(str(root / "database"), seqname="sfg", num_frames=8, res=16)
    trainer = train_cli.main([
        "--field_type", "fg", "--fg_motion", "skel-quad", "--seqname", "sfg", "--logname", "t",
        "--train_res", "16", "--num_rounds", "1", "--iters_per_round", "2", "--imgs_per_gpu", "4",
        "--pixels_per_image", "4", "--geo_init_steps", "3", "--save_freq", "1", "--eval_res", "8",
        "--device", "cpu", "--database_root", str(root / "database"),
        "--logroot", str(root / "logdir"),
    ])
    return trainer, root / "logdir" / "sfg-t"


def test_fg_cli_writes_a_checkpoint_and_eval_metrics(fg_cli_run):
    trainer, run_dir = fg_cli_run
    assert trainer.current_steps == 2 and len(trainer.losses) == 2
    assert all(np.isfinite(ld["total"]) for ld in trainer.losses)
    assert sorted(k for k in trainer.losses[0] if k != "total") == sorted(TERMS)
    ckpt = bridge.load_flax_checkpoint(str(run_dir / "ckpt_latest.flax"))
    assert ckpt["current_steps"] == 2 and ckpt["current_round"] == 1
    state = bridge.params_from_flax(ckpt["model"])
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy())
    assert set(ckpt["geo_state"]["fg"]) == {"aabb", "near_far", "corners"}
    evals = [r for r in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
             if "eval/psnr" in r]
    assert len(evals) == 1 and evals[0]["step"] == 0
    assert all(np.isfinite(evals[0][k]) for k in ("eval/psnr", "eval/ssim", "eval/depth_err"))


def test_fg_geometry_pools_are_the_bone_spheres(fg_cli_run):
    """The fg SDF distillation targets the rest-pose bone spheres'
    -logit(density), as the JAX trainer's skeleton branch."""
    trainer, _ = fg_cli_run
    pools = trainer._build_geometry_pools(num_steps=2, nsample=8)["fg"]
    warp = trainer.model.fields.field_params["fg"].warp
    with torch.no_grad():
        want = warp.get_gauss_sdf(pools["pts"].reshape(-1, 3)).reshape(2, 8, 1)
    torch.testing.assert_close(pools["sdf_gt"], want)


def test_eikonal_records_hold_the_sdf_chains_relu_inputs(fg_cli_run):
    """chip_smoke.eikonal_records, which the GPU-vs-CPU step check reads:
    per point the eikonal value that compute_eikonal returned, and the
    inputs of the SDF chain's ReLUs (D hidden layers and the final
    activation of the base field), the last of which through the ReLU is
    the base field's output."""
    import chip_smoke
    from lab4d_tpu_torch.nnutils.base import embed_cond_mlp

    trainer, _ = fg_cli_run
    field = trainer.model.fields.field_params["fg"]
    gen = torch.Generator().manual_seed(0)
    xyz = (torch.rand(2, 4, 8, 3, generator=gen) - 0.5) * 0.2
    idx, inst = torch.tensor([1, 6]), torch.zeros(2, dtype=torch.long)
    with chip_smoke.eikonal_records([]) as rec:
        eik = field.compute_eikonal(xyz, inst_id=inst, idx=idx)
    (r,) = rec
    assert torch.equal(r["eikonal"], eik.detach().reshape(-1).double())
    mlp = field.basefield.backbone
    assert r["z"].shape == (16, (mlp.D + 1) * mlp.W)
    xyz_s = xyz.reshape(8, 8, 3)[idx]
    with torch.no_grad():
        feat = embed_cond_mlp(field.basefield, field.pos_embedding, xyz_s,
                              inst_id=inst[:, None].expand(2, 4).reshape(-1)[idx], fused=False)
    torch.testing.assert_close(torch.relu(r["z"][:, -mlp.W:]), feat.reshape(16, -1).double())


@pytest.mark.parametrize("case", ["tie", "jump_elsewhere", "inputs_apart"])
def test_eikonal_ties_are_left_out_of_reg_eikonal(case):
    """chip_smoke._compare_steps: a point whose ReLU input lies within
    rounding of zero and flips between the two steps may change its
    eikonal value by any amount (the term differentiates the ReLU chain);
    reg_eikonal is compared without it at the same rtol. A jump on a point
    without a flip, or ReLU inputs further apart than TRAIN_REF_TOL's
    tie_z, still fails."""
    import chip_smoke

    rng = np.random.default_rng(0)
    z = torch.tensor(rng.normal(size=(64, 24)))
    e = torch.tensor(rng.random(64)) + 0.1
    z[5, 3] = 2e-8

    def step(z, e):
        return {"loss": {"reg_eikonal": 1e-3 * float(e.mean()), "rgb": 0.5},
                "grads": {"w": torch.ones(3)}, "eikonal": [{"eikonal": e, "z": z}]}

    z_got, e_got = z.clone(), e.clone()
    z_got[5, 3] = -3e-8  # the tie: point 5 takes the other side of the kink
    e_got[5] += 0.3
    if case == "jump_elsewhere":
        e_got[9] += 0.05
    if case == "inputs_apart":
        z_got[20] += 1e-3
    got, want = step(z_got, e_got), step(z, e)
    raw = abs(got["loss"]["reg_eikonal"] - want["loss"]["reg_eikonal"]) / want["loss"]["reg_eikonal"]
    assert raw > 10 * chip_smoke.TRAIN_REF_TOL["loss_rtol"]
    _, failures = chip_smoke._compare_steps(got, want, chip_smoke.TRAIN_REF_TOL, "test")
    if case == "tie":
        assert failures == []
    elif case == "jump_elsewhere":
        assert len(failures) == 1 and failures[0].startswith("loss reg_eikonal")
    else:
        assert len(failures) == 1 and "ReLU inputs differ" in failures[0]
