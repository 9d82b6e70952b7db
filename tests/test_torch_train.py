"""The training slice: the bg field (field_type="bg") of the port against
the JAX package, from the same numbers.

- step parity: the JAX DVRModel (built as tests/test_model.py builds it,
  with the trainer's intrinsics prior) and the port's DVRModel with the
  bridged params take one training step on the same batch (M=2 pairs,
  N=4 pixels, 64 samples per ray) with the same random draws: numpy draws
  handed to the port and, through jax.random, to JAX. Compared: every
  loss term (rtol 1e-4), every parameter gradient (per leaf,
  max|d| <= 1e-5 + 1e-3 max|g_jax|), and the parameters after one AdamW
  update of each package's own optimizer (atol 1e-6 at lr 5e-4 where
  |g| >= max(1e-7, 1e-3 max|g|); one update moves a parameter by at most
  ~lr);
- trainer units against the JAX trainer's: skip-not-clip at grad norms
  4.9, 5.0, 5.1 and NaN, onecycle_linear, the param groups, compute_sched;
- the CLI: `python -m lab4d_tpu_torch.train --field_type bg` on the CPU on
  a tiny synthetic scene (1 round of 2 steps), whose checkpoint the port's
  reader and flax both read back.

On the CPU the port's fused wrappers take their plain versions and JAX
its plain chain (its fused kernels run only on a TPU), so this is the
slice's arithmetic; the kernels themselves are checked against the same
plain versions in tests/test_torch_mlp_kernel.py and on the card.
"""

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
from lab4d_tpu_torch.engine.schedules import compute_sched
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import (
    LOSS_WEIGHTS,
    RNGS,
    init_params_with_intrinsics_prior,
    make_model_and_batch,
)

M, N, STEP = 2, 4, 100  # pairs, pixels per image; step 100: alpha 0.61, a live window
LR, TOTAL_STEPS = 5e-4, 400  # step 100 of 400 with 2 rounds: the peak has passed


def _draws():
    """The step's random draws, from numpy: the eikonal ray subsample
    (without replacement) and the visibility-decay points and ids."""
    rng = np.random.default_rng(7)
    rays = 2 * M * N
    return {
        "eikonal_idx": rng.permutation(rays)[: max(1, rays // 16)],
        "vis_u": rng.random((512, 3)).astype(np.float32),
        "vis_inst": np.zeros(512, np.int32),
    }


@pytest.fixture(scope="module")
def bg_step():
    """One training step of both packages: loss terms, grads, and params
    after an AdamW update."""
    jmodel, batch = make_model_and_batch("bg", "rigid", M=M, N=N)
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]
    draws = _draws()
    calls = {"choice": 0, "uniform": 0, "randint": 0}

    def fake(name, value, shape_arg):
        orig = getattr(jax.random, name)

        def f(*args, **kwargs):
            shape = kwargs.get("shape", args[shape_arg] if len(args) > shape_arg else None)
            if shape is None or tuple(shape) != value.shape:  # e.g. flax's param init checks
                return orig(*args, **kwargs)
            calls[name] += 1
            return jnp.asarray(value)
        return f

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "choice", fake("choice", draws["eikonal_idx"], 2))
    mp.setattr(jax.random, "uniform", fake("uniform", draws["vis_u"], 1))
    mp.setattr(jax.random, "randint", fake("randint", draws["vis_inst"], 1))
    sched = jax_compute_sched(STEP)

    def loss_fn(p):
        ld = jmodel.apply({"params": p}, batch, sched, train=True, rngs=RNGS)
        return sum(jax.tree.leaves(ld)), ld

    try:
        (total, jld), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        mp.undo()
    assert calls == {"choice": 1, "uniform": 1, "randint": 1}
    labels = jtrainer.param_labels(params)

    def make_adamw(peak):
        # a fresh optax state counts from 0: shift it to the step's count
        sched_fn = lambda k: jtrainer.onecycle_linear(  # noqa: E731
            k + STEP, TOTAL_STEPS, peak, 2.0 / 20, 25.0, 1.0)
        return optax.adamw(sched_fn, b1=0.9, b2=0.999, weight_decay=1e-4)

    tx = optax.chain(jtrainer.clip_with_norm(5.0), optax.multi_transform(
        {"base": make_adamw(LR), "explicit": make_adamw(LR * 10), "frozen": optax.set_to_zero()},
        labels))
    updates, opt_state = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    # the port, from the same params
    fi = jmodel.frame_info
    pmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      field_type="bg", device="cpu", intrinsics_init=jmodel.intrinsics_init,
                      rtmat_fg=jmodel.rtmat_fg, rtmat_bg=jmodel.rtmat_bg,
                      train_res=jmodel.train_res, loss_weights=LOSS_WEIGHTS)
    pmodel.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items() if k != "geo"}
    tbatch["geo"] = {c: {k: torch.tensor(np.asarray(v)) for k, v in g.items()}
                     for c, g in batch["geo"].items()}
    tdraws = {"bg": {k: torch.tensor(v) for k, v in draws.items()}}
    trainer = T.Trainer.__new__(T.Trainer)  # the optimizer and step, without a dataset
    trainer.model, trainer.opts = pmodel, {"learning_rate": LR, "num_rounds": 20}
    trainer.total_steps = TOTAL_STEPS
    trainer.optimizer_init()
    old = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    lrs = {n: trainer.learning_rate(STEP) * (10.0 if label == "explicit" else 1.0)
           for n, label in T.param_labels(pmodel).items()}
    pld, gnorm = trainer.train_step(tbatch, STEP, draws=tdraws)
    # the gradient of the step (the optimizer consumed p.grad unchanged: gnorm < 5)
    pgrads = {n: p.grad.detach().clone() for n, p in pmodel.named_parameters()}
    return {
        "jax_loss": {k: float(v) for k, v in jld.items()}, "jax_total": float(total),
        "port_loss": {k: float(v) for k, v in pld.items()},
        "jax_grads": jax.tree.map(np.asarray, jgrads), "port_grads": pgrads,
        "jax_new": jax.tree.map(np.asarray, jnew),
        "port_new": {n: p.detach().clone() for n, p in pmodel.named_parameters()},
        "port_old": old, "port_lrs": lrs,
        "jax_gnorm": float(opt_state[0].grad_norm), "port_gnorm": float(gnorm),
    }


def test_step_runs_every_term(bg_step):
    want = bg_step["jax_loss"]
    got = bg_step["port_loss"]
    assert sorted(k for k in got if k != "total") == sorted(want)
    # the comparison is not vacuous
    for k in ("mask", "rgb", "depth", "flow", "vis", "reg_visibility", "reg_eikonal",
              "reg_cam_prior"):
        assert want[k] > 0, k
    assert bg_step["jax_gnorm"] < 5.0


@pytest.mark.parametrize("term", [
    "mask", "rgb", "depth", "flow", "vis", "reg_visibility", "reg_eikonal", "reg_cam_prior",
    "reg_soft_deform", "reg_gauss_skin", "reg_skel_prior", "total",
])
def test_loss_term_matches_jax(bg_step, term):
    want = bg_step["jax_total"] if term == "total" else bg_step["jax_loss"][term]
    np.testing.assert_allclose(bg_step["port_loss"][term], want, rtol=1e-4, atol=1e-12)


def test_grad_norm_matches_jax(bg_step):
    np.testing.assert_allclose(bg_step["port_gnorm"], bg_step["jax_gnorm"], rtol=1e-4)


def _flax_leaves(tree):
    return dict(bridge._flatten(tree))


def test_every_gradient_matches_jax(bg_step):
    got = bg_step["port_grads"]
    leaves = _flax_leaves(bg_step["jax_grads"])
    assert len(leaves) == len(got)
    for path, g_jax in leaves.items():
        key, transpose = bridge.flax_to_torch_key(path)
        want = g_jax.T if transpose else g_jax
        have = got[key].numpy()
        assert have.shape == want.shape, key
        err = float(np.abs(have - want).max())
        bound = 1e-5 + 1e-3 * float(np.abs(want).max())
        assert err <= bound, (key, err, bound)
    # every field MLP received a gradient
    assert all(np.abs(got[k].numpy()).max() > 0 for k in got if "linear_" in k)


def test_params_after_one_adamw_step(bg_step):
    """The update of every parameter. The first step's direction is
    g / (|g| + eps) with eps 1e-8, so where |g| is near eps or below the
    gradient's own tolerance (1e-3 of the leaf's largest) it rests on the
    last digits of the gradient: those elements are only held to the
    largest step the update can take (lr of the group, plus weight decay)."""
    got, old = bg_step["port_new"], bg_step["port_old"]
    lrs = bg_step["port_lrs"]
    n_stable = n_all = 0
    for path, new in _flax_leaves(bg_step["jax_new"]).items():
        key, transpose = bridge.flax_to_torch_key(path)
        want = (new.T if transpose else new) - old[key].numpy()
        have = got[key].numpy() - old[key].numpy()
        g = _flax_leaves(bg_step["jax_grads"])[path]
        g = np.abs(g.T if transpose else g)
        stable = g >= max(1e-7, 1e-3 * g.max())
        np.testing.assert_allclose(have[stable], want[stable], atol=1e-6 * lrs[key] / LR, rtol=0,
                                   err_msg=key)
        bound = lrs[key] * (1 + 1e-3 + 1e-4 * np.abs(old[key].numpy()))
        assert np.all(np.abs(have) <= bound), key
        n_stable, n_all = n_stable + stable.sum(), n_all + stable.size
    assert n_stable > 0.3 * n_all  # the check covers a good share of the parameters


# ----------------------------------------------------------- trainer units


@pytest.mark.parametrize("norm", [4.9, 5.0, 5.1, float("nan")])
def test_skip_not_clip(norm):
    """Both trainers step on the gradient below 5.0, on zeros otherwise."""
    g = np.array([3.0, 4.0], np.float32) / 5.0 * (norm if np.isfinite(norm) else 1.0)
    if not np.isfinite(norm):
        g[0] = np.nan
    tx = jtrainer.clip_with_norm(5.0)
    want, state = tx.update({"w": jnp.asarray(g)}, tx.init(None))
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor(g)
    gnorm = T.clip_with_norm([p])
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want["w"]), rtol=1e-6)
    np.testing.assert_allclose(float(gnorm), float(state.grad_norm), rtol=1e-6)
    assert (p.grad.abs().sum() > 0) == (norm < 5.0)


@pytest.mark.parametrize("step", [0, 1, 5, 39, 40, 41, 100, 399, 400])
def test_onecycle_linear(step):
    kw = dict(total_steps=400, peak=5e-4, pct_start=2.0 / 20, div_factor=25.0,
              final_div_factor=1.0)
    want = float(jtrainer.onecycle_linear(jnp.float32(step), **kw))
    # JAX evaluates it in float32
    np.testing.assert_allclose(T.onecycle_linear(step, **kw), want, rtol=1e-5)


def test_param_groups_match_jax_labels():
    jmodel, batch = make_model_and_batch("bg", "rigid", M=1, N=2)
    params = jax.jit(jmodel.init, static_argnames=("train",))(
        RNGS, batch, jax_compute_sched(0), train=True)["params"]
    want = {bridge.flax_to_torch_key(path)[0]: label
            for path, label in _flax_leaves(jtrainer.param_labels(params)).items()}
    fi = jmodel.frame_info
    pmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      field_type="bg", device="cpu")
    assert T.param_labels(pmodel) == want
    assert sorted(k for k, v in want.items() if v == "explicit") == [
        "fields.field_params.bg.camera_mlp.base_quat", "fields.field_params.bg.logibeta",
        "fields.field_params.bg.logscale", "intrinsics.base_logfocal", "intrinsics.base_ppoint",
    ]


@pytest.mark.parametrize("step", [0, 3, 250, 799, 800, 1999, 2500, 4000, 9000])
def test_compute_sched(step):
    want = jax_compute_sched(step)
    got = compute_sched(step)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, err_msg=k)


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`python -m lab4d_tpu_torch.train --field_type bg` on the CPU: a tiny
    synthetic scene, 1 round of 2 steps; returns (trainer, log root)."""
    from lab4d_tpu_torch import train as train_cli
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("train_cli")
    make_synthetic_dataset(str(root / "database"), seqname="sbg", num_frames=8, res=16)
    trainer = train_cli.main([
        "--field_type", "bg", "--seqname", "sbg", "--logname", "t", "--train_res", "16",
        "--num_rounds", "1", "--iters_per_round", "2", "--imgs_per_gpu", "4",
        "--pixels_per_image", "4", "--geo_init_steps", "3", "--save_freq", "1",
        "--eval_res", "8", "--device", "cpu", "--database_root", str(root / "database"),
        "--logroot", str(root / "logdir"),
    ])
    return trainer, root / "logdir"


def test_train_cli_writes_a_checkpoint(cli_run):
    from flax import serialization

    trainer, logdir = cli_run
    assert trainer.current_steps == 2 and len(trainer.losses) == 2
    assert all(np.isfinite(ld["total"]) for ld in trainer.losses)
    path = logdir / "sbg-t" / "ckpt_latest.flax"
    ckpt = bridge.load_flax_checkpoint(str(path))
    assert ckpt["current_steps"] == 2 and ckpt["current_round"] == 1
    assert ckpt["opt_state_layout"] == bridge.OPTAX_LAYOUT  # the JAX trainer's optax state
    assert int(ckpt["opt_state"]["1"]["inner_states"]["base"]["inner_state"]["0"]["count"]) == 2
    state = bridge.params_from_flax(ckpt["model"])
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy())
    assert set(ckpt["geo_state"]["bg"]) == {"aabb", "near_far", "corners"}
    assert ckpt["proxy"]["bg"]["faces"].shape[1] == 3
    # flax reads the same file, and the JAX package's model tree matches its shapes
    restored = serialization.msgpack_restore(path.read_bytes())
    assert _flax_leaves(restored["model"]).keys() == _flax_leaves(ckpt["model"]).keys()


@pytest.mark.parametrize("norm", [5.5, float("nan")])
def test_check_grad_rolls_back_two_rounds(cli_run, norm):
    """A spiking or non-finite grad norm restores the model and optimizer
    cached two checkpoints back (here: before the first step); a norm at
    the threshold does not."""
    trainer, _ = cli_run
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.check_grad(5.0)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    trainer.check_grad(norm)
    cached = trainer.model_cache[0]
    assert any(not torch.equal(before[k], cached[k]) for k in before)  # the steps moved them
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, cached[k]), k
    assert trainer.optimizer.state_dict()["state"] == {}  # no step had been taken then
    trainer.model.load_state_dict(before)


def test_train_cli_refuses_fields_without_kernels():
    """Every field type (bg, fg, comp) and warp of lab4d_tpu's
    parse_warp_type is ported; check_opts refuses a field type or warp
    that neither package has."""
    from lab4d_tpu_torch import train as train_cli

    parse = train_cli.get_parser().parse_args
    for argv in (["--field_type", "fgbg"], ["--field_type", "fg", "--fg_motion", "skel-dog"],
                 ["--field_type", "comp", "--fg_motion", "comp_skel-quad_nvp"]):
        with pytest.raises((ValueError, NotImplementedError)):
            train_cli.check_opts(vars(parse(argv)))
    motions = ("rigid", "dense", "nvp", "bob", "skel-human", "skel-quad",
               "comp_skel-human_dense", "comp_skel-quad_dense")
    for argv in [["--field_type", "bg"]] + [["--field_type", ft, "--fg_motion", m]
                                             for ft in ("fg", "comp") for m in motions]:
        train_cli.check_opts(vars(parse(argv)))


def test_synthetic_scene_writer_matches_tests_synthetic(tmp_path):
    """The port's scene writer (no JAX package) writes the same .npy
    arrays, meshes and config as tests/synthetic.py for the same
    arguments; only the preview JPEGs' encoder differs."""
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset as port_writer
    from tests.synthetic import make_synthetic_dataset as jax_writer

    kw = dict(seqname="cmp", num_vids=2, num_frames=9, res=16)
    port_writer(str(tmp_path / "port"), **kw)
    jax_writer(str(tmp_path / "jax"), **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    npys = [f for f in files if f.suffix == ".npy"]
    assert len(npys) == 2 * 16  # per video: rgb, masks (3), depth, features, cameras (2), flow (8)
    for f in npys:
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=str(f))
    for f in files:
        if f.suffix in (".obj", ".config"):
            want = (tmp_path / "jax" / f).read_text().replace(str(tmp_path / "jax"), "<root>")
            got = (tmp_path / "port" / f).read_text().replace(str(tmp_path / "port"), "<root>")
            assert got == want, f


TRAIN_SPANS = {"train.to_device", "train.forward", "train.draws", "train.backward",
               "train.optimizer", "train.readback"}


def test_each_step_leaves_one_record(cli_run, monkeypatch):
    """A round of 12 steps on the CLI's trainer: 12 "step" records
    (utils/profile.py), each with the step's spans; train.readback in the
    10th (the drain) and the round's last (the round-end readback) alone."""
    from lab4d_tpu_torch.utils import profile

    trainer, _ = cli_run
    monkeypatch.setattr(trainer, "log", T.NullLogger())  # the CLI closed its log
    iters = trainer.opts["iters_per_round"]
    trainer.opts["iters_per_round"] = 12
    try:
        trainer.train_one_round(trainer.current_round)
    finally:
        trainer.opts["iters_per_round"] = iters
        trainer.trainloader.stop()
    records = profile.records("step", 12)
    assert len(records) == 12
    for i, record in enumerate(records):
        want = TRAIN_SPANS if i in (9, 11) else TRAIN_SPANS - {"train.readback"}
        assert set(record) == want, i
        assert all(v > 0 for v in record.values())
        assert record["train.draws"] < record["train.forward"]  # nested in it


def test_render_batch_leaves_a_record_per_frame(cli_run):
    from lab4d_tpu_torch.utils import profile

    trainer, _ = cli_run
    before = len(profile.records("frame"))
    rendered, _ = trainer.render_frames(trainer.eval_fid[:2])
    assert rendered["rgb"].shape[0] == 2
    records = profile.records("frame")
    assert len(records) == min(before + 2, profile.RING)
    for record in records[-2:]:
        assert set(record) == {"render.prepare", "render.evaluate", "render.readback"}
        assert all(v > 0 for v in record.values())
