"""--load_path of the port's trainer against the JAX package: checkpoint
surgery (merge_params against JAX's _merge_params on the same trees), the
optimizer state in the layout of JAX's optax state in both directions (a
port-written checkpoint restored by the port and by JAX's
Trainer._restore_opt_state, a JAX-written one restored by the port),
--reset_steps / --noreset_steps, --freeze_bone_len, and the train CLI on
the CPU: a two-video category model (--nosingle_inst) trained, resumed
and transferred to a one-video capture.
"""

import contextlib
import io

import numpy as np
import jax
import optax
import pytest
import torch

from lab4d_tpu.engine import trainer as jtrainer
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch import train as train_cli
from lab4d_tpu_torch.engine import trainer as T
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.flagfile import parse_opts
from lab4d_tpu_torch.nnutils.embedding import FrameInfo

torch.set_num_threads(1)  # as tests/test_torch_families.py

BONES = "fields.field_params.fg.warp.articulation.log_bone_len."
CODES = "fields.field_params.fg.basefield.inst_embedding.mapping.weight"


def _leaves(tree):
    return dict(bridge._flatten(tree))


# ------------------------------------------------------------ merge_params


def _tree(num_vids, num_inst, seed):
    fi = FrameInfo(np.arange(num_vids + 1) * 3, np.arange(num_vids + 1) * 4,
                   [4 * v + i for v in range(num_vids) for i in range(3)])
    model = DVRModel(fi, field_type="fg", fg_motion="skel-quad", num_inst=num_inst,
                     device="cpu", generator=torch.Generator().manual_seed(seed))
    return model, bridge.params_to_flax(model.state_dict())


@pytest.fixture(scope="module")
def trees():
    return {"cate": _tree(3, 3, 0), "one": _tree(1, 1, 1), "cate2": _tree(3, 3, 2)}


def _merge_both(current, loaded):
    model, tree = current
    want = jtrainer._merge_params(tree, loaded)
    got = bridge.params_to_flax(T.merge_params(model.state_dict(), loaded))
    want = {k: np.asarray(v) for k, v in _leaves(want).items()}
    got = _leaves(got)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=str(k))
    return got


def test_merge_params_equal_shapes_take_every_leaf(trees):
    got = _merge_both(trees["cate"], trees["cate2"][1])
    for k, v in _leaves(trees["cate2"][1]).items():
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("current,loaded", [("one", "cate"), ("cate", "one")])
def test_merge_params_compresses_per_video_tables(trees, current, loaded):
    """A category checkpoint into a one-video model (and back): the
    per-video tables take the mean of the loaded rows; everything else of
    the same shape is loaded."""
    got = _merge_both(trees[current], trees[loaded][1])
    src = _leaves(trees[loaded][1])
    tables = [k for k in src if any(t in k for t in T.PER_VIDEO_TABLES)]
    assert any("inst_embedding" in k for k in tables) and any("base_quat" in k for k in tables)
    for k in tables:
        if got[k].shape != src[k].shape:
            np.testing.assert_allclose(got[k], np.broadcast_to(src[k].mean(0), got[k].shape),
                                       rtol=1e-6)
    sdf = ("fields", "field_params_fg", "sdf_head", "kernel")
    np.testing.assert_array_equal(got[sdf], src[sdf])


def test_merge_params_with_keys_missing_on_either_side(trees):
    """Leaves only the current model has keep their values; leaves only
    the checkpoint has, and leaves of another shape outside the per-video
    tables, are dropped."""
    loaded = jax.tree.map(np.array, trees["cate2"][1])
    del loaded["fields"]["field_params_fg"]["sdf_head"]
    loaded["fields"]["field_params_fg"]["extra"] = {"w": np.ones(3, np.float32)}
    loaded["fields"]["field_params_fg"]["logsigma"] = np.ones(2, np.float32)
    got = _merge_both(trees["cate"], loaded)
    cur = _leaves(trees["cate"][1])
    for k in (("fields", "field_params_fg", "sdf_head", "kernel"),
              ("fields", "field_params_fg", "logsigma")):
        np.testing.assert_array_equal(got[k], cur[k])


# -------------------------------------------------------- optax layout


def _jax_tx(params, freeze_bone_len=False):
    labels = jtrainer.param_labels(params, freeze_bone_len=freeze_bone_len)
    adamw = lambda peak: optax.adamw(lambda k: peak, b1=0.9, b2=0.999,  # noqa: E731
                                     weight_decay=1e-4)
    return optax.chain(jtrainer.clip_with_norm(5.0), optax.multi_transform(
        {"base": adamw(1e-3), "explicit": adamw(1e-2), "frozen": optax.set_to_zero()}, labels))


@pytest.mark.parametrize("freeze_bone_len", [False, True])
def test_opt_state_layout_is_optax_state(trees, freeze_bone_len):
    """opt_state_to_optax of zero moments has the leaves, shapes and
    dtypes of flax's to_state_dict of the JAX trainer's fresh optax state
    (its masked entries: empty dicts), and reads back."""
    from flax import serialization

    model, params = trees["cate"]
    want = serialization.to_state_dict(_jax_tx(params, freeze_bone_len).init(params))
    labels = T.param_labels(model, freeze_bone_len=freeze_bone_len)
    moments = {n: (np.zeros(tuple(p.shape), np.float32),) * 2
               for n, p in model.named_parameters() if labels[n] != "frozen"}
    got = bridge.opt_state_to_optax(moments, labels, 0)
    flat_w, flat_g = dict(bridge._leaves(want)), dict(bridge._leaves(got))
    assert flat_g.keys() == flat_w.keys()
    for k, v in flat_w.items():
        assert np.shape(flat_g[k]) == np.shape(v) and np.asarray(flat_g[k]).dtype == v.dtype, k
    empty = lambda t: {k: empty(v) for k, v in t.items()} if isinstance(t, dict) else 0  # noqa
    assert empty(got) == empty(jax.tree.map(lambda x: 0, want))
    count, back = bridge.opt_state_from_optax(got)
    assert count == 0 and sorted(back) == sorted(moments)


# ---------------------------------------------------------------- the CLI


COMMON = ["--train_res", "16", "--imgs_per_gpu", "4", "--pixels_per_image", "4",
          "--geo_init_steps", "3", "--save_freq", "1", "--eval_res", "8", "--device", "cpu",
          "--fg_motion", "skel-quad"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A two-video category scene and a one-video scene (each video its
    own sphere size); the category model trained one round of 2 steps
    (--nosingle_inst)."""
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("resume")
    db = str(root / "database")
    make_synthetic_dataset(db, seqname="cate", num_vids=2, num_frames=6, res=16,
                           scale_step=0.2)
    make_synthetic_dataset(db, seqname="new", num_vids=1, num_frames=6, res=16, radius=0.6)
    base = COMMON + ["--database_root", db, "--logroot", str(root / "logdir")]

    def train(*argv):
        return train_cli.main(list(argv) + base)

    cate = train("--seqname", "cate", "--logname", "c", "--nosingle_inst", "--num_rounds", "1",
                 "--iters_per_round", "2")
    return {"train": train, "base": base, "cate": cate,
            "ckpt": str(root / "logdir" / "cate-c" / "ckpt_latest.flax")}


def _opts(runs, *argv):
    return parse_opts(train_cli.get_parser(), list(argv) + runs["base"])


def _moments(trainer):
    return {n: (trainer.optimizer.state[p]["exp_avg"].numpy(),
                trainer.optimizer.state[p]["exp_avg_sq"].numpy(),
                float(trainer.optimizer.state[p]["step"]))
            for n, p in zip(trainer.param_names, trainer.params)}


def test_category_cli_trains_per_video_tables(runs):
    trainer = runs["cate"]
    assert trainer.model.num_inst == 2 and trainer.current_steps == 2
    assert trainer.model.state_dict()[CODES].shape == (2, 32)
    assert all(np.isfinite(ld["total"]) for ld in trainer.losses)
    ckpt = bridge.load_flax_checkpoint(runs["ckpt"])
    assert ckpt["manifest"]["opt_state_layout"] == bridge.OPTAX_LAYOUT


def test_port_checkpoint_resumes_in_the_port(runs):
    """--noreset_steps into the same architecture: the Adam moments and
    count equal the saved ones, the step and round continue, and the next
    update takes the schedule at the restored count."""
    saved = _moments(runs["cate"])
    trainer = T.Trainer(_opts(runs, "--seqname", "cate", "--logname", "r", "--nosingle_inst",
                              "--load_path", runs["ckpt"], "--noreset_steps",
                              "--num_rounds", "1", "--iters_per_round", "1"))
    try:
        assert trainer.opt_restored
        assert trainer.current_steps == 2 and trainer.current_round == 1
        got = _moments(trainer)
        assert got.keys() == saved.keys()
        for n, (m, v, c) in saved.items():
            np.testing.assert_array_equal(got[n][0], m)
            np.testing.assert_array_equal(got[n][1], v)
            assert got[n][2] == c == 2.0
        assert trainer.lr_step_offset == 0
        for k, v in runs["cate"].model.state_dict().items():
            torch.testing.assert_close(trainer.model.state_dict()[k], v, rtol=0, atol=0)
    finally:
        trainer.close()


def test_reset_steps_restarts_the_step_count(runs):
    """--reset_steps (the default): step and round from 0, the Adam state
    restored all the same; the schedule reads the restored count."""
    trainer = T.Trainer(_opts(runs, "--seqname", "cate", "--logname", "s", "--nosingle_inst",
                              "--load_path", runs["ckpt"], "--num_rounds", "1",
                              "--iters_per_round", "1"))
    try:
        assert trainer.opt_restored and trainer.current_steps == 0 == trainer.current_round
        assert trainer.lr_step_offset == -2
        assert trainer.sched_kwargs["div_factor"] == 1.0  # the resumed schedule
    finally:
        trainer.close()


def test_port_checkpoint_restores_in_jax(runs):
    """JAX's Trainer._restore_opt_state takes the port's opt_state with no
    mismatch warning, and holds the port's moments in its optax state."""
    from flax import serialization

    ckpt = bridge.load_flax_checkpoint(runs["ckpt"])
    params = ckpt["model"]
    jt = jtrainer.Trainer.__new__(jtrainer.Trainer)
    jt.opt_state = _jax_tx(params).init(params)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jt._restore_opt_state(ckpt["opt_state"]) is True
    assert "mismatch" not in out.getvalue()
    state = serialization.to_state_dict(jt.opt_state)
    adam = state["1"]["inner_states"]["base"]["inner_state"]["0"]
    assert int(adam["count"]) == 2
    saved = _moments(runs["cate"])
    for path, m in bridge._flatten(serialization.to_state_dict(adam["mu"])):
        key, transpose = bridge.flax_to_torch_key(path)
        np.testing.assert_array_equal(np.asarray(m).T if transpose else np.asarray(m),
                                      saved[key][0])
    assert len(list(bridge._flatten(adam["mu"]))) > 50


def test_jax_checkpoint_resumes_in_the_port(runs, tmp_path):
    """A checkpoint with the opt_state JAX's trainer writes (flax's
    to_state_dict of its optax state: random moments, count 7): the port
    restores every moment and the count."""
    from flax import serialization

    ckpt = bridge.load_flax_checkpoint(runs["ckpt"])
    params = ckpt["model"]
    tx = _jax_tx(params)
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda x: np.asarray(rng.random(np.shape(x)), np.float32)
                         if np.ndim(x) else np.asarray(x), tx.init(params))
    sd = serialization.to_state_dict(state)
    for label in ("base", "explicit"):
        sd["1"]["inner_states"][label]["inner_state"]["0"]["count"] = np.asarray(7, np.int32)
    payload = {k: ckpt[k] for k in ("manifest", "model", "geo_state", "proxy")}
    payload["manifest"] = {k: v for k, v in payload["manifest"].items()
                           if k != "opt_state_layout"}
    payload["opt_state"] = jax.tree.map(np.asarray, sd)
    path = tmp_path / "jax.flax"
    path.write_bytes(serialization.msgpack_serialize(payload))
    trainer = T.Trainer(_opts(runs, "--seqname", "cate", "--logname", "j", "--nosingle_inst",
                              "--load_path", str(path), "--noreset_steps", "--num_rounds", "1",
                              "--iters_per_round", "1"))
    try:
        assert trainer.opt_restored and trainer.lr_step_offset == 2 - 7
        got = _moments(trainer)
        for label in ("base", "explicit"):
            adam = sd["1"]["inner_states"][label]["inner_state"]["0"]
            nu = dict(bridge._leaves(adam["nu"]))
            for path_, m in bridge._leaves(adam["mu"]):
                key, transpose = bridge.flax_to_torch_key(path_)
                tr = (lambda a: a.T) if transpose else (lambda a: a)  # noqa: E731
                np.testing.assert_array_equal(got[key][0], tr(m))
                np.testing.assert_array_equal(got[key][1], tr(nu[path_]))
                assert got[key][2] == 7.0
    finally:
        trainer.close()


def test_port_reads_its_earlier_manifest_layout(runs):
    """A checkpoint of the port's earlier layout ({"layout":
    "lab4d_tpu_torch.AdamW", "step", "params": {name: moments}}) restores
    too."""
    trainer = runs["cate"]
    old = {"layout": bridge.PORT_LAYOUT, "step": 2, "params": {
        n: {"exp_avg": m, "exp_avg_sq": v} for n, (m, v, _) in _moments(trainer).items()}}
    fresh = T.Trainer.__new__(T.Trainer)
    fresh.model, fresh.opts, fresh.total_steps = trainer.model, trainer.opts, 2
    fresh.current_steps, fresh.grad_norms = 0, []
    fresh.optimizer_init()
    assert fresh.restore_opt_state(old)
    for n, (m, v, c) in _moments(fresh).items():
        np.testing.assert_array_equal(m, old["params"][n]["exp_avg"])
        assert c == 2.0


@pytest.fixture(scope="module")
def transfer(runs):
    """The category checkpoint into the one-video capture with
    --freeze_bone_len, 2 steps (the category tutorial's second step)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = runs["train"]("--seqname", "new", "--logname", "t", "--load_path",
                                runs["ckpt"], "--freeze_bone_len", "--num_rounds", "1",
                                "--iters_per_round", "2")
    return trainer, out.getvalue()


def test_transfer_loads_the_category_mean(runs, transfer):
    """Per-video tables of the two-video checkpoint become their mean in
    the one-video model, Adam starts afresh (the shapes differ), and the
    steps run from 0."""
    trainer, log = transfer
    assert "optimizer state mismatch; Adam moments reset" in log
    assert not trainer.opt_restored and trainer.current_steps == 2
    ckpt = bridge.load_flax_checkpoint(runs["ckpt"])
    cate = bridge.params_from_flax(ckpt["model"])
    first = bridge.load_flax_checkpoint(
        str(trainer.save_dir) + "/ckpt_0000.flax")  # written before the steps
    got = bridge.params_from_flax(first["model"])
    for key in (CODES, "fields.field_params.fg.camera_mlp.base_quat",
                "intrinsics.base_logfocal"):
        assert cate[key].shape[0] == 2 and got[key].shape[0] == 1
        torch.testing.assert_close(got[key], cate[key].mean(0, keepdim=True))
    torch.testing.assert_close(got["fields.field_params.fg.sdf_head.weight"],
                               cate["fields.field_params.fg.sdf_head.weight"])


def test_freeze_bone_len_keeps_the_bone_lengths(runs, transfer):
    """--freeze_bone_len: the bone-length MLP is unchanged by the steps
    (its code is the category mean), while the rest of the model moves."""
    trainer, _ = transfer
    ckpt = bridge.params_from_flax(bridge.load_flax_checkpoint(runs["ckpt"])["model"])
    state = trainer.model.state_dict()
    bones = [k for k in state if k.startswith(BONES)]
    assert len(bones) >= 6
    for k in bones:
        want = ckpt[k].mean(0, keepdim=True) if "inst_embedding" in k else ckpt[k]
        torch.testing.assert_close(state[k], want)
    assert all(trainer.labels[k] == "frozen" for k in bones)
    assert not torch.equal(state["fields.field_params.fg.sdf_head.weight"],
                           ckpt["fields.field_params.fg.sdf_head.weight"])
