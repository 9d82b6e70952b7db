"""Eval, export and the train CLI of the comp model (fg and bg composed)
and of the bag of bones, against the JAX package:

- evaluate_rays of the comp model on 64 rays of one frame, exact and
  top-k (K = 8; rays where either field's K-th and (K+1)-th union weights
  nearly tie but are not both zero are set aside; each ray has two
  selections, one per field, and at least 90% of the rays are compared), with tests/test_torch_render.py's tolerances. The fg warp is
  comp_skel-quad_dense here: at init the human skeleton's bone box (the
  fg's valid region) lies off these rays and its fg would render nothing;
  the human skeleton's comp model is the CLI's below and the training
  step's of tests/test_torch_comp.py;
- checkpoints written in the JAX trainer's layout for comp and bob load
  through bridge.load_flax_checkpoint, and the port's exporter gives JAX's
  meshes: every category's canonical mesh, the per-frame meshes, the
  bones (bob: no skeleton, no joint angles) and the instance's rest mesh;
- `python -m lab4d_tpu_torch.train --field_type comp --fg_motion
  comp_skel-human_dense` on a tiny synthetic scene: a checkpoint with
  both fields and a finite eval/psnr; then render (top-k and a bev
  frame), export and reanimate of that checkpoint.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from lab4d_tpu.engine.schedules import compute_sched
from lab4d_tpu.meshlib import marching as jmarching
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch import export as pexport
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils import nerf as port_nerf
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import init_params_with_intrinsics_prior, make_model_and_batch
from tests.test_torch_eval_topk import TIE_GAP
from tests.test_torch_export import _recording, _without_flag_classes
from tests.test_torch_render import TOL

# one torch thread per process: the CPU steps here are small, and with six
# test workers on the host's cores the OpenMP barriers of torch's default
# thread pool stall each small op for whole scheduler slices (process-wide)
torch.set_num_threads(1)

N_RAYS = 64
COMP = ("comp", "comp_skel-human_dense")
TOL_COMP = dict(TOL, mask_bg=TOL["mask_fg"])


EVAL = ("comp", "comp_skel-quad_dense")


@pytest.fixture(scope="module")
def comp_models():
    for k in ("LAB4D_EVAL_TOPK", "LAB4D_EVAL_CHANNELS", "LAB4D_EVAL_MERGED"):
        assert k not in __import__("os").environ, k
    jmodel, jbatch = make_model_and_batch(*EVAL, M=2, N=4)
    params = jax.tree.map(np.asarray, dict(
        init_params_with_intrinsics_prior(jmodel, jbatch, compute_sched(100))["params"]))
    fi = jmodel.frame_info
    model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                     field_type=EVAL[0], fg_motion=EVAL[1], device="cpu")
    model.load_state_dict(bridge.params_from_flax(params), strict=True)
    rng = np.random.default_rng(0)
    hxy = np.concatenate(
        [rng.uniform(0, 64, (1, N_RAYS, 2)), np.ones((1, N_RAYS, 1))], -1).astype(np.float32)
    batch = {"dataid": np.zeros(1, np.int64), "frameid_sub": np.array([3], np.int64),
             "crop2raw": np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), "hxy": hxy}
    return jmodel, jbatch["geo"], params, model.eval().requires_grad_(False), batch


def _jax_eval(comp_models, env):
    jmodel, geo, params, _, batch = comp_models
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        def run(p, b):
            samples = jmodel.apply({"params": p}, b, method=jmodel.prepare_eval_samples)
            return jmodel.apply({"params": p}, samples, sched=None, method=jmodel.evaluate_rays)

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["geo"] = geo
        return {k: np.asarray(v) for k, v in jax.jit(run)(params, jb).items()}
    finally:
        mp.undo()


def _port_eval(comp_models, topk=None):
    """The port's evaluate_rays, and each field's union weights with topk."""
    _, geo, _, model, batch = comp_models
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["geo"] = {c: {k: torch.tensor(np.asarray(v)) for k, v in g.items()} for c, g in geo.items()}
    seen = []
    orig = port_nerf.topk_indices

    def record(weights, k):
        seen.append(weights.numpy().reshape(-1, weights.shape[-1]))
        return orig(weights, k)

    port_nerf.topk_indices = record
    try:
        with torch.no_grad():
            out = model.evaluate_rays(model.prepare_eval_samples(tb), topk=topk)
    finally:
        port_nerf.topk_indices = orig
    return {k: v.numpy() for k, v in out.items()}, seen


@pytest.fixture(scope="module")
def comp_exact(comp_models):
    return _port_eval(comp_models)[0], _jax_eval(comp_models, {})


@pytest.fixture(scope="module")
def comp_topk(comp_models):
    got, weights = _port_eval(comp_models, topk=8)
    assert len(weights) == 2  # one top-k selection per field
    keep = np.ones(N_RAYS, bool)
    for w in weights:
        ws = -np.sort(-w, axis=-1)
        keep &= ((ws[:, 7] - ws[:, 8]) > TIE_GAP) | (ws[:, 7] == 0)
    return got, _jax_eval(comp_models, {"LAB4D_EVAL_TOPK": "8"}), keep


def test_comp_eval_channels(comp_exact):
    got, want = comp_exact
    assert sorted(got) == sorted(want) == sorted(TOL_COMP)
    assert 0.1 < float(want["mask"].max()) <= 1.0 + 1e-6
    assert float(want["mask_fg"].max()) > 0.01 and float(want["mask_bg"].max()) > 0.01


@pytest.mark.parametrize("channel", sorted(TOL_COMP))
def test_comp_exact_eval_matches_jax(comp_exact, channel):
    got, want = comp_exact
    assert got[channel].shape == want[channel].shape and np.isfinite(got[channel]).all()
    np.testing.assert_allclose(got[channel], want[channel], err_msg=channel, **TOL_COMP[channel])


@pytest.mark.parametrize("channel", sorted(TOL_COMP))
def test_comp_topk_eval_matches_jax(comp_topk, channel):
    got, want, keep = comp_topk
    assert sorted(got) == sorted(want)
    assert keep.mean() >= 0.9
    rows = np.ones(N_RAYS, bool) if channel == "mask" else keep
    np.testing.assert_allclose(got[channel][:, rows], want[channel][:, rows], err_msg=channel,
                               **TOL_COMP[channel])


# ------------------------------------------------------------------ export

jexport = _without_flag_classes("export")
GRID = 16
FRAMES = [0, 5, 9]


def _write_jax_checkpoint(path, params, geo_state):
    """A checkpoint as the JAX trainer writes it (flax msgpack)."""
    payload = {"manifest": {"format": 1, "current_steps": 0, "current_round": 0},
               "model": params, "geo_state": geo_state}
    path.write_bytes(serialization.msgpack_serialize(payload))


@pytest.fixture(scope="module", params=[COMP, ("fg", "bob")], ids=["comp", "bob"])
def exported(request, tmp_path_factory):
    field_type, motion = request.param
    jmodel, jbatch = make_model_and_batch(field_type, motion, M=2, N=4)
    params = jax.tree.map(np.asarray, dict(
        init_params_with_intrinsics_prior(jmodel, jbatch, compute_sched(100))["params"]))
    geo_state = {c: {"aabb": np.asarray(g["aabb"])} for c, g in jbatch["geo"].items()}
    path = tmp_path_factory.mktemp(motion) / "ckpt_latest.flax"
    _write_jax_checkpoint(path, params, geo_state)
    ckpt = bridge.load_flax_checkpoint(str(path))
    fi = jmodel.frame_info
    model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                     field_type=field_type, fg_motion=motion, device="cpu")
    model.load_state_dict(bridge.params_from_flax(ckpt["model"]), strict=True)
    model.eval().requires_grad_(False)

    axes = [np.linspace(-0.2, 0.2, GRID)] * 3
    grid = torch.tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3),
                        dtype=torch.float32)
    out = {"motion": motion, "cates": {}}
    for cate in ckpt["geo_state"]:
        with torch.no_grad():
            sdf = model.fields.field_params[cate].forward(
                grid, inst_id=torch.zeros(len(grid), dtype=torch.long), get_density=False)
        opts = {"inst_id": 0, "grid_size": GRID, "level": float(np.median(sdf.numpy()))}
        mp = pytest.MonkeyPatch()
        jstore, pstore = {}, {}
        mp.setattr(jmarching, "marching_cubes", _recording(jmarching.marching_cubes, jstore))
        mp.setattr(pexport, "marching_cubes", _recording(pexport.marching_cubes, pstore))
        try:
            jmesh = jexport.extract_canonical_mesh(jmodel, params, ckpt["geo_state"], cate, opts)
            pmesh = pexport.extract_canonical_mesh(model, ckpt["geo_state"], cate, opts)
        finally:
            mp.undo()
        jrest, jmotion = jexport.extract_deformation(jmodel, params, cate, jmesh, 0, FRAMES,
                                                     motion)
        prest, pmotion = pexport.extract_deformation(
            model, cate, pexport.Mesh(jmesh.vertices, jmesh.faces), 0, FRAMES)
        out["cates"][cate] = dict(jstore=jstore, pstore=pstore, jmesh=jmesh, pmesh=pmesh,
                                  jrest=jrest, prest=prest, jmotion=jmotion, pmotion=pmotion)
    return out


def test_export_covers_every_category(exported):
    want = ["bg", "fg"] if exported["motion"] == COMP[1] else ["fg"]
    assert sorted(exported["cates"]) == want


def test_exported_meshes_match_jax(exported):
    for cate, e in exported["cates"].items():
        np.testing.assert_allclose(e["pstore"]["sdf"], e["jstore"]["sdf"], atol=1e-4,
                                   err_msg=cate)
        assert not e["jmesh"].is_empty and e["pmesh"].faces.shape == e["jmesh"].faces.shape
        np.testing.assert_allclose(e["pmesh"].vertices[e["pmesh"].faces],
                                   e["jmesh"].vertices[e["jmesh"].faces], atol=1e-4)
        np.testing.assert_allclose(e["prest"].vertices, np.asarray(e["jrest"].vertices),
                                   atol=1e-4, err_msg=cate)


def test_exported_motion_matches_jax(exported):
    bob = exported["motion"] == "bob"
    for cate, e in exported["cates"].items():
        skinned = cate == "fg"
        for fid in FRAMES:
            j, p = e["jmotion"][fid], e["pmotion"][fid]
            for a, b in zip(p.field2cam, j.field2cam):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
            assert (p.t_articulation is None) == (j.t_articulation is None) == (not skinned)
            assert (p.so3 is None) == (j.so3 is None) == (bob or not skinned)
            if skinned:
                for a, b in zip(p.t_articulation, j.t_articulation):
                    np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
                np.testing.assert_allclose(p.bone_t.vertices, j.bone_t.vertices, atol=1e-4)
                assert p.bone_t.faces.shape == j.bone_t.faces.shape
            if not bob and skinned:
                np.testing.assert_allclose(p.so3, np.asarray(j.so3), atol=1e-5)
            np.testing.assert_allclose(p.mesh_t.vertices, np.asarray(j.mesh_t.vertices),
                                       atol=1e-4, err_msg=f"{cate} {fid}")


# --------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def comp_cli_run(tmp_path_factory):
    from lab4d_tpu_torch import train as train_cli
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("train_comp_cli")
    make_synthetic_dataset(str(root / "database"), seqname="sc", num_frames=8, res=16)
    trainer = train_cli.main([
        "--field_type", COMP[0], "--fg_motion", COMP[1], "--seqname", "sc", "--logname", "t",
        "--train_res", "16", "--num_rounds", "1", "--iters_per_round", "2", "--imgs_per_gpu", "4",
        "--pixels_per_image", "4", "--geo_init_steps", "3", "--save_freq", "1", "--eval_res", "8",
        "--device", "cpu", "--database_root", str(root / "database"),
        "--logroot", str(root / "logdir"),
    ])
    return trainer, root


def test_comp_cli_writes_a_checkpoint_and_eval_metrics(comp_cli_run):
    trainer, root = comp_cli_run
    run_dir = root / "logdir" / "sc-t"
    assert trainer.categories == ("fg", "bg")
    assert trainer.current_steps == 2 and all(np.isfinite(ld["total"]) for ld in trainer.losses)
    assert trainer.losses[0]["reg_soft_deform"] > 0
    ckpt = bridge.load_flax_checkpoint(str(run_dir / "ckpt_latest.flax"))
    assert sorted(ckpt["geo_state"]) == sorted(ckpt["proxy"]) == ["bg", "fg"]
    state = bridge.params_from_flax(ckpt["model"])
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy())
    evals = [r for r in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
             if "eval/psnr" in r]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval/psnr"])


def test_comp_geometry_pools(comp_cli_run):
    """The fg distils the rest-pose bone spheres, the bg its proxy mesh."""
    trainer, _ = comp_cli_run
    pools = trainer._build_geometry_pools(num_steps=2, nsample=8)
    assert sorted(pools) == ["bg", "fg"]
    warp = trainer.model.fields.field_params["fg"].warp
    with torch.no_grad():
        want = warp.get_gauss_sdf(pools["fg"]["pts"].reshape(-1, 3)).reshape(2, 8, 1)
    torch.testing.assert_close(pools["fg"]["sdf_gt"], want)


@pytest.mark.parametrize("viewpoint", ["ref", "bev-30"])
def test_comp_cli_checkpoint_renders(comp_cli_run, viewpoint):
    from lab4d_tpu_torch import render as R

    _, root = comp_cli_run
    rendered = R.main(["--field_type", COMP[0], "--fg_motion", COMP[1], "--seqname", "sc",
                       "--logname", "t", "--train_res", "16", "--load_suffix", "latest",
                       "--render_res", "8", "--viewpoint", viewpoint, "--freeze_id", "0",
                       "--num_frames", "2", "--device", "cpu", "--database_root",
                       str(root / "database"), "--logroot", str(root / "logdir")])
    assert {"rgb", "mask", "mask_fg", "mask_bg", "depth"} <= set(rendered)
    for k, v in rendered.items():
        assert v.shape[:3] == (2, 8, 8) and np.isfinite(v).all(), k


def test_comp_cli_checkpoint_exports_and_reanimates(comp_cli_run):
    from lab4d_tpu_torch import reanimate

    _, root = comp_cli_run
    common = ["--field_type", COMP[0], "--fg_motion", COMP[1], "--seqname", "sc", "--logname",
              "t", "--train_res", "16", "--load_suffix", "latest", "--device", "cpu",
              "--database_root", str(root / "database"), "--logroot", str(root / "logdir")]
    out = pexport.main(common + ["--grid_size", "16"])
    names = set(__import__("os").listdir(out))
    assert {"fg.obj", "bg.obj", "fg-motion.json", "bg-motion.json"} <= names
    motion = json.load(open(f"{out}/fg-motion.json"))
    assert len(motion["joint_so3"]) == len(motion["field2cam"]) > 0
    rendered = reanimate.main(common + ["--render_res", "8", "--motion_id", "0"])
    assert len(rendered["rgb"]) == len(motion["field2cam"])
    assert all(np.isfinite(v).all() for v in rendered.values())
