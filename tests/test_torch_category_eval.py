"""Eval, export and the apps of the multi-video category model
(--nosingle_inst) against the JAX package, on the bridged params of a
two-instance fg / skel-quad model over two videos (tests/
test_torch_category.py's make_category):

- evaluate_rays of instance 1 on 64 rays of one of its frames, exact and
  top-k (K = 8; near-tie rays set aside, as tests/test_torch_eval_topk.py),
  with tests/test_torch_render.py's tolerances; instance 1 renders other
  values than instance 0 there;
- reanimation: instance 0 under video 1's joint angles and camera (the
  batch's joint_so3 and field2cam, as reanimate.py builds it);
- export of instance 1: the SDF grid, canonical mesh, the per-frame motion
  of its video and fg-motion.json;
- the render CLI on a category checkpoint written in the JAX trainer's
  format, with a --nosingle_inst opts.log read through --flagfile.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from lab4d_tpu.engine.schedules import compute_sched
from lab4d_tpu.meshlib import marching as jmarching
from lab4d_tpu.utils.quat import se3_to_quaternion_translation
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch import export as pexport
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils import nerf as port_nerf
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_torch_category import make_category
from tests.test_torch_eval_topk import TIE_GAP
from tests.test_torch_export import _recording, _without_flag_classes
from tests.test_torch_render import TOL

torch.set_num_threads(1)  # as tests/test_torch_families.py

N_RAYS = 64
MOTION = "skel-quad"
jexport = _without_flag_classes("export")


@pytest.fixture(scope="module")
def cate():
    for k in ("LAB4D_EVAL_TOPK", "LAB4D_EVAL_CHANNELS", "LAB4D_EVAL_MERGED"):
        assert k not in os.environ, k
    jmodel, jbatch, params = make_category(MOTION)
    params = jax.tree.map(np.asarray, dict(params))
    fi = jmodel.frame_info
    model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                     field_type="fg", fg_motion=MOTION, num_inst=2, device="cpu")
    model.load_state_dict(bridge.params_from_flax(params), strict=True)
    return jmodel, jbatch["geo"], params, model.eval().requires_grad_(False)


def _batch(inst, frameid_sub, seed=0):
    rng = np.random.default_rng(seed)
    hxy = np.concatenate(
        [rng.uniform(0, 64, (1, N_RAYS, 2)), np.ones((1, N_RAYS, 1))], -1).astype(np.float32)
    return {"dataid": np.array([inst], np.int64), "frameid_sub": np.array([frameid_sub], np.int64),
            "crop2raw": np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), "hxy": hxy}


def _jax_eval(cate, batch, env=None):
    jmodel, geo, params, _ = cate
    mp = pytest.MonkeyPatch()
    for k, v in (env or {}).items():
        mp.setenv(k, v)
    try:
        def run(p, b):
            samples = jmodel.apply({"params": p}, b, method=jmodel.prepare_eval_samples)
            return jmodel.apply({"params": p}, samples, sched=None, method=jmodel.evaluate_rays)

        jb = {k: ({c: jnp.asarray(x) for c, x in v.items()} if isinstance(v, dict)
                  else jnp.asarray(v)) for k, v in batch.items()}
        jb["geo"] = geo
        return {k: np.asarray(v) for k, v in jax.jit(run)(params, jb).items()}
    finally:
        mp.undo()


def _port_eval(cate, batch, topk=None):
    """The port's evaluate_rays, and the union weights of the top-k pick."""
    _, geo, _, model = cate
    tb = {k: ({c: torch.tensor(x) for c, x in v.items()} if isinstance(v, dict)
              else torch.tensor(v)) for k, v in batch.items()}
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


INST1 = _batch(1, 3)  # frame 3 of video 1


@pytest.fixture(scope="module")
def exact(cate):
    return _port_eval(cate, INST1)[0], _jax_eval(cate, INST1)


@pytest.fixture(scope="module")
def topk(cate):
    got, weights = _port_eval(cate, INST1, topk=8)
    ws = -np.sort(-weights[0], axis=-1)
    keep = ((ws[:, 7] - ws[:, 8]) > TIE_GAP) | (ws[:, 7] == 0)
    return got, _jax_eval(cate, INST1, {"LAB4D_EVAL_TOPK": "8"}), keep


def _check(got, want, rows=None):
    assert sorted(got) == sorted(want)
    for k in want:
        r = np.ones(got[k].shape[1], bool) if rows is None or k == "mask" else rows
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k][:, r], want[k][:, r], err_msg=k, **TOL[k])


def test_instance_1_exact_eval_matches_jax(exact):
    got, want = exact
    assert float(want["mask"].max()) > 0.1
    _check(got, want)


def test_instance_1_topk_eval_matches_jax(topk):
    got, want, keep = topk
    assert keep.mean() >= 0.9
    _check(got, want, keep)


def test_instances_render_apart(cate, exact):
    """Instance 0 at the same frame and rays (its code, its bone lengths)
    renders other values: the instance id reaches the field."""
    got0 = _port_eval(cate, _batch(0, 3))[0]
    assert float(np.abs(got0["rgb"] - exact[0]["rgb"]).max()) > 1e-4


def test_reanimate_instance_0_with_video_1_motion(cate):
    """Instance 0 driven by video 1's joint angles and camera at one of its
    frames (reanimate.py's batch: dataid the instance, joint_so3 and the fg
    field2cam from the motion): the port's exact eval equals JAX's."""
    jmodel, _, params, _ = cate
    fid = jnp.asarray([8])  # raw frame 2 of video 1
    so3, (quat, trans) = jmodel.apply({"params": params}, method=lambda m: (
        m.fields.field_params["fg"].warp.articulation.get_vals(fid, return_so3=True),
        m.fields.field_params["fg"].camera_mlp.get_vals(fid)))
    from lab4d_tpu.utils.quat import quaternion_translation_to_se3

    se3 = quaternion_translation_to_se3(quat, trans)
    f2c = np.asarray(se3_to_quaternion_translation(se3, tuple_out=False))
    batch = dict(_batch(0, 2, seed=1), joint_so3=np.asarray(so3), field2cam={"fg": f2c})
    got, want = _port_eval(cate, batch)[0], _jax_eval(cate, batch)
    assert float(want["mask"].max()) > 0.1
    _check(got, want)


# ------------------------------------------------------------------ export

GRID = 16


@pytest.fixture(scope="module")
def exported(cate, tmp_path_factory):
    jmodel, geo, params, model = cate
    geo_state = {"fg": {"aabb": np.asarray(geo["fg"]["aabb"])}}
    fi = jmodel.frame_info
    frames = list(fi.frame_mapping[fi.frame_offset[1]:fi.frame_offset[2]])  # video 1
    axes = [np.linspace(-0.2, 0.2, GRID)] * 3
    grid = torch.tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3),
                        dtype=torch.float32)
    with torch.no_grad():
        sdf = model.fields.field_params["fg"].forward(
            grid, inst_id=torch.ones(len(grid), dtype=torch.long), get_density=False)
    opts = {"inst_id": 1, "grid_size": GRID, "level": float(np.median(sdf.numpy()))}
    mp = pytest.MonkeyPatch()
    jstore, pstore = {}, {}
    mp.setattr(jmarching, "marching_cubes", _recording(jmarching.marching_cubes, jstore))
    mp.setattr(pexport, "marching_cubes", _recording(pexport.marching_cubes, pstore))
    try:
        jmesh = jexport.extract_canonical_mesh(jmodel, params, geo_state, "fg", opts)
        pmesh = pexport.extract_canonical_mesh(model, geo_state, "fg", opts)
    finally:
        mp.undo()
    jrest, jmotion = jexport.extract_deformation(jmodel, params, "fg", jmesh, 1, frames, MOTION)
    prest, pmotion = pexport.extract_deformation(
        model, "fg", pexport.Mesh(jmesh.vertices, jmesh.faces), 1, frames)
    root = tmp_path_factory.mktemp("cate_export")
    dirs = {name: str(root / name) for name in ("jax", "port")}
    for d in dirs.values():
        os.makedirs(d)
    jexport.save_motion_params({"fg": jrest}, {"fg": jmotion}, dirs["jax"])
    pexport.save_motion_params({"fg": prest}, {"fg": pmotion}, dirs["port"])
    return dict(jstore=jstore, pstore=pstore, jmesh=jmesh, pmesh=pmesh, dirs=dirs, frames=frames)


def test_instance_1_mesh_matches_jax(exported):
    e = exported
    np.testing.assert_allclose(e["pstore"]["sdf"], e["jstore"]["sdf"], atol=1e-4)
    assert not e["jmesh"].is_empty and e["pmesh"].faces.shape == e["jmesh"].faces.shape
    np.testing.assert_allclose(e["pmesh"].vertices[e["pmesh"].faces],
                               e["jmesh"].vertices[e["jmesh"].faces], atol=1e-4)


def test_instance_1_motion_json_matches_jax(exported):
    dirs = exported["dirs"]
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    load = {k: json.load(open(os.path.join(d, "fg-motion.json"))) for k, d in dirs.items()}
    assert sorted(load["port"]) == sorted(load["jax"])
    for key in load["jax"]:
        a, b = np.asarray(load["port"][key]), np.asarray(load["jax"][key])
        assert a.shape == b.shape and len(a) == len(exported["frames"]), key
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=key)


# --------------------------------------------------------------------- CLI


def test_render_cli_loads_a_jax_category_checkpoint(tmp_path):
    """A checkpoint in the JAX trainer's format (flax msgpack) of a
    two-instance model, and its run's opts.log written by absl with
    --nosingle_inst: `render --flagfile opts.log --inst_id 1` builds the
    model with one code per video and renders instance 1."""
    from absl import app  # noqa: F401  (absl's own flags, as the JAX train CLI writes them)

    import copy

    from lab4d_tpu import config
    from lab4d_tpu_torch import render as R
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    db, logroot = str(tmp_path / "database"), str(tmp_path / "logdir")
    make_synthetic_dataset(db, seqname="cat", num_vids=2, num_frames=4, res=16, scale_step=0.2)
    run = tmp_path / "logdir" / "cat-c"
    run.mkdir(parents=True)
    fv = copy.deepcopy(config.opts)
    fv(["train.py", "--seqname=cat", "--logname=c", "--fg_motion=skel-quad", "--nosingle_inst",
        "--train_res=16", f"--database_root={db}", f"--logroot={logroot}", "--use_cpu"])
    fv.append_flags_into_file(str(run / "opts.log"))
    assert "--nosingle_inst" in (run / "opts.log").read_text().splitlines()

    fi = FrameInfo([0, 4, 8], [0, 4, 8], list(range(8)))
    src = DVRModel(fi, field_type="fg", fg_motion="skel-quad", num_inst=2, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    aabb = np.array([[-0.6] * 3, [0.6] * 3], np.float32)
    corners = np.stack(np.meshgrid(*aabb.T, indexing="ij"), -1).reshape(-1, 3)
    payload = {"manifest": {"format": 1, "current_steps": 0, "current_round": 0},
               "model": bridge.params_to_flax(src.state_dict()),
               "geo_state": {"fg": {"aabb": aabb, "corners": corners,
                                    "near_far": np.tile([[0.5, 4.0]], (8, 1)).astype(np.float32)}},
               "proxy": {"fg": {"vertices": corners, "faces": np.zeros((0, 3), np.int32)}}}
    (run / "ckpt_latest.flax").write_bytes(serialization.msgpack_serialize(payload))

    rendered = R.main([f"--flagfile={run / 'opts.log'}", "--load_suffix", "latest",
                       "--inst_id", "1", "--render_res", "8", "--freeze_id", "0",
                       "--num_frames", "1", "--eval_topk", "0"])
    assert {"rgb", "mask", "depth"} <= set(rendered)
    assert all(v.shape[:3] == (1, 8, 8) and np.isfinite(v).all() for v in rendered.values())
    assert os.path.isdir(run / "renderings_0001" / "ref")
