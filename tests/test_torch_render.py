"""The slice as a whole: rendering the flagship fg / skel-quad model.

- parity: the JAX DVRModel (built as tests/test_model.py builds it, with
  the trainer's intrinsics prior) and the port's DVRModel with the
  bridged params render the same 64 rays of one frame through
  prepare_eval_samples + evaluate_rays (exact merged eval); every
  returned channel is compared;
- CLI: `python -m lab4d_tpu_torch.render` renders a tests/synthetic.py
  scene from a .flax checkpoint in the JAX trainer's layout (top-k 8 by
  default, --render_keys, bev of a bg checkpoint), and
  `python -m lab4d_tpu_torch.export` / `reanimate` run on it.

Tolerances (fp32 on both sides, sums in other orders): rgb, mask, vis,
feature and the other bounded channels atol 1e-4; depth rtol 1e-4;
normal atol 1e-3 and eikonal rtol 5e-3, since both come from the SDF's
input gradient, which the Fourier phases of the 10-octave embedding
amplify (docs/qa.md).
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
from lab4d_tpu_torch import render as R
from lab4d_tpu_torch.bridge import params_from_flax
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import init_params_with_intrinsics_prior, make_model_and_batch

N_RAYS = 64
TOL = {
    "rgb": dict(atol=1e-4), "mask": dict(atol=1e-4), "vis": dict(atol=1e-4),
    "feature": dict(atol=1e-4), "depth": dict(rtol=1e-4, atol=0),
    "normal": dict(atol=1e-3), "eikonal": dict(rtol=5e-3, atol=0),
    "mask_fg": dict(atol=1e-4), "gauss_mask": dict(atol=1e-4), "xyz": dict(atol=1e-4),
    "xyz_cam": dict(atol=1e-4), "cyc_dist": dict(atol=1e-4),
    "skin_entropy": dict(atol=1e-4), "delta_skin": dict(atol=1e-4),
}


@pytest.fixture(scope="module")
def jax_flagship(monkeypatch_module):
    monkeypatch_module.delenv("LAB4D_EVAL_TOPK", raising=False)
    monkeypatch_module.delenv("LAB4D_EVAL_CHANNELS", raising=False)
    monkeypatch_module.delenv("LAB4D_EVAL_MERGED", raising=False)
    model, batch = make_model_and_batch("fg", "skel-quad", M=2, N=4)
    variables = init_params_with_intrinsics_prior(model, batch, compute_sched(100))
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    return model, batch["geo"], params


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def port_model(jmodel, params):
    fi = jmodel.frame_info
    model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                     fg_motion="skel-quad", device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def rendered_both(jax_flagship):
    jmodel, geo, params = jax_flagship
    rng = np.random.default_rng(0)
    hxy = np.concatenate(
        [rng.uniform(0, 64, (1, N_RAYS, 2)), np.ones((1, N_RAYS, 1))], -1
    ).astype(np.float32)
    batch = {"dataid": np.zeros(1, np.int64), "frameid_sub": np.array([3], np.int64),
             "crop2raw": np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), "hxy": hxy}

    def jax_eval(p, b):
        samples = jmodel.apply({"params": p}, b, method=jmodel.prepare_eval_samples)
        return jmodel.apply({"params": p}, samples, sched=None, method=jmodel.evaluate_rays)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["geo"] = geo
    want = {k: np.asarray(v) for k, v in jax.jit(jax_eval)(params, jb).items()}

    model = port_model(jmodel, params)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["geo"] = {"fg": {k: torch.tensor(np.asarray(v)) for k, v in geo["fg"].items()}}
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model.evaluate_rays(model.prepare_eval_samples(tb)).items()}
    return got, want


def test_same_channels(rendered_both):
    got, want = rendered_both
    assert sorted(got) == sorted(want) == sorted(TOL)
    # the comparison is not vacuous: the rays hit the object
    assert 0.1 < float(want["mask"].max()) <= 1.0


@pytest.mark.parametrize("channel", sorted(TOL))
def test_slice_parity(rendered_both, channel):
    got, want = rendered_both
    assert got[channel].shape == want[channel].shape
    assert np.isfinite(got[channel]).all()
    np.testing.assert_allclose(got[channel], want[channel], err_msg=channel, **TOL[channel])


def test_cpu_never_launches_the_kernel(jax_flagship):
    from lab4d_tpu_torch.ops.mlp_kernel import fused_relu_mlp

    jmodel, _, params = jax_flagship
    model = port_model(jmodel, params)
    launches = fused_relu_mlp.launches
    with torch.no_grad():
        quat, trans = model.fields.field_params["fg"].camera_mlp.get_vals()
    assert fused_relu_mlp.launches == launches
    assert torch.isfinite(quat).all() and torch.isfinite(trans).all()


@pytest.fixture(scope="module")
def cli_scene(jax_flagship, tmp_path_factory):
    """A tests/synthetic.py scene (one video of 8 frames, the same param
    shapes as the fixture's model) and a checkpoint written the way
    Trainer.save_checkpoint writes it."""
    from lab4d_tpu.meshlib import uv_sphere
    from tests.synthetic import make_synthetic_dataset

    _, _, params = jax_flagship
    root = tmp_path_factory.mktemp("cli")
    make_synthetic_dataset(str(root / "database"), seqname="simq", num_vids=1,
                           num_frames=8, res=16)
    proxy = uv_sphere(radius=0.12, count=[4, 4])
    payload = {
        "manifest": {"format": 1, "current_steps": 0, "current_round": 0},
        "model": params,
        "geo_state": {"fg": {
            "aabb": proxy.bounds.astype(np.float32),
            "near_far": np.tile(np.array([0.1, 2.0], np.float32), (8, 1)),
            "corners": proxy.corners().astype(np.float32),
        }},
        "proxy": {"fg": {"vertices": np.asarray(proxy.vertices, np.float32),
                         "faces": np.asarray(proxy.faces, np.int32)}},
    }
    logdir = root / "logdir" / "simq-e2e"
    logdir.mkdir(parents=True)
    (logdir / "ckpt_latest.flax").write_bytes(serialization.msgpack_serialize(payload))
    return root


@pytest.mark.parametrize("viewpoint", ["ref", "rot-0-360", "bev-30"])
def test_cli_renders_a_jax_checkpoint(cli_scene, viewpoint):
    """The CLI renders 2 frames of the scene from each viewpoint kind."""
    rendered = R.main([
        "--seqname", "simq", "--logname", "e2e", "--fg_motion", "skel-quad",
        "--train_res", "16", "--load_suffix", "latest", "--render_res", "8",
        "--viewpoint", viewpoint, "--freeze_id", "0", "--num_frames", "2", "--device", "cpu",
        "--database_root", str(cli_scene / "database"), "--logroot", str(cli_scene / "logdir"),
    ])
    assert {"rgb", "mask", "depth", "normal", "feature", "vis"} <= set(rendered)
    for k, v in rendered.items():
        assert v.shape[:3] == (2, 8, 8) and np.isfinite(v).all(), k
    assert (rendered["mask"] >= 0).all() and (rendered["mask"] <= 1 + 1e-6).all()
    out_dir = cli_scene / "logdir" / "simq-e2e" / "renderings_0000" / viewpoint
    assert any(name.startswith("rgb") for name in os.listdir(out_dir))


CLI_COMMON = ["--seqname", "simq", "--logname", "e2e", "--fg_motion", "skel-quad",
              "--train_res", "16", "--load_suffix", "latest", "--device", "cpu"]


def _cli_args(root):
    return CLI_COMMON + ["--database_root", str(root / "database"),
                         "--logroot", str(root / "logdir")]


def test_cli_defaults_to_topk8_and_renders_key_subsets(cli_scene, jax_flagship):
    """With no --eval_topk the CLI renders the top-k eval at K = 8 (its
    frames equal render_batch's with topk=8, and differ from the exact
    eval's); --render_keys rgb,mask returns those channels alone, equal to
    the full render's."""
    args = _cli_args(cli_scene) + ["--render_res", "8", "--freeze_id", "1", "--num_frames", "1"]
    assert R.get_parser().parse_args([]).eval_topk == 8
    full = R.main(args)
    keys = R.main(args + ["--render_keys", "rgb,mask"])
    exact = R.main(args + ["--eval_topk", "0"])
    assert sorted(keys) == ["mask", "rgb"]
    for k, v in keys.items():
        np.testing.assert_allclose(v, full[k], rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(full["mask"], exact["mask"], atol=1e-4)

    opts = vars(R.get_parser().parse_args(args))
    model, geo_state, data_info = R.construct_test_model(opts, torch.device("cpu"))
    batch, _ = R.construct_batch_from_opts(opts, model, geo_state, data_info, "cpu")
    for topk, want in ((8, full), (None, exact)):
        direct = R.render_batch(model, batch, geo_state, topk=topk)
        for k in ("rgb", "depth"):
            np.testing.assert_allclose(want[k], direct[k], atol=1e-6, err_msg=k)
    assert float(full["mask"].max()) > 0.1
    assert not np.allclose(full["rgb"], exact["rgb"], atol=1e-6)


@pytest.fixture(scope="module")
def cli_scene_bg(cli_scene):
    """A bg checkpoint of tests/test_model.py's bg model beside cli_scene's
    fg one (logname e2e-bg)."""
    jmodel, bbatch = make_model_and_batch("bg", M=2, N=4)
    params = jax.tree.map(np.asarray, dict(init_params_with_intrinsics_prior(
        jmodel, bbatch, compute_sched(100))["params"]))
    from lab4d_tpu.meshlib import uv_sphere

    proxy = uv_sphere(radius=0.5, count=[4, 4])
    payload = {
        "manifest": {"format": 1, "current_steps": 0, "current_round": 0},
        "model": params,
        "geo_state": {"bg": {
            "aabb": proxy.bounds.astype(np.float32),
            "near_far": np.tile(np.array([0.1, 4.0], np.float32), (8, 1)),
            "corners": proxy.corners().astype(np.float32),
        }},
        "proxy": {"bg": {"vertices": np.asarray(proxy.vertices, np.float32),
                         "faces": np.asarray(proxy.faces, np.int32)}},
    }
    logdir = cli_scene / "logdir" / "simq-e2e-bg"
    logdir.mkdir(parents=True)
    (logdir / "ckpt_latest.flax").write_bytes(serialization.msgpack_serialize(payload))
    return cli_scene


def test_cli_renders_bev_of_a_bg_checkpoint(cli_scene_bg):
    args = _cli_args(cli_scene_bg) + ["--field_type", "bg", "--logname", "e2e-bg",
                                      "--render_res", "8", "--viewpoint", "bev-30",
                                      "--freeze_id", "0", "--num_frames", "2"]
    rendered = R.main(args)
    assert {"rgb", "mask", "depth", "normal", "vis"} <= set(rendered)
    for k, v in rendered.items():
        assert v.shape[:3] == (2, 8, 8) and np.isfinite(v).all(), k
    assert os.listdir(cli_scene_bg / "logdir" / "simq-e2e-bg" / "renderings_0000" / "bev-30")


@pytest.mark.parametrize("logname,field_type", [("e2e", "fg"), ("e2e-bg", "bg")])
def test_cli_exports(cli_scene_bg, logname, field_type):
    """`python -m lab4d_tpu_torch.export` at --grid_size 16: the rest mesh,
    a mesh per frame (and bones for the skeleton), <cate>-motion.json."""
    from lab4d_tpu_torch import export as E

    out = E.main(_cli_args(cli_scene_bg) + ["--logname", logname, "--field_type", field_type,
                                            "--grid_size", "16"])
    assert out == str(cli_scene_bg / "logdir" / f"simq-{logname}" / "export_0000")
    names = set(os.listdir(out))
    motion = json.load(open(os.path.join(out, f"{field_type}-motion.json")))
    assert sorted(motion) == ["field2cam", "joint_so3", "t_articulation"]
    assert np.asarray(motion["field2cam"]).shape == (8, 4, 4)
    assert {f"{field_type}.obj"} | {f"{field_type}-{i:05d}.obj" for i in range(8)} <= names
    if field_type == "fg":
        assert np.asarray(motion["joint_so3"]).shape == (8, 25, 3)
        assert np.asarray(motion["t_articulation"]).shape == (8, 25, 4, 4)
    for v in motion.values():
        assert np.isfinite(np.asarray(v)).all()


def test_cli_reanimates(cli_scene_bg):
    """`python -m lab4d_tpu_torch.reanimate --motion_id 0` renders the fg
    model under the motion its export wrote."""
    from lab4d_tpu_torch import export as E
    from lab4d_tpu_torch import reanimate as RA

    args = _cli_args(cli_scene_bg)
    E.main(args + ["--grid_size", "16"])
    rendered = RA.main(args + ["--motion_id", "0", "--render_res", "8", "--freeze_id", "0",
                               "--render_keys", "rgb,mask"])
    assert sorted(rendered) == ["mask", "rgb"]
    assert rendered["rgb"].shape == (8, 8, 8, 3) and np.isfinite(rendered["rgb"]).all()


def test_render_batch_chunking(jax_flagship):
    """Rays rendered in chunks of 20 equal rays rendered at once, except
    the vis channel, whose BCE is normalized by each chunk's mean
    transmittance (as in the JAX package). fp32, other matmul blockings:
    atol 1e-5."""
    from lab4d_tpu_torch.utils.cam_traj import construct_batch
    from lab4d_tpu_torch.utils.geom import K2inv

    jmodel, geo, params = jax_flagship
    model = port_model(jmodel, params)
    batch = construct_batch(0, [3], 8, None, None, np.array([[1.0, 1.0, 0.0, 0.0]]))
    batch["Kinv"] = K2inv(torch.tensor([[12.0, 12.0, 4.0, 4.0]]))
    geo_state = {"fg": {"aabb": np.asarray(geo["fg"]["aabb"]),
                        "corners": np.asarray(geo["fg"]["proxy_corners"])}}
    whole = R.render_batch(model, batch, geo_state, chunk=64)
    chunked = R.render_batch(model, batch, geo_state, chunk=20)
    assert sorted(whole) == sorted(chunked)
    assert float(whole["mask"].max()) > 0.1
    for k in whole:
        assert whole[k].shape == (1, 8, 8, whole[k].shape[-1]) and np.isfinite(chunked[k]).all()
        if k != "vis":
            np.testing.assert_allclose(chunked[k], whole[k], atol=1e-5, err_msg=k)


# per sample, unlike the integrated channels above: deltas are differences
# of depths that agree to ~1e-7, hence an absolute floor; eikonal and
# normal come from the SDF gradient (relative error ~1e-4 after the
# Fourier phases), which (|g| - 1)^2 and g / |g| amplify where |g| is
# near 1 or small
FIELD_TOL = {
    "depth": dict(rtol=1e-4, atol=0), "deltas": dict(rtol=1e-4, atol=1e-6),
    "eikonal": dict(rtol=5e-3, atol=1e-4), "normal": dict(atol=5e-3),
    "xyz": dict(atol=1e-4), "xyz_fwd_cam": dict(atol=1e-4),
}


@pytest.fixture(scope="module")
def field_methods_both(jax_flagship):
    """importance_sampling, compute_normal, backward_warp and forward_warp
    of the fg field at the samples prepare_eval_samples makes, both
    packages."""
    jmodel, geo, params = jax_flagship
    rng = np.random.default_rng(1)
    hxy = np.concatenate(
        [rng.uniform(0, 64, (1, 16, 2)), np.ones((1, 16, 1))], -1).astype(np.float32)
    batch = {"dataid": np.zeros(1, np.int64), "frameid_sub": np.array([5], np.int64),
             "crop2raw": np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), "hxy": hxy}

    def run(field, s):
        args = (s["field2cam"], s["frame_id"], s["inst_id"], s)
        xyz_cam, dir_cam, deltas, depth = field.importance_sampling(
            s["hxy"], s["Kinv"], s["near_far"], *args)
        eikonal, normal = field.compute_normal(xyz_cam, dir_cam, *args)
        xyz = field.backward_warp(xyz_cam, dir_cam, *args)["xyz"]
        fwd = field.forward_warp(xyz, *args)
        return {"depth": depth, "deltas": deltas, "eikonal": eikonal, "normal": normal,
                "xyz": xyz, "xyz_fwd_cam": fwd}

    def jax_run(p, b):
        samples = jmodel.apply({"params": p}, b, method=jmodel.prepare_eval_samples)
        return jmodel.apply({"params": p}, samples["fg"],
                            method=lambda m, s: run(m.fields.field_params["fg"], s))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["geo"] = geo
    want = {k: np.asarray(v) for k, v in jax.jit(jax_run)(params, jb).items()}
    model = port_model(jmodel, params)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["geo"] = {"fg": {k: torch.tensor(np.asarray(v)) for k, v in geo["fg"].items()}}
    with torch.no_grad():
        samples = model.prepare_eval_samples(tb)["fg"]
        got = {k: v.numpy() for k, v in run(model.fields.field_params["fg"], samples).items()}
    return got, want


@pytest.mark.parametrize("name", sorted(FIELD_TOL))
def test_field_methods_match_jax(field_methods_both, name):
    got, want = field_methods_both
    assert got[name].shape == want[name].shape
    np.testing.assert_allclose(got[name], want[name], err_msg=name, **FIELD_TOL[name])


def test_port_imports_without_jax():
    """The card has no jax, flax, absl or msgpack: the port must import
    with all four unavailable."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'absl', 'msgpack'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import lab4d_tpu_torch.render, lab4d_tpu_torch.bridge, lab4d_tpu_torch.ops.build\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax') for m in sys.modules)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
