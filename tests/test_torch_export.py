"""Export and reanimate: the port's export.py and reanimate.py against the
JAX package's, on the same bridged params, for the fg / skel-quad, fg /
rigid and bg models of tests/test_model.py.

- the canonical SDF grid (marching_cubes' input) within 1e-4, and the
  meshes: equal vertex and face counts, each face's vertices within 1e-4
  (the grids agree in sign at every point, checked first); the level is
  the grid's median, so that the random field has a surface;
- per frame: field2cam, t_articulation and the joint angles within 1e-5,
  the forward-warped mesh within 1e-4; the rest mesh after the
  instance's morphology within 1e-4;
- `<cate>-motion.json`: the same keys, lengths and values within 1e-5,
  and the same obj files;
- reanimate: a json written by the JAX exporter drives the port's render
  batch, whose t_articulation equals JAX's get_vals(override_so3=...).
"""

import ast
import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lab4d_tpu
from lab4d_tpu.engine.schedules import compute_sched
from lab4d_tpu.meshlib import marching as jmarching
from lab4d_tpu_torch import export as pexport
from lab4d_tpu_torch.bridge import params_from_flax
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import init_params_with_intrinsics_prior, make_model_and_batch

def _without_flag_classes(name):
    """lab4d_tpu/<name>.py's functions, without the class bodies that
    define its absl flags at import: the JAX CLIs define the same flag
    names (export's and render's --inst_id), which absl refuses twice in
    one process, and other test files import lab4d_tpu.render."""
    path = os.path.join(os.path.dirname(lab4d_tpu.__file__), f"{name}.py")
    tree = ast.parse(open(path).read(), path)
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.ClassDef) and n.name.endswith("Flags"))]
    module = types.ModuleType(f"lab4d_tpu_{name}_functions")
    module.__file__ = path
    exec(compile(tree, path, "exec"), module.__dict__)
    return module


jexport = _without_flag_classes("export")

CASES = {"fg-skel-quad": ("fg", "skel-quad"), "fg-rigid": ("fg", "rigid"), "bg": ("bg", "rigid")}
GRID = 24
FRAMES = [0, 4, 9]


def _recording(fn, store):
    """marching_cubes that keeps its SDF grid in store["sdf"]."""
    def wrapped(sdf_func, *args, **kwargs):
        vals = []

        def rec(pts):
            out = np.asarray(sdf_func(pts)).reshape(-1)
            vals.append(out)
            return out

        mesh = fn(rec, *args, **kwargs)
        store["sdf"] = np.concatenate(vals)
        return mesh
    return wrapped


@pytest.fixture(scope="module", params=sorted(CASES))
def exported(request, tmp_path_factory):
    """Both packages' canonical mesh, per-frame motion and written files
    for one model."""
    cate, motion = CASES[request.param]
    jmodel, jbatch = make_model_and_batch(cate, motion, M=2, N=4)
    params = jax.tree.map(np.asarray, dict(
        init_params_with_intrinsics_prior(jmodel, jbatch, compute_sched(100))["params"]))
    fi = jmodel.frame_info
    model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                     field_type=cate, fg_motion=motion, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    model.eval().requires_grad_(False)
    geo_state = {cate: {"aabb": np.asarray(jbatch["geo"][cate]["aabb"])}}

    # the level: the median SDF of the grid, so that the random field has a surface
    axes = [np.linspace(-0.2, 0.2, GRID)] * 3
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    field = model.fields.field_params[cate]
    with torch.no_grad():
        level = float(np.median(field.forward(torch.tensor(grid), inst_id=torch.zeros(
            len(grid), dtype=torch.long), get_density=False).numpy()))
    opts = {"inst_id": 0, "grid_size": GRID, "level": level}

    mp = pytest.MonkeyPatch()
    jstore, pstore = {}, {}
    mp.setattr(jmarching, "marching_cubes", _recording(jmarching.marching_cubes, jstore))
    mp.setattr(pexport, "marching_cubes", _recording(pexport.marching_cubes, pstore))
    try:
        jmesh = jexport.extract_canonical_mesh(jmodel, params, geo_state, cate, opts)
        pmesh = pexport.extract_canonical_mesh(model, geo_state, cate, opts)
    finally:
        mp.undo()

    # the same rest mesh into both packages' deformation
    jrest, jmotion = jexport.extract_deformation(jmodel, params, cate, jmesh, 0, FRAMES, motion)
    prest, pmotion = pexport.extract_deformation(model, cate, pmesh.copy(), 0, FRAMES)
    prest_j, pmotion_j = pexport.extract_deformation(
        model, cate, pexport.Mesh(jmesh.vertices, jmesh.faces), 0, FRAMES)

    root = tmp_path_factory.mktemp(request.param)
    dirs = {name: str(root / name) for name in ("jax", "port")}
    for d in dirs.values():
        os.makedirs(d)
    jexport.save_motion_params({cate: jrest}, {cate: jmotion}, dirs["jax"])
    pexport.save_motion_params({cate: prest}, {cate: pmotion}, dirs["port"])
    return {"case": request.param, "cate": cate, "motion": motion, "jmodel": jmodel,
            "params": params, "model": model, "jstore": jstore, "pstore": pstore,
            "jmesh": jmesh, "pmesh": pmesh, "jrest": jrest, "prest_j": prest_j,
            "jmotion": jmotion, "pmotion_j": pmotion_j, "dirs": dirs}


def test_sdf_grid_matches_jax(exported):
    j, p = exported["jstore"]["sdf"], exported["pstore"]["sdf"]
    assert j.shape == p.shape == (GRID**3,)
    np.testing.assert_allclose(p, j, atol=1e-4)


def test_canonical_mesh_matches_jax(exported):
    jmesh, pmesh = exported["jmesh"], exported["pmesh"]
    lvl_j, lvl_p = exported["jstore"]["sdf"], exported["pstore"]["sdf"]
    assert not jmesh.is_empty
    level = np.median(lvl_p)
    np.testing.assert_array_equal(lvl_p > level, lvl_j > level)
    assert pmesh.vertices.shape == jmesh.vertices.shape
    assert pmesh.faces.shape == jmesh.faces.shape
    # the welding of vertices (marching_tets) rounds them to a grid, so
    # rounding differences may number two vertices the other way round:
    # the faces are compared by their vertices' coordinates
    np.testing.assert_allclose(pmesh.vertices[pmesh.faces], jmesh.vertices[jmesh.faces],
                               atol=1e-4)


def test_per_frame_motion_matches_jax(exported):
    jmotion, pmotion = exported["jmotion"], exported["pmotion_j"]
    assert sorted(jmotion) == sorted(pmotion) == FRAMES
    skinned = exported["motion"] == "skel-quad"
    for fid in FRAMES:
        j, p = jmotion[fid], pmotion[fid]
        for a, b in zip(p.field2cam, j.field2cam):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
        assert (p.t_articulation is None) == (j.t_articulation is None) == (not skinned)
        assert (p.so3 is None) == (j.so3 is None)
        if skinned:
            for a, b in zip(p.t_articulation, j.t_articulation):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
            np.testing.assert_allclose(p.so3, np.asarray(j.so3), atol=1e-5)
            assert p.bone_t.vertices.shape == j.bone_t.vertices.shape
            np.testing.assert_allclose(p.bone_t.vertices, j.bone_t.vertices, atol=1e-4)
            np.testing.assert_allclose(p.bone_t.vertex_colors, j.bone_t.vertex_colors)
        else:
            assert p.bone_t is None and j.bone_t is None
        np.testing.assert_allclose(p.mesh_t.vertices, np.asarray(j.mesh_t.vertices), atol=1e-4)


def test_rest_mesh_matches_jax(exported):
    np.testing.assert_allclose(exported["prest_j"].vertices, np.asarray(exported["jrest"].vertices),
                               atol=1e-4)
    np.testing.assert_array_equal(exported["prest_j"].faces, exported["jrest"].faces)


def test_motion_json_and_files_match_jax(exported):
    cate, dirs = exported["cate"], exported["dirs"]
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    names = os.listdir(dirs["port"])
    assert f"{cate}.obj" in names and f"{cate}-motion.json" in names
    assert all(f"{cate}-{fid:05d}.obj" in names for fid in FRAMES)
    load = {k: json.load(open(os.path.join(d, f"{cate}-motion.json"))) for k, d in dirs.items()}
    assert sorted(load["port"]) == sorted(load["jax"]) == ["field2cam", "joint_so3",
                                                           "t_articulation"]
    for key in load["jax"]:
        a, b = np.asarray(load["port"][key]), np.asarray(load["jax"][key])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=key)
    assert len(load["port"]["field2cam"]) == len(FRAMES)
    assert len(load["port"]["joint_so3"]) == (len(FRAMES) if exported["motion"] == "skel-quad"
                                              else 0)


def test_reanimate_batch_follows_a_jax_json(exported, tmp_path):
    """A json written by the JAX exporter drives the port's render batch:
    its fg camera is the json's and, for the skeleton, the articulation of
    each frame is JAX's get_vals under the json's joint angles (the rigid
    model has none; a bg model takes no fg camera: its bg-motion.json is
    read as the file's format alone)."""
    from lab4d_tpu.utils.quat import se3_to_quaternion_translation
    from lab4d_tpu_torch.reanimate import construct_batch_from_opts_reanimate

    model, jmodel, params = exported["model"], exported["jmodel"], exported["params"]
    run = tmp_path / "logdir" / "s-r" / "export_0000"
    run.mkdir(parents=True)
    with open(exported["dirs"]["jax"] + f"/{exported['cate']}-motion.json") as f:
        (run / "fg-motion.json").write_text(f.read())
    opts = {"logroot": str(tmp_path / "logdir"), "seqname": "s", "logname": "r", "motion_id": 0,
            "inst_id": 0, "render_res": 4, "viewpoint": "ref", "freeze_id": 0, "num_frames": -1,
            "noskip": False}
    geo_state = {exported["cate"]: {
        "aabb": np.full((2, 3), 0.2) * [[-1], [1]],
        "corners": np.random.default_rng(0).standard_normal((8, 3)) * 0.1}}
    data_info = {"raw_size": [(64, 64)], "frame_info": model.frame_info}
    batch, _ = construct_batch_from_opts_reanimate(opts, model, geo_state, data_info, "cpu")
    motion = json.load(open(run / "fg-motion.json"))
    so3 = np.asarray(motion["joint_so3"], np.float32)
    assert batch["joint_so3"].shape == so3.shape and len(batch["frameid_sub"]) == len(FRAMES)
    assert len(so3) == (len(FRAMES) if exported["motion"] == "skel-quad" else 0)
    want_f2c = np.asarray(se3_to_quaternion_translation(
        jnp.asarray(np.asarray(motion["field2cam"], np.float32)), tuple_out=False))
    np.testing.assert_allclose(batch["field2cam"]["fg"].numpy(), want_f2c, atol=1e-6)
    if exported["cate"] == "bg":
        return

    for i in range(len(FRAMES)):
        sub = {k: ({k2: v2[i:i + 1] for k2, v2 in v.items()} if isinstance(v, dict) else v[i:i + 1])
               for k, v in batch.items()}
        sub["geo"] = {"fg": {"aabb": torch.tensor(geo_state["fg"]["aabb"], dtype=torch.float32),
                             "proxy_corners": torch.tensor(geo_state["fg"]["corners"],
                                                           dtype=torch.float32)}}
        with torch.no_grad():
            samples = model.prepare_eval_samples(sub)["fg"]
        scale = float(torch.exp(model.fields.field_params["fg"].logscale))
        np.testing.assert_allclose(samples["field2cam"][1].numpy(), want_f2c[i:i + 1, 4:] * scale,
                                   rtol=1e-6)
        if exported["motion"] != "skel-quad":
            assert "t_articulation" not in samples
            continue
        t_art = samples["t_articulation"]
        fid = int(sub["frameid_sub"][0]) + int(model.frame_info.frame_offset_raw[0])
        want = jmodel.apply(
            {"params": params}, jnp.asarray([fid]), jnp.asarray(so3[i:i + 1]),
            method=lambda m, f, s: m.fields.field_params["fg"].warp.articulation.get_vals(
                f, override_so3=s))
        for a, b in zip(t_art, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


OBJ_MESHES = {
    "plain": (np.random.default_rng(5).standard_normal((300, 3)),
              np.random.default_rng(6).integers(0, 300, (500, 3)), None),
    "colours-0-255": (np.random.default_rng(7).standard_normal((40, 3)),
                      np.random.default_rng(8).integers(0, 40, (60, 3)),
                      np.random.default_rng(9).random((40, 3)) * 255),
    "colours-0-1": (np.random.default_rng(10).standard_normal((40, 3)),
                    np.random.default_rng(11).integers(0, 40, (60, 3)),
                    np.random.default_rng(12).random((40, 3))),
    "empty": (None, None, None),
}


@pytest.mark.parametrize("name", sorted(OBJ_MESHES))
def test_obj_text_matches_jax(name, tmp_path):
    """The port's OBJ writer (one %-operation per block) writes the JAX
    writer's text byte for byte."""
    from lab4d_tpu.meshlib import Mesh as JaxMesh
    from lab4d_tpu.meshlib import save_obj as jax_save_obj
    from lab4d_tpu_torch.meshlib import save_obj

    verts, faces, colours = OBJ_MESHES[name]
    save_obj(pexport.Mesh(verts, faces, colours), str(tmp_path / "port.obj"))
    jax_save_obj(JaxMesh(verts, faces, colours), str(tmp_path / "jax.obj"))
    assert (tmp_path / "port.obj").read_text() == (tmp_path / "jax.obj").read_text()
