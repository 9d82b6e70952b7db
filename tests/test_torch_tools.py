"""The port's tools outside the entry points against the JAX package's, on
the CPU:

- lab4d_tpu_torch/browser/app.py: build_index's page and render_mesh_png's
  png against browser/app.py's, byte for byte;
- scripts/render_intermediate.py on proxy meshes (with camera meshes):
  the frames against scripts/render_intermediate.py's, bit for bit, and
  absl's boolean forms of --show_cams;
- scripts/create_collage.py: the grid frames against
  scripts/create_collage.py's, and the video written;
- scripts/run_crop_all.py on a tiny processed scene (through the worker
  processes of utils/device_map.py) against preprocess/scripts/crop.py's
  extract_crop, artifact by artifact;
- scripts/run_rendering_parallel.py: its render commands against the JAX
  script's, and a run on a tiny bg checkpoint on the CPU.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lab4d_tpu_torch.meshlib import uv_sphere

# one torch thread per test worker (as in test_torch_train_optim.py)
torch.set_num_threads(1)


def _capture_video(monkeypatch, module):
    """Replace module.save_video by a recorder; returns the records."""
    calls = []
    monkeypatch.setattr(module, "save_video", lambda frames, path, fps=10: calls.append(
        (np.asarray(frames), path)))
    return calls


# ------------------------------------------------------------------ browser


def _results_root(root):
    for rel in ("logdir/a-b/rgb.mp4", "logdir/a-b/renderings_0000/ref/mask-00000.png",
                "logdir/a-b/t.gif", "database/processed/JPEGImages/Full-Resolution/v-0000/00000.jpg"):
        os.makedirs(os.path.dirname(root / rel), exist_ok=True)
        (root / rel).write_bytes(b"x")
    os.makedirs(root / "logdir/a-b/export_0000", exist_ok=True)
    return root


def test_build_index_matches_jax(tmp_path):
    import browser.app as jax_app

    from lab4d_tpu_torch.browser import app

    root = _results_root(tmp_path)
    page = app.build_index(str(root))
    assert page == jax_app.build_index(str(root))
    assert "export_0000" in page and "mask-00000.png" in page
    assert app.build_index(str(tmp_path / "empty")) == jax_app.build_index(str(tmp_path / "empty"))


@pytest.mark.parametrize("az", [0.0, 30.0, 215.0])
def test_render_mesh_png_matches_jax(tmp_path, az):
    import browser.app as jax_app

    from lab4d_tpu_torch.browser import app

    path = str(tmp_path / "m-00000.obj")
    uv_sphere(radius=0.7, count=[10, 12]).export(path)
    png = app.render_mesh_png(path, az, res=96)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert png == jax_app.render_mesh_png(path, az, res=96)


# ------------------------------------------------------------------ render_intermediate


def _proxy_run(root, rounds=3):
    for r in range(rounds):
        uv_sphere(radius=0.5 + 0.1 * r, count=[8, 10]).export(f"{root}/{r:04d}-fg-proxy.obj")
        cams = uv_sphere(radius=0.1, count=[4, 4])
        cams.vertices = cams.vertices + np.array([1.2, 0.0, 0.0])
        cams.export(f"{root}/{r:04d}-fg-cams.obj")
    return str(root)


@pytest.mark.parametrize("show_cams", [False, True])
def test_render_intermediate_matches_jax(tmp_path, monkeypatch, show_cams):
    import lab4d_tpu.utils.io as jax_io
    import scripts.render_intermediate as jax_tool

    from lab4d_tpu_torch.scripts import render_intermediate

    testdir = _proxy_run(tmp_path)
    calls = _capture_video(monkeypatch, jax_io)
    want = jax_tool.render_intermediate(testdir, "fg", 48, 12, show_cams)
    got = render_intermediate.main(["--testdir", testdir, "--res", "48"]
                                   + (["--show_cams"] if show_cams else ["--noshow_cams"]))
    assert len(got) == len(want) == 3
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    np.testing.assert_array_equal(calls[0][0], np.stack(want))
    out = glob.glob(f"{testdir}/intermediate-fg*")
    assert out, os.listdir(testdir)


def test_render_intermediate_absl_booleans(tmp_path):
    from lab4d_tpu_torch.scripts import render_intermediate

    testdir = _proxy_run(tmp_path, rounds=1)
    with_cams = render_intermediate.main(["--testdir", testdir, "--res", "32", "--show_cams=true"])
    without = render_intermediate.main(["--testdir", testdir, "--res", "32", "--show_cams=false"])
    assert (with_cams[0] != without[0]).any()
    assert render_intermediate.main(["--testdir", testdir, "--data_class", "bg"]) == []


# ------------------------------------------------------------------ create_collage


def _clip_dirs(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name, n, hw in (("a", 3, (40, 40)), ("b", 5, (24, 36)), ("c", 2, (30, 30))):
        os.makedirs(root / name)
        for i in range(n):
            img = (rng.random(hw + ((3,) if name != "c" else ())) * 255).astype(np.uint8)
            Image.fromarray(img).save(root / name / f"{i:05d}.png")
    return str(root / "*")


@pytest.mark.parametrize("cols", [0, 3])
def test_create_collage_matches_jax(tmp_path, monkeypatch, cols):
    import lab4d_tpu.utils.io as jax_io
    import scripts.create_collage as jax_tool

    from lab4d_tpu_torch.scripts import create_collage

    pattern = _clip_dirs(tmp_path / "clips")
    calls = _capture_video(monkeypatch, jax_io)
    jax_tool.create_collage(pattern, str(tmp_path / "jax.mp4"), cols, res=32)
    want = calls[0][0]
    clips = [create_collage._load_clip(p) for p in sorted(glob.glob(pattern))]
    got = create_collage.collage_frames(clips, cols, res=32)
    np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "port.mp4")
    assert create_collage.create_collage(pattern, out, cols, res=32) == out
    back = create_collage._load_clip(out)
    if back is None:  # no video backend: one png per frame
        assert len(glob.glob(str(tmp_path / "port-*.png"))) == len(want)
    else:
        assert back.shape == want.shape
    assert create_collage.create_collage(str(tmp_path / "none*"), out) is None


# ------------------------------------------------------------------ run_crop_all


def test_run_crop_all_matches_extract_crop(tmp_path):
    import shutil

    from preprocess.scripts.crop import extract_crop

    from lab4d_tpu_torch.scripts import run_crop_all
    from lab4d_tpu_torch.tools.synthetic_scene import make_raw_scene

    for seq in ("sim-0000", "sim-0001"):
        make_raw_scene(str(tmp_path / "port"), seqname=seq, num_frames=9, res=32)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jax_out, port_out = str(tmp_path / "jax/processed"), str(tmp_path / "port/processed")
    for seq in ("sim-0000", "sim-0001"):
        for use_full in (0, 1):
            extract_crop(seq, 32, use_full, outdir=jax_out)
    assert run_crop_all.main(["sim", "32", port_out]) == ["sim-0000", "sim-0001"]
    want = sorted(os.path.relpath(p, jax_out)
                  for p in glob.glob(f"{jax_out}/**/*-32*.npy", recursive=True))
    got = sorted(os.path.relpath(p, port_out)
                 for p in glob.glob(f"{port_out}/**/*-32*.npy", recursive=True))
    assert got == want and any("full-32" in p for p in got) and any("crop-32" in p for p in got)
    for rel in want:
        a, b = np.load(f"{jax_out}/{rel}"), np.load(f"{port_out}/{rel}")
        assert a.dtype == b.dtype and a.shape == b.shape, rel
        np.testing.assert_array_equal(b, a, err_msg=rel)


# ------------------------------------------------------------------ run_rendering_parallel


def test_render_commands_match_jax(monkeypatch):
    import scripts.run_rendering_parallel as jax_tool

    from lab4d_tpu_torch.scripts import run_rendering_parallel as tool

    cmds = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: cmds.append(cmd))
    extra = ("--render_res", "64", "--viewpoint", "bev-30")
    assert jax_tool._render_one("cat", "run", 3, extra) == 3
    assert tool._render_one("cat", "run", 3, extra) == 3
    jax_cmd, port_cmd = cmds
    assert jax_cmd[1].endswith(os.path.join("lab4d_tpu", "render.py"))
    assert port_cmd[:3] == [sys.executable, "-m", "lab4d_tpu_torch.render"]
    assert port_cmd[3:] == jax_cmd[2:]
    assert tool._database_root(["--database_root", "db"]) == "db"
    assert tool._database_root(["--database_root=x/db"]) == "x/db"
    assert tool._database_root([]) == "database"


def test_run_rendering_parallel_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the worker and its render process
    from lab4d_tpu_torch import train
    from lab4d_tpu_torch.scripts.run_rendering_parallel import run_rendering_parallel
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    db, logroot = str(tmp_path / "database"), str(tmp_path / "logdir")
    make_synthetic_dataset(db, seqname="rp", num_vids=2, num_frames=4, res=16)
    common = ["--seqname", "rp", "--logname", "t", "--train_res", "16", "--field_type", "bg",
              "--device", "cpu", "--database_root", db, "--logroot", logroot]
    train.main(common + ["--num_rounds", "1", "--iters_per_round", "1", "--imgs_per_gpu", "4",
                         "--pixels_per_image", "4", "--geo_init_steps", "1", "--save_freq", "1",
                         "--eval_res", "4"])
    extra = common[4:] + ["--render_res", "8", "--num_frames", "1"]
    assert run_rendering_parallel("rp", "t", [0], extra) == [0, 1]
    for inst in (0, 1):
        assert glob.glob(f"{logroot}/rp-t/renderings_{inst:04d}/*/*"), inst
