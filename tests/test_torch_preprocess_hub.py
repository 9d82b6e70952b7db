"""The gated hub / plugin preprocessing backends of both packages, with
stand-ins injected into both: ZoeDepth and DINOv2 through torch.hub (the
hub cache holds the repo's directory, torch.hub.load returns a small
deterministic model), the Track-Anything CLI and the CSE viewpoint head as
plugin modules on sys.path. Each package chooses the same backend under
the same environment (and under the LAB4D_*_BACKEND overrides), and
writes the same artifacts. No weights are fetched."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tests.synthetic_raw import make_raw_scene

torch.set_num_threads(1)

SEQ = "hubsim-0000"
ENV = ("LAB4D_DEPTH_BACKEND", "LAB4D_SEG_BACKEND", "LAB4D_FEAT_BACKEND", "LAB4D_FLOW_BACKEND")


class StandInZoe(torch.nn.Module):
    """ZoeD_NK's interface: infer_pil(PIL image) -> (H, W) depth."""

    def infer_pil(self, img):
        rgb = np.asarray(img, np.float32) / 255.0
        return 0.5 + 4.0 * rgb.mean(-1) + rgb[..., 0] * rgb[..., 2]


class StandInDino(torch.nn.Module):
    """dinov2_vits14's interface: forward_features(x (B, 3, 224, 224)) ->
    {"x_norm_patchtokens": (B, 256, C)}, here 14x14 patch means lifted to
    8 channels by fixed functions."""

    def forward_features(self, x):
        p = torch.nn.functional.avg_pool2d(x, 14)  # (B, 3, 16, 16)
        t = p.flatten(2).transpose(1, 2)  # (B, 256, 3)
        tok = torch.cat([t, t * t, torch.sin(3 * t[..., :1]), t[..., 1:2] * t[..., 2:]], -1)
        return {"x_norm_patchtokens": tok}


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """An empty torch.hub cache and a torch.hub.load of stand-ins; the
    LAB4D_*_BACKEND overrides unset."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    hub_dir = tmp_path / "hub"
    hub_dir.mkdir()
    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(hub_dir))
    loads = []

    def load(repo, name, *args, **kwargs):
        loads.append((repo, name))
        return {"isl-org/ZoeDepth": StandInZoe, "facebookresearch/dinov2": StandInDino}[repo]()

    monkeypatch.setattr(torch.hub, "load", load)
    from lab4d_tpu_torch.preprocess.backends import feat_backends

    feat_backends._dinov2.cache_clear()
    yield hub_dir, loads
    feat_backends._dinov2.cache_clear()


@pytest.fixture
def plugins(tmp_path, monkeypatch):
    """A directory on sys.path for plugin modules; they leave sys.modules
    afterwards."""
    path = tmp_path / "plugins"
    path.mkdir()
    monkeypatch.syspath_prepend(str(path))
    yield path
    for name in ("track_anything_cli", "cse_viewpoint"):
        sys.modules.pop(name, None)


def _scenes(tmp_path, num_frames=4):
    """The same raw scene (frames, masks, depth) under tmp/jax and tmp/port."""
    make_raw_scene(str(tmp_path / "jax"), seqname=SEQ, num_frames=num_frames, res=64,
                   write_flow=False)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return str(tmp_path / "jax"), str(tmp_path / "port")


def _npys(root, sub):
    d = f"{root}/processed/{sub}/Full-Resolution/{SEQ}"
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".npy")}


def test_zoe_depth_from_the_hub_cache(tmp_path, hub):
    from preprocess.backends import depth_backends as jax_depth

    from lab4d_tpu_torch.preprocess.backends import depth_backends

    hub_dir, loads = hub
    assert jax_depth.pick_depth_backend() == depth_backends.pick_depth_backend() != "zoe"
    (hub_dir / "isl-org_ZoeDepth_main").mkdir()
    assert jax_depth.pick_depth_backend() == depth_backends.pick_depth_backend() == "zoe"
    jroot, proot = _scenes(tmp_path)
    assert jax_depth.extract_depth(SEQ, f"{jroot}/processed") == "zoe"
    assert depth_backends.extract_depth(SEQ, f"{proot}/processed", device="cpu") == "zoe"
    assert loads == [("isl-org/ZoeDepth", "ZoeD_NK")] * 2
    want, got = _npys(jroot, "Depth"), _npys(proot, "Depth")
    assert list(got) == list(want) and len(want) == 4
    for f in want:
        assert got[f].dtype == want[f].dtype == np.float16
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_midas_cache_also_selects_zoe(hub, monkeypatch):
    from preprocess.backends import depth_backends as jax_depth

    from lab4d_tpu_torch.preprocess.backends import depth_backends

    (hub[0] / "intel-isl_MiDaS_master").mkdir()
    assert jax_depth.pick_depth_backend() == depth_backends.pick_depth_backend() == "zoe"
    monkeypatch.setenv("LAB4D_DEPTH_BACKEND", "flowdisp")
    assert jax_depth.pick_depth_backend() == depth_backends.pick_depth_backend() == "flowdisp"


def test_dinov2_features_from_the_hub_cache(tmp_path, hub, monkeypatch):
    from preprocess.scripts.extract_features import extract_features as jax_features
    from preprocess.scripts.write_config import write_config as jax_config

    from lab4d_tpu_torch.preprocess.backends.feat_backends import probe_dinov2
    from lab4d_tpu_torch.preprocess.scripts.extract_features import extract_features
    from lab4d_tpu_torch.preprocess.scripts.write_config import write_config

    hub_dir, loads = hub
    assert not probe_dinov2()
    (hub_dir / "facebookresearch_dinov2_main").mkdir()
    assert probe_dinov2()
    jroot, proot = _scenes(tmp_path, num_frames=8)  # write_config takes videos of >= 8
    jax_config("hubsim", jroot)
    write_config("hubsim", proot)
    assert jax_features("hubsim", 64, database_root=jroot) == "dinov2"
    assert extract_features("hubsim", 64, database_root=proot, device="cpu") == "dinov2"
    assert {r for r, _ in loads} == {"facebookresearch/dinov2"}
    for prefix in ("crop", "full"):
        name = f"Features/Full-Resolution/{SEQ}/{prefix}-64-dinov2-01.npy"
        want = np.load(f"{jroot}/processed/{name}").astype(np.float32)
        got = np.load(f"{proot}/processed/{name}").astype(np.float32)
        assert got.shape == want.shape == (8, 112, 112, 16)
        on = np.linalg.norm(want, axis=-1) > 0.5  # the masked pixels
        np.testing.assert_array_equal(np.linalg.norm(got, axis=-1) > 0.5, on)
        assert on.sum() > 100
        # the pipeline test's bound on float16 features (test_torch_preprocess_pipeline)
        cos = np.sum(want[on] * got[on], -1) / (
            np.linalg.norm(want[on], axis=-1) * np.linalg.norm(got[on], axis=-1))
        assert cos.min() >= 0.999, cos.min()
    # the override keeps its word in both
    monkeypatch.setenv("LAB4D_FEAT_BACKEND", "filterbank")
    assert extract_features("hubsim", 64, database_root=proot, device="cpu") == "filterbank"


def test_track_anything_cli_plugin(tmp_path, plugins, monkeypatch):
    from preprocess.backends import seg_backends as jax_seg

    from lab4d_tpu_torch.preprocess.backends import seg_backends

    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert jax_seg.pick_seg_backend() == seg_backends.pick_seg_backend() != "external"
    (plugins / "track_anything_cli.py").write_text(
        "import glob, os\n"
        "import cv2\n"
        "import numpy as np\n"
        "CALLS = []\n"
        "def track_anything_cli(img_dir, prompt, out_dir):\n"
        "    CALLS.append((img_dir, prompt, out_dir))\n"
        "    for p in sorted(glob.glob(os.path.join(img_dir, '*.jpg'))):\n"
        "        gray = cv2.imread(p).mean(-1)\n"
        "        m = (gray > gray.mean()).astype(np.int8) * (1 + len(prompt) % 2)\n"
        "        np.save(os.path.join(out_dir, os.path.basename(p)[:-4] + '.npy'), m)\n")
    assert jax_seg.pick_seg_backend() == seg_backends.pick_seg_backend() == "external"
    jroot, proot = _scenes(tmp_path)
    for root in (jroot, proot):
        shutil.rmtree(f"{root}/processed/Annotations/Full-Resolution/{SEQ}")
    assert jax_seg.run_segmentation(SEQ, f"{jroot}/processed", "cat") == "external"
    assert seg_backends.run_segmentation(SEQ, f"{proot}/processed", "cat",
                                         device="cpu") == "external"
    import track_anything_cli

    assert [c[1] for c in track_anything_cli.CALLS] == ["cat", "cat"]
    want, got = _npys(jroot, "Annotations"), _npys(proot, "Annotations")
    assert list(got) == list(want) and len(want) == 4
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    monkeypatch.setenv("LAB4D_SEG_BACKEND", "grabcut")
    assert jax_seg.pick_seg_backend() == seg_backends.pick_seg_backend() == "grabcut"


def test_cse_viewpoint_plugin(tmp_path, plugins):
    from preprocess.libs.io import frame_list as jax_frames
    from preprocess.scripts.canonical_registration import _load_rotation_priors

    from lab4d_tpu_torch.preprocess.scripts.canonical_registration import load_rotation_priors

    jroot, _ = _scenes(tmp_path, num_frames=3)
    out = f"{jroot}/processed"
    imgs = jax_frames(out, SEQ)
    (plugins / "cse_viewpoint.py").write_text(
        "import numpy as np\n"
        "def predict_viewpoints(img_paths, obj_class):\n"
        "    out = []\n"
        "    for i, _ in enumerate(img_paths):\n"
        "        a = 0.3 * i + (0.1 if obj_class == 'quad' else 0.0)\n"
        "        c, s = np.cos(a), np.sin(a)\n"
        "        out.append([[c, 0, s], [0, 1, 0], [-s, 0, c]])\n"
        "    return out\n")
    want = _load_rotation_priors(SEQ, out, "quad", imgs)
    got, source = load_rotation_priors(SEQ, out, "quad", imgs, device="cpu")
    assert source == "cse" and sorted(got) == sorted(want) == [0, 1, 2]
    for i in want:
        assert got[i].dtype == want[i].dtype == np.float32
        np.testing.assert_array_equal(got[i], want[i])
