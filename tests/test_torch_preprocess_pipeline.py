"""Both preprocessing pipelines on the same raw scene, on the CPU: the JAX
package's (preprocess/ + scripts/run_preprocess.py) and the port's
(lab4d_tpu_torch/preprocess/), at tests/test_preprocess_e2e.py's settings
(tests/synthetic_raw.py, 10 frames at 96^2, orbit span 0.12, only the
frames written; segmentation, the priors, the config, the features at
crop 64) with the default `auto` backends: every neural stage on its
shipped weights. Every artifact test_preprocess_e2e.py lists is compared,
each with its tolerance below; then the port's TrainBatchLoader yields a
batch from the port's output, and the entry point
(`python -m lab4d_tpu_torch.preprocess.run`) runs from a raw video on the
CPU when asked, and refuses to run without a card otherwise.
"""

import glob
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.synthetic_raw import make_raw_scene  # noqa: E402

SEQ = "e2esim-0000"
N_FRAMES = 10
# float16 artifacts: 2 half-precision ulps (relative) of the stored value
F16_RTOL = 2 * 2.0**-10
FLOW_ATOL = 0.1  # px in the 256^2 crop; RAFT's fp32 rounding through the crop's remap
UCT_FLIPS = 1e-3  # share of pixels whose cycle uncertainty crosses its 0.25 cut
CAM_TOL = 1e-4  # the Procrustes chain, float32
# the canonical fit's final loss (see _check_canonical): twice the spread
# of JAX's own (tests/test_torch_preprocess_classical.py FIT_LOSS_RTOL)
FIT_LOSS_RTOL = 0.10
FEAT_COS = 0.999  # per masked pixel, float16 features


def _artifacts(root):
    out = f"{root}/processed"
    return {
        "rgb": f"{out}/JPEGImages/Full-Resolution/{SEQ}/crop-256.npy",
        "mask": f"{out}/Annotations/Full-Resolution/{SEQ}/crop-256.npy",
        "crop2raw": f"{out}/Annotations/Full-Resolution/{SEQ}/crop-256-crop2raw.npy",
        "depth": f"{out}/Depth/Full-Resolution/{SEQ}/crop-256.npy",
        "flow_fw1": f"{out}/FlowFW_1/Full-Resolution/{SEQ}/crop-256.npy",
        "flow_bw8": f"{out}/FlowBW_8/Full-Resolution/{SEQ}/crop-256.npy",
        "cams00": f"{out}/Cameras/Full-Resolution/{SEQ}/00.npy",
        "canonical": f"{out}/Cameras/Full-Resolution/{SEQ}/01-canonical.npy",
        "mesh": f"{out}/Cameras/Full-Resolution/{SEQ}/mesh-00-centered.obj",
        "features": f"{out}/Features/Full-Resolution/{SEQ}/crop-64-dinov2-01.npy",
        "config": f"{root}/configs/e2esim.config",
    }


def _scene(root):
    make_raw_scene(root, seqname=SEQ, num_frames=N_FRAMES, res=96, orbit_span=0.12,
                   write_masks=False, write_depth=False, write_flow=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    for var in ("LAB4D_FLOW_BACKEND", "LAB4D_SEG_BACKEND", "LAB4D_DEPTH_BACKEND",
                "LAB4D_FEAT_BACKEND", "LAB4D_WEIGHTS_DIR"):
        assert var not in os.environ, var
    roots = {w: str(tmp_path_factory.mktemp(f"pre_{w}")) for w in ("jax", "port")}

    from preprocess.backends.seg_backends import run_segmentation as jax_seg
    from preprocess.scripts.extract_features import extract_features as jax_feat
    from preprocess.scripts.write_config import write_config as jax_config
    from scripts.run_preprocess import run_extract_priors as jax_priors

    root = roots["jax"]
    _scene(root)
    jax_seg(SEQ, f"{root}/processed")
    jax_priors(SEQ, f"{root}/processed", "quad")
    jax_config("e2esim", root)
    jax_feat("e2esim", 64, database_root=root)

    from lab4d_tpu_torch.preprocess import run
    from lab4d_tpu_torch.preprocess.scripts.extract_features import extract_features
    from lab4d_tpu_torch.preprocess.scripts.write_config import write_config

    root = roots["port"]
    _scene(root)
    seg = run.run_segmentation(SEQ, f"{root}/processed", device="cpu")
    priors = run.run_extract_priors(SEQ, f"{root}/processed", "quad", device="cpu")
    write_config("e2esim", root)
    feat = extract_features("e2esim", 64, database_root=root, device="cpu")
    backends = {**seg["backends"], **priors["backends"], "features": feat}
    return {"roots": roots, "backends": backends}


def test_port_runs_the_neural_backends(runs):
    assert runs["backends"] == {"segmentation": "unet", "flow": "raft", "depth": "unet",
                                "viewpoint": "net", "features": "net"}


def test_segmentation_masks(runs):
    """Every frame's mask equal; a pixel may differ only where the port's
    probability lies within rounding (1e-5) of the 0.5 cut."""
    masks = {w: sorted(glob.glob(f"{r}/processed/Annotations/Full-Resolution/{SEQ}/0*.npy"))
             for w, r in runs["roots"].items()}
    assert len(masks["jax"]) == len(masks["port"]) == N_FRAMES
    differ = [i for i, (a, b) in enumerate(zip(masks["jax"], masks["port"]))
              if not np.array_equal(np.load(a), np.load(b))]
    if differ:
        import cv2

        from lab4d_tpu_torch.preprocess.backends.seg_unet import segment_probs

        frames = [cv2.imread(p)[..., ::-1] for p in sorted(glob.glob(
            f"{runs['roots']['port']}/processed/JPEGImages/Full-Resolution/{SEQ}/*.jpg"))]
        probs = list(segment_probs(frames, device="cpu"))
        for i in differ:
            assert np.abs(probs[i] - 0.5).min() <= 1e-5, i


NAMES = list(_artifacts("r"))


@pytest.mark.parametrize("name", NAMES)
def test_artifact_matches_jax(runs, name):
    want_path = _artifacts(runs["roots"]["jax"])[name]
    got_path = _artifacts(runs["roots"]["port"])[name]
    assert os.path.exists(want_path) and os.path.exists(got_path), name
    if name == "config":
        text = [open(p).read().replace(r, "ROOT") for p, r in
                ((want_path, runs["roots"]["jax"]), (got_path, runs["roots"]["port"]))]
        assert text[0] == text[1]
        return
    if name == "mesh":
        return _check_mesh(want_path, got_path)
    want, got = np.load(want_path), np.load(got_path)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert np.isfinite(got.astype(np.float32)).all(), name
    want, got = want.astype(np.float64), got.astype(np.float64)
    if name in ("rgb", "mask", "crop2raw"):  # from the JPEGs and the masks alone
        np.testing.assert_array_equal(got, want)
    elif name == "depth":
        np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=1e-3)
    elif name.startswith("flow"):
        np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=F16_RTOL, atol=FLOW_ATOL)
        d = np.abs(got[..., 2] - want[..., 2])
        flips = d > 1e-2
        # exp(-25 err) is cut to 0 below 0.25: a flip sits at the cut
        assert flips.mean() <= UCT_FLIPS, flips.mean()
        assert np.all(np.maximum(got[..., 2], want[..., 2])[flips] <= 0.3)
        assert np.percentile(d, 99.9) <= 1e-2
    elif name == "cams00":
        assert np.abs(got - want).max() <= CAM_TOL
    elif name == "canonical":
        _check_canonical(runs, got, want)
    elif name == "features":
        nz_g, nz_w = np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0
        assert (nz_g == nz_w).all() and nz_w.mean() > 0.05
        cos = np.sum(got * want, -1)[nz_w] / (
            np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))[nz_w]
        assert cos.min() >= FEAT_COS, cos.min()


def _obj_vertices(path):
    with open(path) as f:
        return np.array([[float(x) for x in line.split()[1:4]] for line in f
                         if line.startswith("v ")])


def _check_mesh(want_path, got_path):
    """The TSDF mesh as a point set: the depths behind it are float16 and
    differ by an ulp at a few pixels, which moves a few vertices by a
    fraction of a voxel."""
    from scipy.spatial import cKDTree

    want, got = _obj_vertices(want_path), _obj_vertices(got_path)
    assert len(want) > 1000
    assert abs(len(got) - len(want)) <= 0.005 * len(want)
    voxel = (want.max(0) - want.min(0)).max() / 127
    d_gw = cKDTree(want).query(got)[0]
    d_wg = cKDTree(got).query(want)[0]
    assert max(d_gw.max(), d_wg.max()) <= 0.5 * voxel
    assert max(d_gw.mean(), d_wg.mean()) <= 1e-3 * voxel


def _check_canonical(runs, got, want):
    """The translations (from the mask boxes) equal. The rotations come
    from the two-phase fit, whose phase 2 here never gets below its
    tolerance and runs its 2000 iterations at the loss's floor, where the
    end point is chaotic (tests/test_torch_preprocess_classical.py
    test_rotation_fit_full_length): they are held to the loss they reach."""
    from lab4d_tpu_torch.preprocess.libs.registration import fit_loss, rotation_gap_deg

    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=1e-6, atol=1e-6)
    chain = np.load(f"{runs['roots']['jax']}/processed/Cameras/Full-Resolution/{SEQ}/01.npy")
    from lab4d_tpu_torch.preprocess.backends.viewpoint_net import predict_viewpoints
    from lab4d_tpu_torch.preprocess.libs.io import frame_list

    ann = predict_viewpoints(frame_list(f"{runs['roots']['port']}/processed", SEQ), "quad",
                             device="cpu")
    lj, lt = fit_loss(want[:, :3, :3], chain, ann), fit_loss(got[:, :3, :3], chain, ann)
    print(f"canonical: loss port {lt:.5f} JAX {lj:.5f}; rotations up to "
          f"{rotation_gap_deg(got[:, :3, :3], want[:, :3, :3]).max():.2f} deg apart")
    assert abs(lt - lj) <= FIT_LOSS_RTOL * lj


def test_port_output_loads_in_the_port_loader(runs):
    from lab4d_tpu_torch.dataloader.data_utils import TrainBatchLoader, config_to_datasets

    opts = {"seqname": "e2esim", "database_root": runs["roots"]["port"], "data_prefix": "crop",
            "train_res": 256, "feature_type": "dinov2", "pixels_per_image": 8}
    datasets = config_to_datasets(opts)
    assert len(datasets) == 1 and len(datasets[0]) == N_FRAMES - 1
    loader = TrainBatchLoader(datasets, imgs_per_batch=2, num_workers=1)
    try:
        batch = loader.next_batch()
    finally:
        loader.stop()
    for key in ("rgb", "mask", "depth", "flow", "feature"):
        assert key in batch, key
        assert batch[key].shape[:3] == (2, 2, 8), (key, batch[key].shape)
        assert np.isfinite(np.asarray(batch[key], np.float32)).all(), key


def test_entry_point_needs_a_card_unless_asked(tmp_path):
    import torch

    from lab4d_tpu_torch.preprocess import run

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["vid", "", "quad", "0", "--database_root", str(tmp_path)])
    assert not (tmp_path / "processed").exists()


def test_entry_point_on_the_cpu(tmp_path):
    """The whole pipeline from a raw video through the CLI's main on the
    CPU: frame extraction (a leading black frame skipped), the motion
    filter, the per-video stages in device_map's worker processes, the
    features; the records it returns name each stage's backend."""
    from lab4d_tpu_torch.preprocess import run
    from lab4d_tpu_torch.tools.synthetic_scene import write_raw_video

    db = str(tmp_path / "database")
    write_raw_video(db, "cli", num_frames=9, res=64, orbit_span=0.5, lead_black=1)
    out = run.main(["cli", "", "quad", "0", "--device", "cpu", "--database_root", db])
    assert out["seqnames"] == ["cli-0000"]
    rec = out["workers"]["cli-0000"]
    assert rec["segmentation"]["backends"] == {"segmentation": "unet"}
    assert rec["priors"]["backends"] == {"flow": "raft", "depth": "unet", "viewpoint": "net"}
    assert out["features"]["backends"] == {"features": "net"}
    assert set(rec["priors"]["seconds"]) == {"flow", "depth", "crop", "camera_registration",
                                             "tsdf_fusion", "canonical_registration"}
    proc = f"{db}/processed"
    assert len(glob.glob(f"{proc}/JPEGImagesRaw/Full-Resolution/cli-0000/*.jpg")) == 9
    n = len(glob.glob(f"{proc}/JPEGImages/Full-Resolution/cli-0000/*.jpg"))
    assert n >= 8
    for path in _artifacts(db).values():
        path = path.replace(SEQ, "cli-0000").replace("crop-64-", "crop-256-").replace(
            "e2esim", "cli")
        assert os.path.exists(path), path
    assert np.load(f"{proc}/Cameras/Full-Resolution/cli-0000/00.npy").shape == (n, 4, 4)
