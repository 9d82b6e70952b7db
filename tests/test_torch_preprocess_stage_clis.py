"""The port's depth and segmentation stage CLIs
(`python -m lab4d_tpu_torch.preprocess.scripts.{depth,segmentation}`)
against the JAX package's functions behind preprocess/scripts/depth.py
and segmentation.py, on the CPU, on tests/test_torch_preprocess_pipeline.py's
raw scene (10 frames at 96^2, only the frames written) with the default
`auto` backends (the shipped depth and segmentation U-Nets). The written
Depth/ and Annotations/ arrays are held to that file's tolerances for
those stages. Without `--device cpu` the CLIs refuse to run on a host with
no card, before they write anything.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_preprocess_pipeline import F16_RTOL, N_FRAMES, SEQ, _scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("depth", "segmentation")


def _frames(processed, sub):
    return sorted(glob.glob(f"{processed}/{sub}/Full-Resolution/{SEQ}/0*.npy"))


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """The JAX package's stages on their own copy of the scene."""
    for var in ("LAB4D_SEG_BACKEND", "LAB4D_DEPTH_BACKEND", "LAB4D_WEIGHTS_DIR"):
        assert var not in os.environ, var
    from preprocess.backends.depth_backends import extract_depth
    from preprocess.backends.seg_backends import run_segmentation

    root = str(tmp_path_factory.mktemp("stages_jax"))
    _scene(root)
    assert run_segmentation(SEQ, f"{root}/processed") == "unet"
    assert extract_depth(SEQ, f"{root}/processed") == "unet"
    return f"{root}/processed"


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A directory holding database/processed with the scene's frames, the
    current directory of the CLI (its default outdir is relative)."""
    _scene(str(tmp_path / "database"))
    monkeypatch.chdir(tmp_path)
    return str(tmp_path / "database" / "processed")


def test_depth_cli_matches_jax(jax_out, workdir):
    from lab4d_tpu_torch.preprocess.scripts import depth

    assert depth.main([SEQ, "--device", "cpu"]) == "unet"
    want, got = _frames(jax_out, "Depth"), _frames(workdir, "Depth")
    assert len(want) == len(got) == N_FRAMES
    for a, b in zip(want, got):
        w, g = np.load(a), np.load(b)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float16
        # the pipeline test's depth tolerance: 2 half-precision ulps, 1e-3 abs
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=F16_RTOL,
                                   atol=1e-3, err_msg=b)


def test_segmentation_cli_matches_jax(jax_out, workdir):
    """Every frame's mask equal, apart from pixels where the port's
    probability lies within 1e-5 of the 0.5 cut: every differing pixel of a
    frame is checked, its probability taken at the mask's resolution as the
    stage resizes it (nearest)."""
    from lab4d_tpu_torch.preprocess.scripts import segmentation

    assert segmentation.main([SEQ, "--device", "cpu"]) == "unet"
    want, got = _frames(jax_out, "Annotations"), _frames(workdir, "Annotations")
    assert len(want) == len(got) == N_FRAMES
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if not np.array_equal(np.load(a), np.load(b))]
    if differ:
        import cv2

        from lab4d_tpu_torch.preprocess.backends.seg_unet import segment_probs

        frames = [cv2.imread(p)[..., ::-1] for p in sorted(glob.glob(
            f"{workdir}/JPEGImages/Full-Resolution/{SEQ}/*.jpg"))]
        probs = list(segment_probs(frames, device="cpu"))
        for i in differ:
            flip = np.load(want[i]) != np.load(got[i])
            h, w = flip.shape
            prob = cv2.resize(probs[i], (w, h), interpolation=cv2.INTER_NEAREST)
            assert np.abs(prob[flip] - 0.5).max() <= 1e-5, (i, int(flip.sum()))


@pytest.mark.parametrize("cli", CLIS)
def test_cli_needs_a_card_unless_asked(cli, workdir):
    """The default device is the card: with none visible the CLI raises
    before it writes anything (no fallback to the CPU)."""
    import importlib

    import torch

    assert not torch.cuda.is_available()
    mod = importlib.import_module(f"lab4d_tpu_torch.preprocess.scripts.{cli}")
    argv = [SEQ, "database/processed", ""] if cli == "segmentation" else [SEQ]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert not _frames(workdir, "Annotations") and not _frames(workdir, "Depth")


@pytest.mark.parametrize("cli", CLIS)
def test_cli_runs_as_a_module(cli):
    """`python -m` finds the CLI and its arguments are the JAX script's
    positionals plus --device."""
    proc = subprocess.run([sys.executable, "-m", f"lab4d_tpu_torch.preprocess.scripts.{cli}",
                           "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = "seqname [outdir] [prompt]" if cli == "segmentation" else "seqname"
    assert want in proc.stdout and "--device" in proc.stdout, proc.stdout
