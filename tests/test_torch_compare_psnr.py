"""tools/compare_psnr.py, the port's side of
scripts/compare_reference_psnr.py: the protocol's helpers equal the JAX
side's (masked_psnr exactly, effective_iters on a grid of settings), the
recorded spread is read from psnr_compare.json unchanged, the parting
round is found where a trajectory stays below the band, and a tiny rigid
run on the CPU writes a complete, finite result file.
"""

import json
import os

import numpy as np
import pytest

from lab4d_tpu_torch.tools import compare_psnr as CP
from scripts import compare_reference_psnr as jax_side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_psnr_matches_the_jax_side(seed):
    rng = np.random.default_rng(seed)
    pred, ref = rng.random((3, 8, 8, 3)), rng.random((3, 8, 8, 3))
    mask = rng.random((3, 8, 8)) > 0.4
    assert CP.masked_psnr(pred, ref, mask) == jax_side.masked_psnr(pred, ref, mask)
    assert np.isnan(CP.masked_psnr(pred, ref, np.zeros_like(mask)))


def test_effective_iters_matches_the_jax_side():
    for iters in (1, 7, 20, 50):
        for frames in (2, 9, 32, 81, 200):
            assert CP.effective_iters(iters, frames) == jax_side.effective_iters(iters, frames)


def test_recorded_spread_is_psnr_compare_json():
    rec = CP.recorded_spread()
    with open(os.path.join(REPO, "psnr_compare.json")) as f:
        want = json.load(f)["full_budget_seed_spread"]
    assert rec["final_mean"] == want["ours_final_mean"] == 22.1792
    assert rec["final_std"] == want["ours_final_std"]
    assert rec["traj_by_seed"] == want["ours_traj_by_seed"]


def test_first_parting_round():
    ref = {"0": [10.0, 12.0, 14.0, 16.0], "1": [10.0, 12.0, 14.0, 16.0]}
    assert CP.first_parting_round({"0": [10.0, 12.0, 14.0, 16.0]}, ref, 0.4) is None
    assert CP.first_parting_round({"0": [10.0, 12.0, 12.0, 13.0]}, ref, 0.4) == 2
    # a dip that recovers is not a parting
    assert CP.first_parting_round({"0": [10.0, 9.0, 14.0, 16.0]}, ref, 0.4) is None


def test_a_tiny_rigid_run_on_the_cpu(tmp_path):
    out = tmp_path / "psnr.json"
    CP.main(["--device", "cpu", "--seeds", "0,1", "--rounds", "1", "--frames", "9", "--res", "16",
             "--out", str(out), "--workdir", str(tmp_path / "work")])
    got = json.loads(out.read_text())
    assert got["settings"]["iters_effective"] == 2 and got["settings"]["card"] == "cpu"
    assert set(got["torch_traj_by_seed"]) == {"0", "1"}
    assert all(np.isfinite(t).all() and len(t) == 1 for t in got["torch_traj_by_seed"].values())
    assert np.isclose(got["gap_final_mean"], got["torch_final_mean"] - 22.1792)
    assert "parting_round" not in got  # 1 round of 20: no round-by-round comparison
