"""scripts/validate_adversarial.py of the port on the CPU: `--cpu` at 8
frames of 32^2, one round, writes the adversarial scene, trains the
skel-quad model through the train CLI's main (the JAX script's `--cpu`
iteration counts) and prints the JAX script's JSON; the
train CLI's arguments are the JAX script's."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_argv_matches_jax_script():
    from lab4d_tpu_torch.scripts import validate_adversarial as tool

    args, extra = tool.parse_args(["--cpu", "--rounds", "2", "--res", "64", "--workdir", "w",
                                   "--geo_init_steps", "7"])
    assert extra == ["--geo_init_steps", "7"]
    argv = tool.train_argv(args, extra)
    want = ["--seqname", "adversarial", "--logname", "val-skel-quad", "--fg_motion", "skel-quad",
            "--train_res", "64", "--num_rounds", "2", "--database_root", "w/database",
            "--logroot", "w/logdir", "--use_cpu", "--iters_per_round", "20",
            "--imgs_per_gpu", "8", "--eval_res", "64", "--geo_init_steps", "7"]
    assert argv == want


def test_validate_adversarial_cpu(tmp_path):
    """The script as a user runs it, with the geometry init cut to 20 steps
    (a flag it hands to the train CLI) and one CPU thread, so that it
    keeps to ~1 min beside the other test workers."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "lab4d_tpu_torch.scripts.validate_adversarial", "--cpu",
         "--frames", "8", "--res", "32", "--rounds", "1", "--workdir", str(tmp_path),
         "--geo_init_steps", "20"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["fg_motion"] == "skel-quad" and out["rounds"] == 1 and out["res"] == 32
    assert np.isfinite(out["psnr_final"]) and 0 < out["ssim_final"] <= 1
    assert os.path.exists(tmp_path / "logdir/adversarial-val-skel-quad/ckpt_latest.flax")
