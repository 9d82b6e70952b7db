"""The train CLI over ranks: `python -m lab4d_tpu_torch.train --ngpu 2
--use_cpu` on a tiny synthetic scene (fg / skel-quad, 2 rounds x 3 steps)
starts two gloo workers; rank 0 alone writes opts.log, metrics.jsonl and
the checkpoints, which the render CLI loads; both ranks run every round
(their params and generators checked equal at each round's end by the
trainer). --ngpu above the visible cards is refused with both numbers.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, **kw)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("cli")
    db, logroot = str(root / "database"), str(root / "logdir")
    make_synthetic_dataset(db, seqname="s", num_frames=8, res=16)
    common = ["--seqname", "s", "--logname", "t", "--train_res", "16", "--field_type", "fg",
              "--fg_motion", "skel-quad", "--use_cpu", "--database_root", db,
              "--logroot", logroot]
    res = _cli(["lab4d_tpu_torch.train", *common, "--ngpu", "2", "--num_rounds", "2",
                "--iters_per_round", "3", "--imgs_per_gpu", "2", "--pixels_per_image", "4",
                "--geo_init_steps", "5", "--save_freq", "1", "--eval_res", "4",
                "--num_workers", "1"], timeout=600)
    return res, common, os.path.join(logroot, "s-t")


def test_train_cli_over_two_gloo_workers(cli_run):
    res, _, run = cli_run
    assert res.returncode == 0, res.stderr[-3000:]
    files = sorted(os.listdir(run))
    assert "opts.log" in files and "metrics.jsonl" in files
    assert {"ckpt_0000.flax", "ckpt_0001.flax", "ckpt_0002.flax", "ckpt_latest.flax"} <= set(files)
    with open(os.path.join(run, "opts.log")) as f:
        assert "--ngpu=2\n" in f.readlines()
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [line for line in f if '"grad_norm"' in line]
    assert len(steps) == 1  # step 0, from rank 0 alone
    assert res.stdout.count("Round 001") == 2  # both ranks ran both rounds


def test_render_loads_the_sharded_run(cli_run):
    _, common, run = cli_run
    res = _cli(["lab4d_tpu_torch.render", *common, "--load_suffix", "latest",
                "--render_res", "4", "--freeze_id", "0", "--num_frames", "1"], timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_ngpu_above_the_visible_cards_fails():
    res = _cli(["lab4d_tpu_torch.train", "--ngpu", "2"], timeout=120)
    assert res.returncode != 0
    assert f"--ngpu 2 needs 2 cards on this host; {torch.cuda.device_count()} visible" \
        in res.stderr, res.stderr[-2000:]


def test_the_environment_describes_the_group(monkeypatch):
    from lab4d_tpu_torch.parallel import dist

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LAB4D_MULTIHOST", "LAB4D_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    assert dist.env_world() is None
    monkeypatch.setenv("LAB4D_MULTIHOST", "1")
    monkeypatch.setenv("LAB4D_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("LAB4D_NUM_PROCESSES", "4")
    monkeypatch.setenv("LAB4D_PROCESS_ID", "3")
    got = dist.env_world()
    assert (got["init_method"], got["world_size"], got["rank"]) == ("tcp://localhost:1234", 4, 3)
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's takes precedence
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert dist.env_world() == {"init_method": "env://", "world_size": 2, "rank": 1,
                                "local_rank": 1}


def test_torchrun_world_must_equal_ngpu(monkeypatch):
    from lab4d_tpu_torch import train

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    opts = train.parse_opts(train.get_parser(), ["--ngpu", "4", "--use_cpu"])
    with pytest.raises(SystemExit, match="--ngpu 4 but the process group has 2 ranks"):
        train.launch(opts)
