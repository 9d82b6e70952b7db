"""Training the rigid fg model (`--fg_motion rigid`, the CLIs' default): the
port's identity warp against the JAX package's, from the same numbers.

- step parity on make_model_and_batch("fg", "rigid", M=2, N=4), as
  tests/test_torch_train_fg.py holds the skel-quad step: every loss term
  (rtol 1e-4), the grad norm, every gradient (1e-5 + 1e-3 max|g_jax| per
  leaf) and one AdamW update (JAX's optimizer on the port's gradients).
  A rigid field has no skinning: no gauss-skin
  draw, zero skeleton, soft-deformation, gauss-skin, delta-skin and
  skin-entropy terms, and no gauss_mask;
- the CLI: `python -m lab4d_tpu_torch.train --field_type fg` (rigid by
  default) on the CPU on a tiny synthetic scene, whose geometry init
  distills a sphere of radius 0.1 as the JAX trainer's; the checkpoint then
  renders (the render CLI's default top-k eval) and exports.
"""

import json
import os

import numpy as np
import pytest
import torch

from lab4d_tpu.engine.schedules import compute_sched as jax_compute_sched
from tests.test_model import init_params_with_intrinsics_prior, make_model_and_batch
from lab4d_tpu_torch import bridge
from tests.test_torch_train_fg import (
    LR,
    M,
    N,
    STEP,
    TERMS,
    _draws,
    _flax_leaves,
    check_every_gradient,
    run_step,
)

ZERO_TERMS = ("reg_delta_skin", "reg_skin_entropy", "reg_soft_deform", "reg_gauss_skin",
              "reg_skel_prior")
RIGID_TERMS = tuple(t for t in TERMS if t != "reg_gauss_mask")


@pytest.fixture(scope="module")
def rigid_step():
    jmodel, batch = make_model_and_batch("fg", "rigid", M=M, N=N)
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]
    draws = {k: v for k, v in _draws().items() if k != "gauss_u"}
    return run_step(jmodel, batch, params, draws, "rigid",
                    {"choice": 1, "uniform": 1, "randint": 2})


def test_rigid_step_runs_its_terms(rigid_step):
    want, got = rigid_step["jax_loss"], rigid_step["port_loss"]
    assert sorted(k for k in got if k != "total") == sorted(want) == sorted(RIGID_TERMS)
    for k in RIGID_TERMS:
        if k in ZERO_TERMS:
            assert want[k] == 0.0 and got[k] == 0.0, k
        elif k != "reg_deform_cyc":  # |xyz - xyz_t| of the identity warp: the norm's epsilon
            assert want[k] > 0, k
    assert rigid_step["jax_gnorm"] < 5.0


@pytest.mark.parametrize("term", RIGID_TERMS + ("total",))
def test_rigid_loss_term_matches_jax(rigid_step, term):
    want = rigid_step["jax_total"] if term == "total" else rigid_step["jax_loss"][term]
    np.testing.assert_allclose(rigid_step["port_loss"][term], want, rtol=1e-4, atol=1e-12)


def test_rigid_grad_norm_matches_jax(rigid_step):
    np.testing.assert_allclose(rigid_step["port_gnorm"], rigid_step["jax_gnorm"], rtol=1e-4)


def test_rigid_every_gradient_matches_jax(rigid_step):
    check_every_gradient(rigid_step, ("basefield", "colorfield", "vis_mlp", "feature_field",
                                      "rgb_head", "sdf_head", "camera_mlp", "logsigma",
                                      "appr_embedding"))
    assert not any("warp" in k for k in rigid_step["port_grads"])


def test_rigid_params_after_one_adamw_step(rigid_step):
    """The port's AdamW update against JAX's optimizer (optax, the JAX
    trainer's groups and schedule) applied to the port's own gradients:
    every element within 1e-6, scaled by the group's learning rate. (The
    gradients themselves are test_rigid_every_gradient_matches_jax's: the
    two packages' updates from their own gradients can differ by more at
    gradients near Adam's epsilon of 1e-8, where a camera-head element of
    1.1e-7, 3% apart in fp32, moves its update by 2.3e-3 of the step.)"""
    got, old, lrs = rigid_step["port_new"], rigid_step["port_old"], rigid_step["port_lrs"]
    leaves = _flax_leaves(rigid_step["jax_new_from_port_grads"])
    assert len(leaves) == len(got)
    for path, new in leaves.items():
        key, transpose = bridge.flax_to_torch_key(path)
        want = (new.T if transpose else new) - old[key].numpy()
        have = got[key].numpy() - old[key].numpy()
        np.testing.assert_allclose(have, want, atol=1e-6 * lrs[key] / LR, rtol=0, err_msg=key)
    assert any(float((got[k] - old[k]).abs().max()) > 0 for k in got)


@pytest.fixture(scope="module")
def rigid_cli_run(tmp_path_factory):
    """`python -m lab4d_tpu_torch.train --field_type fg` (rigid) on the CPU:
    a tiny synthetic scene, 1 round of 2 steps."""
    from lab4d_tpu_torch import train as train_cli
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("train_rigid_cli")
    make_synthetic_dataset(str(root / "database"), seqname="srg", num_frames=8, res=16)
    common = ["--seqname", "srg", "--logname", "t", "--train_res", "16", "--device", "cpu",
              "--database_root", str(root / "database"), "--logroot", str(root / "logdir")]
    trainer = train_cli.main(common + [
        "--field_type", "fg", "--num_rounds", "1", "--iters_per_round", "2",
        "--imgs_per_gpu", "4", "--pixels_per_image", "4", "--geo_init_steps", "3",
        "--save_freq", "1", "--eval_res", "8"])
    return trainer, root, common + ["--load_suffix", "latest"]


def test_rigid_cli_trains(rigid_cli_run):
    trainer, root, _ = rigid_cli_run
    assert trainer.opts["fg_motion"] == "rigid" and trainer.current_steps == 2
    assert all(np.isfinite(ld["total"]) for ld in trainer.losses)
    assert sorted(k for k in trainer.losses[0] if k != "total") == sorted(RIGID_TERMS)
    assert os.path.exists(root / "logdir" / "srg-t" / "ckpt_latest.flax")
    pools = trainer._build_geometry_pools(num_steps=2, nsample=8)["fg"]
    want = torch.linalg.norm(pools["pts"], dim=-1, keepdim=True) - 0.1
    torch.testing.assert_close(pools["sdf_gt"], want)


def test_rigid_checkpoint_renders_and_exports(rigid_cli_run):
    from lab4d_tpu_torch import export as export_cli
    from lab4d_tpu_torch import render as render_cli

    _, root, common = rigid_cli_run
    rendered = render_cli.main(common + ["--render_res", "8", "--freeze_id", "0",
                                         "--num_frames", "1"])
    assert {"rgb", "mask", "depth", "normal"} <= set(rendered)
    assert "gauss_mask" not in rendered
    assert all(np.isfinite(v).all() for v in rendered.values())
    out = export_cli.main(common + ["--grid_size", "16"])
    motion = json.load(open(os.path.join(out, "fg-motion.json")))
    assert len(motion["field2cam"]) == 8 and motion["joint_so3"] == [] == motion["t_articulation"]
    assert os.path.exists(os.path.join(out, "fg.obj"))
