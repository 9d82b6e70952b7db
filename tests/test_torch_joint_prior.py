"""The skeleton's joint-angle prior fit (mlp_init step 3) of the port
against the JAX package's.

- ArticulationSkelMLP.prior_fit_loss and its gradients (every parameter
  leaf, bridged) against JAX's at the same params and a seeded smooth
  prior (M frames x 25 bones x 3), rtol 1e-5 (per leaf: max|d| <= 1e-5
  max|g_jax| + 1e-9);
- the trainer runs the fit exactly when JAX's does: "joint_angles" in the
  dataset metadata and fg_motion skel-* or comp_* (rigid, bob, dense and
  nvp do not fit; nothing fits without a prior). Both mlp_inits run with
  their fits and the geometry distillation recorded instead of run;
- the fit itself (init_utils.fit_until_converged at tol 1e-4 on both
  sides, JAX's jitted while_loop and the port's Adam loop): the final
  losses within 1e-4 absolute and 1e-2 relative, and the update counts
  within 10%.

On the CPU the articulation's TimeMLP backbone runs K3f / K3b's plain
versions; on the card the same fit launches the kernels (chip_smoke.py
[joint-prior]).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from lab4d_tpu.engine import init_utils as jax_init_utils
from lab4d_tpu.engine import trainer as jtrainer
from lab4d_tpu.engine.schedules import compute_sched as jax_compute_sched
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.engine import init_utils
from lab4d_tpu_torch.engine import trainer as T
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import LOSS_WEIGHTS, init_params_with_intrinsics_prior, make_model_and_batch

NUM_BONES = 25  # the quadruped skeleton's joints


def smooth_prior(num_frames, seed=0, bones=NUM_BONES):
    """(M, B, 3) joint angles: a seeded sinusoid per degree of freedom."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.05, 0.3, (1, bones, 3))
    phase = rng.uniform(0, 2 * np.pi, (1, bones, 3))
    t = np.arange(num_frames, dtype=np.float64)[:, None, None] / num_frames
    return (amp * np.sin(2 * np.pi * t + phase)).astype(np.float32)


def _jax_skel_loss(jmodel):
    def loss(p):
        return jmodel.apply({"params": p}, method=lambda m: m.fields.field_params[
            "fg"].warp.articulation.prior_fit_loss())
    return loss


@pytest.fixture(scope="module")
def models():
    jmodel, batch = make_model_and_batch("fg", "skel-quad", M=2, N=4)
    fi = jmodel.frame_info
    prior = smooth_prior(fi.num_frames)
    jmodel = jmodel.clone(joint_angles_init=prior)
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(0))["params"]
    pmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      field_type="fg", fg_motion="skel-quad", device="cpu",
                      intrinsics_init=jmodel.intrinsics_init, rtmat_fg=jmodel.rtmat_fg,
                      rtmat_bg=jmodel.rtmat_bg, train_res=jmodel.train_res,
                      loss_weights=LOSS_WEIGHTS, joint_angles_init=prior)
    pmodel.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return jmodel, params, pmodel, prior


def test_prior_is_a_buffer_on_the_articulation(models):
    _, _, pmodel, prior = models
    arti = pmodel.fields.field_params["fg"].warp.articulation
    np.testing.assert_array_equal(arti.joint_angles_init.numpy(), prior)
    assert "joint_angles_init" not in "".join(pmodel.state_dict())  # not in checkpoints


def test_prior_fit_loss_and_gradients_match_jax(models):
    jmodel, params, pmodel, _ = models
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_skel_loss(jmodel)))(params)
    pmodel.zero_grad(set_to_none=True)
    loss = pmodel.fields.field_params["fg"].warp.articulation.prior_fit_loss()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    pgrads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
              for n, p in pmodel.named_parameters()}
    got = dict(bridge._flatten(bridge.params_to_flax(pgrads)))
    want = dict(bridge._flatten(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    moved = 0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        d = float(np.abs(np.asarray(got[k]) - w).max())
        assert d <= 1e-5 * scale + 1e-9, (k, d, scale)
        moved += scale > 0
    assert moved >= 10  # the articulation's backbone, heads and time embedding


def test_prior_fit_converges_like_jax(models, capsys):
    jmodel, params, pmodel, _ = models
    pmodel = copy.deepcopy(pmodel)
    jax_loss = _jax_skel_loss(jmodel)
    fitted = jax_init_utils.fit_until_converged(jax_loss, params, tol=1e-4, log_name="skeleton")
    jiters = int(capsys.readouterr().out.split(" after ")[1].split()[0])
    arti = pmodel.fields.field_params["fg"].warp.articulation
    with torch.no_grad():
        start = float(arti.prior_fit_loss())
    loss, iters = init_utils.fit_until_converged(arti.prior_fit_loss, pmodel.parameters(),
                                                 tol=1e-4, log_name="skeleton")
    assert start > 1e-3  # the fit has work to do
    assert loss <= 1e-4 < start
    assert abs(iters - jiters) <= 0.1 * jiters, (iters, jiters)
    with torch.no_grad():
        after = float(arti.prior_fit_loss())
    jafter = float(jax_loss(fitted))
    assert abs(after - jafter) <= 1e-4
    # both stop at 1e-4, so the ends are also held relative to their size
    assert abs(after - jafter) <= 1e-2 * max(after, jafter), (after, jafter)


# ------------------------------------------------------- mlp_init's gate

MOTIONS = ("rigid", "bob", "dense", "nvp", "skel-human", "skel-quad", "comp_skel-human_dense",
           "comp_skel-quad_dense")


@pytest.fixture(scope="module")
def scene_info(tmp_path_factory):
    from lab4d_tpu.dataloader import data_utils as jax_data
    from lab4d_tpu_torch.dataloader import data_utils
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("prior")
    make_synthetic_dataset(str(root / "database"), seqname="prior", num_frames=8, res=16)
    opts = dict(seqname="prior", data_prefix="crop", train_res=16, feature_type="dinov2",
                pixels_per_image=4, database_root=str(root / "database"))
    return (jax_data.get_data_info(jax_data.config_to_datasets(opts, is_eval=True)),
            data_utils.get_data_info(data_utils.config_to_datasets(opts, is_eval=True)))


def _fits_run(monkeypatch, info, motion, package):
    """The log names of the prior fits `package`'s Trainer.mlp_init runs
    for `motion` on metadata `info` (fits recorded, not run)."""
    names = []
    if package == "jax":
        def fit(loss_fn, params, tol, lr=1e-3, max_iters=5000, log_name="fit"):
            names.append((log_name, tol))
            return params
        monkeypatch.setattr(jtrainer.init_utils, "fit_until_converged", fit)
        monkeypatch.setattr(jtrainer.init_utils, "fit_geometry", lambda model, params, pools: params)
        trainer = jtrainer.Trainer.__new__(jtrainer.Trainer)
        trainer.params = {}
        trainer.model = None
    else:
        def fit(loss_fn, params, tol, lr=1e-3, max_iters=5000, log_name="fit"):
            names.append((log_name, tol))
            return 0.0, 0
        monkeypatch.setattr(T.init_utils, "fit_until_converged", fit)
        monkeypatch.setattr(T.init_utils, "fit_geometry", lambda model, pools, num_steps: (0, 0))
        trainer = T.Trainer.__new__(T.Trainer)
        trainer.model = DVRModel(info["frame_info"], field_type="fg", fg_motion=motion,
                                 device="cpu", intrinsics_init=info["intrinsics"],
                                 rtmat_fg=info["rtmat"][1], rtmat_bg=info["rtmat"][0],
                                 joint_angles_init=info.get("joint_angles"))
    trainer.data_info = info
    trainer.opts = {"fg_motion": motion, "geo_init_steps": 1}
    trainer.categories = ("fg",)
    monkeypatch.setattr(type(trainer), "_build_geometry_pools", lambda self, num_steps: {})
    trainer.mlp_init()
    return names


@pytest.mark.parametrize("with_prior", [True, False], ids=["prior", "no-prior"])
@pytest.mark.parametrize("motion", MOTIONS)
def test_skeleton_fit_runs_when_jax_runs_it(monkeypatch, scene_info, motion, with_prior):
    jinfo, pinfo = (dict(i) for i in scene_info)
    if with_prior:
        prior = smooth_prior(pinfo["frame_info"].num_frames)
        jinfo["joint_angles"] = pinfo["joint_angles"] = prior
    want = _fits_run(monkeypatch, jinfo, motion, "jax")
    got = _fits_run(monkeypatch, pinfo, motion, "torch")
    assert got == want
    runs = with_prior and motion.startswith(("skel", "comp"))
    assert (("skeleton", 1e-4) in got) == runs
    assert got[:2] == [("camera", 1e-4), ("intrinsics", 1.0)]
