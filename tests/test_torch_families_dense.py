"""The dense-warp families of the port against the JAX package: one
training step of the dense translation fields (dense) and of the
quadruped skeleton composed with a soft dense post-warp
(comp_skel-quad_dense), each as the fg field (run_family_step of
tests/test_torch_families.py: every loss term, the grad norm, every
gradient, one AdamW update, the param groups), and the composed warp's
pieces: its forward and backward order and the soft-deformation loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab4d_tpu_torch import bridge
from tests.test_torch_families import (
    M,
    TERMS,
    check_family_step,
    make_family,
    port_model,
    run_family_step,
)


@pytest.fixture(scope="module")
def dense_step():
    return run_family_step("fg", "dense")


@pytest.fixture(scope="module")
def comp_quad_step():
    return run_family_step("fg", "comp_skel-quad_dense")


def test_dense_step_matches_jax(dense_step):
    assert sorted(dense_step["jax_loss"]) == sorted(TERMS)
    check_family_step(dense_step, ("basefield", "warp.forward_map", "warp.backward_map",
                                   "warp.time_embedding"),
                      zero_terms=("reg_soft_deform", "reg_gauss_skin", "reg_skel_prior",
                                  "reg_delta_skin", "reg_skin_entropy"))


def test_comp_skel_quad_dense_step_matches_jax(comp_quad_step):
    assert sorted(comp_quad_step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    assert comp_quad_step["jax_loss"]["reg_soft_deform"] > 0
    check_family_step(comp_quad_step, ("basefield", "warp.post_warp.forward_map",
                                       "warp.post_warp.backward_map", "skinning_model",
                                       "articulation.so3_head"))


@pytest.fixture(scope="module")
def comp_quad_models():
    jmodel, _, params = make_family("fg", "comp_skel-quad_dense")
    pmodel = port_model(jmodel, "fg", "comp_skel-quad_dense")
    pmodel.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return jmodel, params, pmodel


@pytest.mark.parametrize("backward", [False, True])
def test_composed_warp_matches_jax(comp_quad_models, backward):
    """ComposedWarp at (M, N, D, 3) points: the post-warp before skinning
    going forward, after it going backward."""
    jmodel, params, pmodel = comp_quad_models
    rng = np.random.default_rng(2)
    xyz = (rng.standard_normal((M, 4, 8, 3)) * 0.1).astype(np.float32)
    fid, iid = np.array([1, 6], np.int32), np.zeros(M, np.int32)

    want = jmodel.apply(
        {"params": params},
        method=lambda m: m.fields.field_params["fg"].warp(
            jnp.asarray(xyz), jnp.asarray(fid), jnp.asarray(iid), backward=backward)[0])
    warp = pmodel.fields.field_params["fg"].warp
    with torch.no_grad():
        got, _ = warp(torch.tensor(xyz), torch.tensor(fid).long(), torch.tensor(iid).long(),
                      backward=backward)
    assert float(np.abs(np.asarray(want) - xyz).max()) > 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_post_warp_dist2_matches_jax(comp_quad_models):
    jmodel, params, pmodel = comp_quad_models
    rng = np.random.default_rng(3)
    pts = (rng.random((64, 1, 1, 3)) * 0.4 - 0.2).astype(np.float32)
    fid = rng.integers(0, 12, 64).astype(np.int32)
    iid = np.zeros(64, np.int32)
    want = jmodel.apply(
        {"params": params},
        method=lambda m: m.fields.field_params["fg"].warp.compute_post_warp_dist2(
            jnp.asarray(pts), jnp.asarray(fid), jnp.asarray(iid)))
    with torch.no_grad():
        got = pmodel.fields.field_params["fg"].warp.compute_post_warp_dist2(
            torch.tensor(pts), torch.tensor(fid).long(), torch.tensor(iid).long())
    assert float(np.asarray(want).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-12)


def test_soft_deform_loss_is_zero_without_a_post_warp(dense_step):
    """Only the composed warp has a soft-deformation term."""
    assert dense_step["port_loss"]["reg_soft_deform"] == 0.0
