"""--field_type comp (the fg and bg fields composed along rays) of the port
against the JAX package: one training step of the comp model with the
tentpole's warp (comp_skel-human_dense) and with the bag of bones (bob),
through run_family_step of tests/test_torch_families.py (every loss term,
the grad norm, every gradient, one AdamW update, the param groups; each
field draws its own eikonal rays and visibility points), and
MultiFields.compose_fields of two fields against JAX's, equal depths
included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab4d_tpu.nnutils.multifields import MultiFields as JaxMultiFields
from lab4d_tpu_torch.nnutils.multifields import MultiFields
from tests.test_torch_families import TERMS, check_family_step, run_family_step


@pytest.fixture(scope="module")
def comp_human_step():
    return run_family_step("comp", "comp_skel-human_dense")


@pytest.fixture(scope="module")
def comp_bob_step():
    return run_family_step("comp", "bob")


BOTH_FIELDS = ("fields.field_params.fg.basefield", "fields.field_params.bg.basefield",
               "fields.field_params.bg.camera_mlp", "fields.field_params.fg.camera_mlp")


def test_comp_skel_human_dense_step_matches_jax(comp_human_step):
    step = comp_human_step
    assert sorted(step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    assert step["jax_loss"]["reg_soft_deform"] > 0
    check_family_step(step, BOTH_FIELDS + ("warp.post_warp.forward_map",
                                           "warp.post_warp.backward_map",
                                           "articulation.so3_head", "skinning_model"))


def test_comp_bob_step_matches_jax(comp_bob_step):
    step = comp_bob_step
    assert sorted(step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    check_family_step(step, BOTH_FIELDS + ("articulation.trans_head", "skinning_model"),
                      zero_terms=("reg_soft_deform", "reg_skel_prior"))


def test_comp_param_groups_cover_both_fields(comp_human_step):
    labels = comp_human_step["labels_port"]
    for cate in ("fg", "bg"):
        assert labels[f"fields.field_params.{cate}.logscale"] == "explicit"
        assert labels[f"fields.field_params.{cate}.basefield.backbone.linear_1.weight"] == "base"


def _fields(rng, M, N, D, equal=()):
    """Two fields' per-sample channels, with fg-only and bg-only channels;
    `equal`: sample indices at which the bg's depths copy the fg's."""
    out = {}
    for cate, lo in (("fg", 0.4), ("bg", 0.5)):
        depth = np.sort(rng.uniform(lo, 2.0, (M, N, D, 1)), axis=2).astype(np.float32)
        out[cate] = {
            "depth": depth,
            "rgb": rng.random((M, N, D, 3)).astype(np.float32),
            "density": rng.random((M, N, D, 1)).astype(np.float32),
            f"density_{cate}": rng.random((M, N, D, 1)).astype(np.float32),
            "eikonal": rng.random((M, N, D, 1)).astype(np.float32),
        }
    out["fg"]["feature"] = rng.standard_normal((M, N, D, 16)).astype(np.float32)
    for i in equal:
        out["bg"]["depth"][:, :, i] = out["fg"]["depth"][:, :, i]
    deltas = {c: rng.random((M, N, D, 1)).astype(np.float32) for c in ("fg", "bg")}
    return out, deltas


@pytest.mark.parametrize("equal", [(), (0, 5, 7)], ids=["distinct", "equal_depths"])
def test_compose_fields_matches_jax(equal):
    rng = np.random.default_rng(len(equal))
    fields, deltas = _fields(rng, 2, 3, 8, equal)
    want, want_d = JaxMultiFields.compose_fields(
        {c: {k: jnp.asarray(v) for k, v in f.items()} for c, f in fields.items()},
        {c: jnp.asarray(v) for c, v in deltas.items()})
    got, got_d = MultiFields.compose_fields(
        {c: {k: torch.tensor(v) for k, v in f.items()} for c, f in fields.items()},
        {c: torch.tensor(v) for c, v in deltas.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (2, 3, 16) + want[k].shape[3:]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert (np.diff(got["depth"].numpy()[..., 0], axis=-1) >= 0).all()
    # a channel of one field is zero at the other's samples
    assert (got["density_fg"].numpy() == 0).sum() == 2 * 3 * 8
    if equal:  # at equal depths the fg sample comes first, as jnp.argsort's stable order
        d = got["depth"].numpy()[..., 0]
        ties = np.nonzero(d[..., 1:] == d[..., :-1])
        assert len(ties[0]) >= 2 * 3 * len(equal)
        fg_first = got["density_fg"].numpy()[..., 0]
        assert (fg_first[ties[0], ties[1], ties[2]] > 0).all()


def test_compose_of_one_field_is_the_identity():
    rng = np.random.default_rng(0)
    fields, deltas = _fields(rng, 1, 2, 4)
    f = {k: torch.tensor(v) for k, v in fields["fg"].items()}
    d = torch.tensor(deltas["fg"])
    got, got_d = MultiFields.compose_fields({"fg": f}, {"fg": d})
    assert got is f and got_d is d
