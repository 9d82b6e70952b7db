"""The multi-video category model (--nosingle_inst) of the port against
the JAX package: the instance-code swap of InstEmbedding on the same
draws, one training step of the fg field at two instances on two videos
(comp_skel-human_dense, the category tutorial's warp, and skel-quad, the
RAC case of tests/test_model_variants.py) through run_family_step of
tests/test_torch_families.py (every loss term, the grad norm, every
gradient, one AdamW update; the swap draws join JAX's draw order), the
per-instance bone lengths, and the fault the swap repairs: the same step
without the swap differs from JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab4d_tpu.engine.model import DVRModel as JaxDVRModel
from lab4d_tpu.engine.schedules import compute_sched as jax_compute_sched
from lab4d_tpu.nnutils.embedding import FrameInfo as JaxFrameInfo
from lab4d_tpu.nnutils.embedding import InstEmbedding as JaxInstEmbedding
from lab4d_tpu_torch.engine.schedules import compute_sched
from lab4d_tpu_torch.nnutils.embedding import InstEmbedding, SwapDraws
from tests.test_model import LOSS_WEIGHTS, init_params_with_intrinsics_prior, make_model_and_batch
from tests.test_torch_families import (
    STEP,
    TERMS,
    check_family_step,
    family_draws,
    port_model,
    run_family_step,
)

torch.set_num_threads(1)  # as tests/test_torch_families.py

M, N = 2, 4
NUM_FRAMES = 10
# two videos of 5 filtered frames (6 raw frames) each
FRAME_OFFSET, FRAME_OFFSET_RAW = [0, 5, 10], [0, 6, 12]
FRAME_MAPPING = [0, 1, 2, 3, 4, 6, 7, 8, 9, 10]


# ---------------------------------------------------------------- the swap


def _jax_swap(num_inst, inst_id, rand_id, u, beta_prob, train):
    """JAX's InstEmbedding on inst_id with its swap draws replaced by
    (rand_id, u); returns (codes, its table, draws taken)."""
    emb = JaxInstEmbedding(num_inst=num_inst, inst_channels=8)
    params = emb.init(jax.random.PRNGKey(0), jnp.asarray(inst_id))["params"]
    taken = []

    def randint(key, shape, *args, **kwargs):
        taken.append("randint")
        assert tuple(shape) == rand_id.shape
        return jnp.asarray(rand_id)

    def uniform(key, shape=(), *args, **kwargs):
        taken.append("uniform")
        assert tuple(shape) == u.shape
        return jnp.asarray(u)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", randint)
        mp.setattr(jax.random, "uniform", uniform)
        out = emb.apply({"params": params}, jnp.asarray(inst_id), beta_prob=beta_prob,
                        train=train, rngs={"swap": jax.random.PRNGKey(2)})
    return np.asarray(out), np.asarray(params["mapping"]["embedding"]), taken


@pytest.mark.parametrize("num_inst,beta_prob,train", [
    (3, 0.6, True), (3, 1.0, True), (3, 0.6, False), (3, None, True), (1, 0.6, True)])
def test_inst_embedding_swap_matches_jax(num_inst, beta_prob, train):
    """One random id per leading row, broadcast over the row; an element
    takes it where its uniform draw is below beta_prob; only in training
    with a beta_prob, and never for one instance (which draws nothing)."""
    rng = np.random.default_rng(3)
    inst_id = rng.integers(0, num_inst, (4, 5)).astype(np.int32)
    rand_id = rng.integers(0, num_inst, (4,)).astype(np.int32)
    u = rng.random((4, 5)).astype(np.float32)
    want, table, taken = _jax_swap(num_inst, inst_id, rand_id, u, beta_prob, train)
    emb = InstEmbedding(num_inst, 8)
    with torch.no_grad():
        emb.mapping.weight.copy_(torch.tensor(table))
    swap = SwapDraws([(torch.tensor(rand_id, dtype=torch.long), torch.tensor(u))])
    got = emb(torch.tensor(inst_id, dtype=torch.long), beta_prob=beta_prob, train=train,
              swap=swap).detach().numpy()
    np.testing.assert_array_equal(got, want)
    swaps = num_inst > 1 and train and beta_prob is not None
    assert len(swap.pairs) == (0 if swaps else 1) and len(taken) == (2 if swaps else 0)
    if swaps:  # the comparison is not vacuous: codes moved where the mask held
        moved = (u < beta_prob) & (rand_id[:, None] != inst_id)
        assert moved.any() and not np.array_equal(got, table[inst_id])


def test_inst_embedding_swap_from_a_generator():
    """Without given pairs the draws come from the step's swap key (the
    port's generator of JAX's draws, utils/jax_random.py): the same key
    gives the same codes, and one call draws one pair."""
    from lab4d_tpu_torch.utils import jax_random as jr

    emb = InstEmbedding(4, 8, generator=torch.Generator().manual_seed(0))
    inst_id = torch.arange(4).repeat(3, 1)

    def codes(seed):
        return emb(inst_id, beta_prob=0.9, train=True, swap=SwapDraws(key=jr.PRNGKey(seed)))

    torch.testing.assert_close(codes(5), codes(5), rtol=0, atol=0)
    assert not torch.equal(codes(5), emb(inst_id))


# ------------------------------------------------------- the category step


def make_category(fg_motion):
    """(JAX model at num_inst=2 over two videos, batch, params with the
    intrinsics prior): make_model_and_batch's batch at M=2, N=4, the first
    pair from video 0 and the second from video 1, frames within each."""
    _, batch = make_model_and_batch("fg", fg_motion, M=M, N=N)
    fi = JaxFrameInfo(FRAME_OFFSET, FRAME_OFFSET_RAW, FRAME_MAPPING)
    rt = np.tile(np.eye(4, dtype=np.float32)[None], (NUM_FRAMES, 1, 1))
    rt[:, 2, 3] = 1.0
    intr = np.tile(np.array([100.0, 100.0, 32.0, 32.0], np.float32)[None], (NUM_FRAMES, 1))
    jmodel = JaxDVRModel(frame_info=fi, field_type="fg", fg_motion=fg_motion, num_inst=2,
                         train_res=64, intrinsics_init=intr, rtmat_fg=rt, rtmat_bg=rt,
                         loss_weights=LOSS_WEIGHTS)
    batch = dict(batch)
    batch["dataid"] = jnp.asarray(np.array([[0, 0], [1, 1]], np.int32))
    batch["frameid_sub"] = jnp.asarray(np.array([[1, 4], [0, 5]], np.int32))
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]
    return jmodel, batch, params


def category_draws(fg_motion, seed=11):
    """family_draws' draws with instance ids over the two instances, and
    the swaps of the base and colour MLPs ((2M,) ids, (2M,) uniforms)."""
    rng = np.random.default_rng(seed)
    draws = family_draws("fg", fg_motion)
    d = draws["fg"]
    d["vis_inst"] = rng.integers(0, 2, 512)
    if "soft_inst" in d:
        d["soft_inst"] = rng.integers(0, 2, 1024)
    d["swap"] = [(rng.integers(0, 2, 2 * M), rng.random(2 * M).astype(np.float32))
                 for _ in range(2)]
    return draws


def run_category_step(fg_motion):
    draws = category_draws(fg_motion)
    step = run_family_step("fg", fg_motion, built=make_category(fg_motion), draws=draws)
    step["draws"] = draws
    return step


@pytest.fixture(scope="module")
def human_cate_step():
    return run_category_step("comp_skel-human_dense")


@pytest.fixture(scope="module")
def quad_cate_step():
    return run_category_step("skel-quad")


CODES = ("basefield.inst_embedding", "colorfield.inst_embedding", "vis_mlp.basefield",
         "log_bone_len.inst_embedding")


def test_category_comp_skel_human_dense_step_matches_jax(human_cate_step):
    step = human_cate_step
    assert sorted(step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    assert step["jax_loss"]["reg_soft_deform"] > 0
    check_family_step(step, CODES + ("warp.post_warp.forward_map", "skinning_model"))


def test_category_skel_quad_step_matches_jax(quad_cate_step):
    step = quad_cate_step
    assert sorted(step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    # the skeleton at init takes each sample's nearest bone alone: the cycle
    # distance is rounding (CYC_FLOOR), as for skel-human's family step
    check_family_step(step, CODES + ("articulation.so3_head", "skinning_model"),
                      zero_terms=("reg_soft_deform",), floor_terms=("reg_deform_cyc",))


def test_category_tables_are_per_video(quad_cate_step):
    grads = quad_cate_step["port_grads"]
    fg = "fields.field_params.fg."
    assert grads[fg + "basefield.inst_embedding.mapping.weight"].shape == (2, 32)
    assert grads[fg + "camera_mlp.base_quat"].shape == (2, 4)
    # each video's code is trained by its own rows (or a swap into it)
    assert (grads[fg + "basefield.inst_embedding.mapping.weight"].abs().amax(1) > 0).all()


@pytest.mark.parametrize("fixture", ["human_cate_step", "quad_cate_step"])
def test_category_step_without_the_swap_differs_from_jax(fixture, request):
    """The fault the swap repairs: the port's step with no code swapped (as
    it was before the swap, every uniform draw above beta_prob) against
    JAX's swapped step. The draws swap some row to another instance."""
    step = request.getfixturevalue(fixture)
    beta = compute_sched(STEP)["beta_prob"]
    pairs = step["draws"]["fg"]["swap"]
    ids = np.repeat(np.array([0, 1]), 2)
    assert any(((u < beta) & (r != ids)).any() for r, u in pairs)
    motion = step["jmodel"].fg_motion
    model = port_model(step["jmodel"], "fg", motion)
    model.load_state_dict(step["port_old"])
    draws = {c: dict(d) for c, d in step["port_draws"].items()}
    draws["fg"]["swap"] = [(r, torch.ones_like(u)) for r, u in draws["fg"]["swap"]]
    with torch.no_grad():
        loss = model(step["port_batch"], compute_sched(STEP), draws=draws)
    rel = {k: abs(float(loss[k]) - v) / abs(v) for k, v in step["jax_loss"].items() if v}
    # ten times the step comparison's rtol (1e-4), in the terms of the rays
    assert max(rel[k] for k in ("depth", "vis", "reg_skin_entropy")) > 1e-3, rel


def test_per_instance_bone_lengths_match_jax(quad_cate_step):
    """ArticulationSkelMLP at two instances: the rest bones of
    get_mean_vals(inst_id), and the time-t and rest bones of
    get_vals_and_mean, against JAX's; the instances' bones differ."""
    step = quad_cate_step
    jmodel, params = step["jmodel"], step["jax_params"]
    model = port_model(jmodel, "fg", "skel-quad")
    model.load_state_dict(step["port_old"])
    arti = model.fields.field_params["fg"].warp.articulation
    inst = np.array([0, 1, 1, 0], np.int32)
    fid = np.array([1, 7, 9, 3], np.int32)

    def jax_arti(fn):
        return jmodel.apply({"params": params},
                            method=lambda m: fn(m.fields.field_params["fg"].warp.articulation))

    with torch.no_grad():
        got_rest = arti.get_mean_vals(torch.tensor(inst, dtype=torch.long))
        got_t, got_mean = arti.get_vals_and_mean(torch.tensor(fid, dtype=torch.long))
        got_len = arti.compute_rel_rest_joints(torch.tensor([0, 1]), batch_shape=(2,))
    want_rest = jax_arti(lambda a: a.get_mean_vals(jnp.asarray(inst)))
    want_t, want_mean = jax_arti(lambda a: a.get_vals_and_mean(jnp.asarray(fid)))
    for got, want in ((got_rest, want_rest), (got_t, want_t), (got_mean, want_mean)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    assert float((got_len[0] - got_len[1]).abs().max()) > 1e-4
