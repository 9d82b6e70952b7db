"""The single-video warp families of the port against the JAX package:
one training step of the bag of bones (bob), the human skeleton
(skel-human) and the invertible NVP warp, each as the fg field, plus the
human skeleton's table and FK and the NVP map's inverse.

The step comparison (run_family_step, shared with the dense and comp
tests) follows tests/test_torch_train_fg.py: the JAX DVRModel built as
tests/test_model.py builds it (M=2 pairs, N=4 pixels) and the port's with
the bridged params take one step on the same batch and the same random
draws (numpy draws handed to the port and, in JAX's call order, through
jax.random to JAX); compared are every loss term (rtol 1e-4), the grad
norm, every gradient (per leaf, max|d| <= 1e-5 + 1e-3 max|g_jax|) and the
parameters after one AdamW update, against JAX's optax update of the
port's own gradients (every element: Adam's first step is about
lr * sign(g), so an element whose gradient is a few times Adam's eps
moves by a different amount for gradients that agree within the bound
above; the gradients themselves are held to JAX's).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lab4d_tpu.engine import trainer as jtrainer
from lab4d_tpu.engine.schedules import compute_sched as jax_compute_sched
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.engine import trainer as T
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import (
    LOSS_WEIGHTS,
    RNGS,
    init_params_with_intrinsics_prior,
    make_model_and_batch,
)
from tests.test_torch_train_fg import check_every_gradient

# one torch thread per process: the CPU steps here are small, and with six
# test workers on the host's cores the OpenMP barriers of torch's default
# thread pool stall each small op for whole scheduler slices (process-wide)
torch.set_num_threads(1)

M, N, STEP = 2, 4, 100
LR, TOTAL_STEPS = 5e-4, 400
TERMS = ("mask", "rgb", "depth", "flow", "vis", "feature", "feat_reproj", "reg_visibility",
         "reg_eikonal", "reg_deform_cyc", "reg_delta_skin", "reg_skin_entropy",
         "reg_soft_deform", "reg_gauss_skin", "reg_cam_prior", "reg_skel_prior")
# (time code, articulation head, bone Gaussian) gains of the bag of bones
GAINS = {"bob": (20.0, 10.0, 3.0)}
# reg_deform_cyc of a cycle distance that is zero but for rounding:
# reg_deform_cyc_wt * the safe_norm eps. The NVP warp is exactly invertible;
# the human skeleton at init takes each sample's nearest bone alone (its
# cycle against a non-trivial warp is held in the comp_skel-human_dense step)
CYC_FLOOR = 0.01 * 1e-6
SKINNING = ("bob", "skel-human", "skel-quad", "comp_skel-human_dense", "comp_skel-quad_dense")


def family_draws(field_type, fg_motion, seed=7):
    """The step's random draws per category, from numpy, keyed by the
    port's names; fg and bg draw differently so that a swap shows."""
    rng = np.random.default_rng(seed)
    rays = 2 * M * N
    cates = ("fg", "bg") if field_type == "comp" else (field_type,)
    draws = {}
    for cate in cates:
        d = {
            "eikonal_idx": rng.permutation(rays)[: max(1, rays // 16)],
            "vis_u": rng.random((512, 3)).astype(np.float32),
            "vis_inst": np.zeros(512, np.int64),
        }
        if cate == "fg":
            d["match_idx"] = rng.integers(0, rays * 64, 1024)
            if fg_motion in SKINNING:
                d["gauss_u"] = rng.random((2048, 3)).astype(np.float32)
            if fg_motion.startswith("comp"):
                d["soft_u"] = rng.random((1024, 3)).astype(np.float32)
                d["soft_frame"] = rng.integers(0, 12, 1024)
                d["soft_inst"] = np.zeros(1024, np.int64)
        draws[cate] = d
    return draws


def jax_draw_order(draws):
    """(jax.random function, draw) in the order the JAX training forward
    draws them: each field's query (eikonal rays, then the fg's match
    candidates), each field's visibility decay, the soft deformation, the
    gauss-skin points."""
    order = []
    for d in draws.values():
        order.append(("choice", d["eikonal_idx"]))
        if "match_idx" in d:
            order.append(("randint", d["match_idx"]))
    for d in draws.values():
        order += [("uniform", d["vis_u"]), ("randint", d["vis_inst"])]
    fg = draws.get("fg", {})
    if "soft_u" in fg:
        order += [("uniform", fg["soft_u"]), ("randint", fg["soft_frame"]),
                  ("randint", fg["soft_inst"])]
    if "gauss_u" in fg:
        order.append(("uniform", fg["gauss_u"]))
    for d in draws.values():  # the instance-code swaps (a "swap" stream of their own)
        for rand_id, u in d.get("swap", ()):
            order += [("randint", rand_id), ("uniform", u)]
    return order


def port_model(jmodel, field_type, fg_motion):
    fi = jmodel.frame_info
    return DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                    field_type=field_type, fg_motion=fg_motion, num_inst=jmodel.num_inst,
                    device="cpu",
                    intrinsics_init=jmodel.intrinsics_init, rtmat_fg=jmodel.rtmat_fg,
                    rtmat_bg=jmodel.rtmat_bg, train_res=jmodel.train_res,
                    loss_weights=LOSS_WEIGHTS)


def make_family(field_type, fg_motion):
    """(JAX model, batch, params with the intrinsics prior) at M=2, N=4.
    For the bag of bones (GAINS), the warp's time embeddings, the
    articulation heads' last layers and the bone Gaussians' widths are
    scaled: at their init the codes of all frames nearly agree (the time-t
    and rest poses with them), each sample takes its nearest bone alone,
    and the warp's cycle distance is then rounding (reg_deform_cyc is the
    safe_norm eps). The other warps stay at init."""
    jmodel, batch = make_model_and_batch(field_type, fg_motion, M=M, N=N)
    params = init_params_with_intrinsics_prior(jmodel, batch, jax_compute_sched(STEP))["params"]

    if fg_motion not in GAINS:
        return jmodel, batch, params
    time_gain, head_gain, gauss_gain = GAINS[fg_motion]

    def perturb(path, v):
        keys = [getattr(k, "key", str(k)) for k in path]
        if "warp" in keys and "time_embedding" in keys and "mapping1" in keys:
            return v * time_gain
        if "articulation" in keys and keys[-2] in ("so3_head_1", "trans_head_1"):
            return v * head_gain
        if keys[-1] == "log_gauss":
            return v + np.log(gauss_gain)
        return v

    return jmodel, batch, jax.tree_util.tree_map_with_path(perturb, params)


def run_family_step(field_type, fg_motion, built=None, draws=None, port_draws=None):
    """One training step of both packages on the same batch and draws.
    built: (JAX model, batch, params) in place of make_family's; draws: in
    place of family_draws'; port_draws: the port's draws where they differ
    from JAX's."""
    jmodel, batch, params = built or make_family(field_type, fg_motion)
    draws = draws or family_draws(field_type, fg_motion)
    queues = {}
    for name, arr in jax_draw_order(draws):
        queues.setdefault((name, arr.shape), []).append(arr)

    def fake(name, shape_arg):
        orig = getattr(jax.random, name)

        def f(*args, **kwargs):
            shape = kwargs.get("shape", args[shape_arg] if len(args) > shape_arg else None)
            q = None if shape is None else queues.get((name, tuple(shape)))
            # flax's param init, and its shape check of a parameter's
            # initializer in apply (a uniform with dtype and bounds), which
            # the (2M,) swap draws would otherwise meet at a 4-wide bias
            if not q or (name == "uniform" and len(args) > 2):
                return orig(*args, **kwargs)
            return jnp.asarray(q.pop(0))
        return f

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "choice", fake("choice", 2))
    mp.setattr(jax.random, "uniform", fake("uniform", 1))
    mp.setattr(jax.random, "randint", fake("randint", 1))
    sched = jax_compute_sched(STEP)

    def loss_fn(p):
        ld = jmodel.apply({"params": p}, batch, sched, train=True, rngs=RNGS)
        return sum(jax.tree.leaves(ld)), ld

    try:
        (total, jld), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        mp.undo()
    assert all(not q for q in queues.values()), "JAX drew fewer times than expected"
    labels = jtrainer.param_labels(params)

    def make_adamw(peak):
        sched_fn = lambda k: jtrainer.onecycle_linear(  # noqa: E731
            k + STEP, TOTAL_STEPS, peak, 2.0 / 20, 25.0, 1.0)
        return optax.adamw(sched_fn, b1=0.9, b2=0.999, weight_decay=1e-4)

    tx = optax.chain(jtrainer.clip_with_norm(5.0), optax.multi_transform(
        {"base": make_adamw(LR), "explicit": make_adamw(LR * 10), "frozen": optax.set_to_zero()},
        labels))
    updates, opt_state = tx.update(jgrads, tx.init(params), params)

    pmodel = port_model(jmodel, field_type, fg_motion)
    pmodel.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    tbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items() if k != "geo"}
    tbatch["geo"] = {c: {k: torch.tensor(np.asarray(v)) for k, v in g.items()}
                     for c, g in batch["geo"].items()}
    tdraws = {c: {k: [tuple(map(torch.tensor, p)) for p in v] if k == "swap" else torch.tensor(v)
                  for k, v in d.items()} for c, d in (port_draws or draws).items()}
    trainer = T.Trainer.__new__(T.Trainer)  # the optimizer and step, without a dataset
    trainer.model, trainer.opts = pmodel, {"learning_rate": LR, "num_rounds": 20}
    trainer.total_steps = TOTAL_STEPS
    trainer.optimizer_init()
    old = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    lrs = {n: trainer.learning_rate(STEP) * (10.0 if label == "explicit" else 1.0)
           for n, label in T.param_labels(pmodel).items()}
    pre_clip = {}

    def clip_spy(params, *args):  # the gradients as backward left them
        pre_clip.update({n: p.grad.detach().clone() for n, p in zip(trainer.param_names, params)})
        return clip(params, *args)

    clip = T.clip_with_norm
    with pytest.MonkeyPatch.context() as m:
        m.setattr(T, "clip_with_norm", clip_spy)
        pld, gnorm = trainer.train_step(tbatch, STEP, draws=tdraws)
    return {
        "jax_loss": {k: float(v) for k, v in jld.items()}, "jax_total": float(total),
        "port_loss": {k: float(v) for k, v in pld.items()},
        "jax_grads": jax.tree.map(np.asarray, jgrads),
        "port_grads": pre_clip,
        "jax_new_from_port_grads": jax.tree.map(np.asarray, optax.apply_updates(
            params, tx.update(jax.tree.map(jnp.asarray, bridge.params_to_flax(pre_clip)),
                              tx.init(params), params)[0])),
        "port_new": {n: p.detach().clone() for n, p in pmodel.named_parameters()},
        "port_old": old, "port_lrs": lrs,
        "jax_gnorm": float(opt_state[0].grad_norm), "port_gnorm": float(gnorm),
        "labels_jax": {bridge.flax_to_torch_key(p)[0]: v
                       for p, v in bridge._flatten(labels)},
        "labels_port": T.param_labels(pmodel),
        "jmodel": jmodel, "jax_params": params, "port_batch": tbatch, "port_draws": tdraws,
    }


def check_family_step(step, parts, zero_terms=(), floor_terms=()):
    """Every loss term, the grad norm, every gradient (before the
    skip-not-clip: above a norm of 5 both packages skip the step), the
    AdamW update and the param groups against JAX; each of `parts` got a
    gradient. floor_terms: terms zero but for rounding, held within 25% of
    their floor (CYC_FLOOR) and, a difference of rounded near-equal points,
    to 10x the rtol of the other terms."""
    want, got = step["jax_loss"], step["port_loss"]
    assert sorted(k for k in got if k != "total") == sorted(want)
    for k in want:
        if k in zero_terms:
            assert want[k] == 0.0 and got[k] == 0.0, k
        elif k in floor_terms:
            assert CYC_FLOOR <= min(got[k], want[k]) <= max(got[k], want[k]) <= 1.25 * CYC_FLOOR
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
            continue
        else:
            assert want[k] > 0, k  # the comparison is not vacuous
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(got["total"], step["jax_total"], rtol=1e-4)
    np.testing.assert_allclose(step["port_gnorm"], step["jax_gnorm"], rtol=1e-4)
    check_every_gradient(step, parts)
    check_adamw_update(step)
    assert step["labels_port"] == step["labels_jax"]


def check_adamw_update(step):
    """The port's AdamW step equals optax's (the JAX trainer's chain) on
    the same gradients, element by element: within 1e-4 of the group's
    learning rate (a step moves an element by up to about the learning
    rate; torch and optax round Adam's normalization in other orders)
    plus eight ulps of the parameter (the update is read as new - old)."""
    got, old, lrs = step["port_new"], step["port_old"], step["port_lrs"]
    moved = 0
    for path, new in bridge._flatten(step["jax_new_from_port_grads"]):
        key, transpose = bridge.flax_to_torch_key(path)
        want = (new.T if transpose else new) - old[key].numpy()
        have = got[key].numpy() - old[key].numpy()
        bound = 1e-4 * lrs[key] + 8 * np.spacing(np.abs(old[key].numpy()))
        bad = np.abs(have - want) > bound
        assert not bad.any(), (key, have[bad][:4], want[bad][:4])
        moved += int((np.abs(have) > 0.5 * lrs[key]).sum())
    assert moved > 0


@pytest.fixture(scope="module")
def bob_step():
    return run_family_step("fg", "bob")


@pytest.fixture(scope="module")
def human_step():
    return run_family_step("fg", "skel-human")


@pytest.fixture(scope="module")
def nvp_step():
    return run_family_step("fg", "nvp")


def test_bob_step_matches_jax(bob_step):
    assert sorted(bob_step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    check_family_step(bob_step, ("basefield", "skinning_model", "articulation.so3_head",
                                 "articulation.trans_head", "articulation.backbone"),
                      zero_terms=("reg_soft_deform", "reg_skel_prior"))


def test_skel_human_step_matches_jax(human_step):
    assert sorted(human_step["jax_loss"]) == sorted(TERMS + ("reg_gauss_mask",))
    check_family_step(human_step, ("basefield", "skinning_model", "articulation.so3_head",
                                   "articulation.log_bone_len"),
                      zero_terms=("reg_soft_deform",), floor_terms=("reg_deform_cyc",))


def test_nvp_step_matches_jax(nvp_step):
    check_family_step(nvp_step, ("basefield", "warp.map.layers.0", "warp.map.layers.5",
                                 "warp.time_embedding"),
                      zero_terms=("reg_soft_deform", "reg_gauss_skin", "reg_skel_prior",
                                  "reg_delta_skin", "reg_skin_entropy"),
                      floor_terms=("reg_deform_cyc",))


# ------------------------------------------------------------ human skeleton


def test_human_skeleton_table_matches_jax():
    from lab4d_tpu.utils import skel as jskel
    from lab4d_tpu_torch.utils import skel as pskel

    want, got = jskel.get_predefined_skeleton("human"), pskel.get_predefined_skeleton("human")
    assert got.num_joints == want.num_joints == 18
    assert got.parents == tuple(want.parents) and got.symm_idx == tuple(want.symm_idx)
    assert got.topo_order == tuple(want.topo_order)
    np.testing.assert_array_equal(got.rest_joints, np.asarray(want.rest_joints))
    # the 2.5x upscale and the GL->CV flip of the raw table
    raw = jskel._HUMAN_REST_JOINTS * 2.5
    np.testing.assert_allclose(got.rest_joints[:, 0], raw[1:, 0] + raw[0, 0])
    np.testing.assert_allclose(got.rest_joints[:, 1:], -(raw[1:, 1:] + raw[:1, 1:]))
    assert got.edges == want.edges


def test_human_fk_matches_jax():
    from lab4d_tpu.utils import skel as jskel
    from lab4d_tpu_torch.utils import skel as pskel

    js, ps = jskel.get_predefined_skeleton("human"), pskel.get_predefined_skeleton("human")
    rng = np.random.default_rng(0)
    so3 = (rng.standard_normal((3, 18, 3)) * 0.5).astype(np.float32)
    rest = np.asarray(js.rest_joints)
    local_j = jskel.rest_joints_to_local(jnp.asarray(rest), js)
    local_p = pskel.rest_joints_to_local(torch.tensor(rest), ps)
    np.testing.assert_allclose(local_p.numpy(), np.asarray(local_j), atol=1e-7)
    local = np.broadcast_to(np.asarray(local_j), (3, 18, 3))
    want = jskel.fk_se3(jnp.asarray(local), jnp.asarray(so3), js)
    got = pskel.fk_se3(torch.tensor(local.copy()), torch.tensor(so3), ps)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    wb = jskel.shift_joints_to_bones_dq(want, js)
    gb = pskel.shift_joints_to_bones_dq(got, ps)
    for w, g in zip(wb, gb):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_human_skinning_field_has_18_bones(human_step):
    grads = human_step["port_grads"]
    assert grads["fields.field_params.fg.warp.skinning_model.log_gauss"].shape == (18, 3)
    assert grads["fields.field_params.fg.warp.articulation.so3_head.1.weight"].shape[0] == 54


# ------------------------------------------------------------------------ NVP


@pytest.fixture(scope="module")
def nvp_maps():
    """The JAX NVP and the port's, with the same params."""
    from lab4d_tpu.nnutils.nvp import NVP as JNVP
    from lab4d_tpu_torch.nnutils.nvp import NVP as PNVP

    rng = np.random.default_rng(1)
    code = rng.standard_normal((4, 1, 1, 128)).astype(np.float32)
    xyz = (rng.standard_normal((4, 3, 5, 3)) * 0.3).astype(np.float32)
    jmap = JNVP(n_layers=2)
    params = jmap.init(jax.random.PRNGKey(0), jnp.asarray(code), jnp.asarray(xyz),
                       method=JNVP.forward)["params"]
    pmap = PNVP(128, n_layers=2)
    pmap.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return jmap, params, pmap, code, xyz


def test_nvp_forward_and_inverse_match_jax(nvp_maps):
    from lab4d_tpu.nnutils.nvp import NVP as JNVP

    jmap, params, pmap, code, xyz = nvp_maps
    tc, tx = torch.tensor(code), torch.tensor(xyz)
    for method, pfn in ((JNVP.forward, pmap.forward), (JNVP.inverse, pmap.inverse)):
        want = jmap.apply({"params": params}, jnp.asarray(code), jnp.asarray(xyz), method=method)
        with torch.no_grad():
            got = pfn(tc, tx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        assert float(np.abs(np.asarray(want) - xyz).max()) > 1e-3  # the map moves the points


def test_nvp_inverse_undoes_forward(nvp_maps):
    _, _, pmap, code, xyz = nvp_maps
    tc, tx = torch.tensor(code), torch.tensor(xyz)
    with torch.no_grad():
        y = pmap(tc, tx)
        torch.testing.assert_close(pmap.inverse(tc, y), tx, atol=2e-6, rtol=0)
        torch.testing.assert_close(pmap(tc, pmap.inverse(tc, tx)), tx, atol=2e-6, rtol=0)


def test_nvp_warp_backward_is_the_inverse():
    """NVPWarp: the backward warp of a forward-warped point returns it."""
    from lab4d_tpu_torch.nnutils.warping import NVPWarp

    fi = FrameInfo([0, 10], [0, 12], list(range(10)))
    warp = NVPWarp(fi, generator=torch.Generator().manual_seed(0))
    xyz = torch.randn(2, 4, 8, 3, generator=torch.Generator().manual_seed(1)) * 0.2
    fid, iid = torch.tensor([1, 7]), torch.zeros(2, dtype=torch.long)
    with torch.no_grad():
        fwd, _ = warp(xyz, fid, iid, backward=False)
        back, _ = warp(fwd, fid, iid, backward=True)
    assert float((fwd - xyz).abs().max()) > 1e-3
    torch.testing.assert_close(back, xyz, atol=2e-6, rtol=0)


# ------------------------------------------------- bone-coordinate skinning


def test_bone_coordinate_skinning_matches_jax_and_the_quad_path():
    """SkinningField where the quadratic-form path is refused (bones
    without the per-pair axis) against JAX's same path, and against the
    port's quad path on the same bones given per pair."""
    from lab4d_tpu.nnutils.embedding import FrameInfo as JFrameInfo
    from lab4d_tpu.nnutils.skinning import SkinningField as JSkinningField
    from lab4d_tpu_torch.nnutils.skinning import SkinningField

    rng = np.random.default_rng(4)
    B, Mr = 25, 2
    xyz = (rng.standard_normal((Mr, 3, 4, 3)) * 0.05).astype(np.float32)
    q = rng.standard_normal((B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = (rng.standard_normal((B, 3)) * 0.03).astype(np.float32)
    from lab4d_tpu.utils.quat import quaternion_translation_to_dual_quaternion as jdq

    bones = tuple(np.asarray(a) for a in jdq(jnp.asarray(q), jnp.asarray(t)))
    fid, iid = np.array([2, 7], np.int32), np.zeros(Mr, np.int32)
    jfi = JFrameInfo([0, 10], [0, 12], list(range(10)))
    jfield = JSkinningField(num_coords=B, frame_info=jfi, num_inst=1)
    args = (jnp.asarray(xyz), tuple(jnp.asarray(b) for b in bones), jnp.asarray(fid),
            jnp.asarray(iid))
    params = jfield.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree_util.tree_map_with_path(  # wide enough Gaussians that bones blend
        lambda p, v: v + np.log(3.0) if p[-1].key == "log_gauss" else v, params)
    want_skin, want_delta = jfield.apply({"params": params}, *args)

    field = SkinningField(B, FrameInfo([0, 10], [0, 12], list(range(10))), num_inst=1)
    field.load_state_dict(bridge.params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    tb = tuple(torch.tensor(b) for b in bones)
    targs = (torch.tensor(fid).long(), torch.tensor(iid).long())
    with torch.no_grad():
        assert not field._quad_path_ok(torch.tensor(xyz), tb)
        skin, delta = field(torch.tensor(xyz), tb, *targs)
        per_pair = tuple(b.expand((Mr,) + b.shape) for b in tb)
        assert field._quad_path_ok(torch.tensor(xyz), per_pair)
        skin_q, delta_q = field(torch.tensor(xyz), per_pair, *targs)
    assert float(np.asarray(want_delta).max()) > 0
    np.testing.assert_allclose(skin.numpy(), np.asarray(want_skin), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(skin_q, skin, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(delta_q, delta, rtol=1e-5, atol=1e-6)
