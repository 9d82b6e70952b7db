"""The render CLI's default eval and its channel subsets: the port's top-k
eval (`evaluate_rays(..., topk=K)`) and `channels` against the JAX
package's LAB4D_EVAL_TOPK and LAB4D_EVAL_CHANNELS, and the port's bev
viewpoint of a bg model against JAX's.

- top-k: the JAX DVRModel and the port's with the bridged params render
  the same 64 rays of one frame at K = 8 and 16, for the flagship fg /
  skel-quad model and the rigid fg model; every channel is compared with
  tests/test_torch_render.py's TOL on the rays whose K-th and (K+1)-th
  union weights differ by more than TIE_GAP (elsewhere the two packages
  may pick other samples through rounding alone), which must be at least
  95% of the rays; the mask on every ray;
- the port's top-k with K = 64 selects every union sample and reproduces
  its exact eval (rtol / atol 5e-4, as tests/test_eval_merged.py holds
  JAX's);
- ties: the port picks jax.lax.top_k's indices on all-zero and repeated
  weights;
- channels: the port's subset equals its full pass within 1e-6 and holds
  the requested channels alone; it matches JAX's subset with TOL.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab4d_tpu.engine.schedules import compute_sched
from lab4d_tpu_torch.bridge import params_from_flax
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils import nerf as port_nerf
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import init_params_with_intrinsics_prior, make_model_and_batch
from tests.test_torch_render import TOL

N_RAYS = 64
TIE_GAP = 1e-5  # |w_K - w_(K+1)| at or below it: a near tie (weights in [0, 1], fp32)
MOTIONS = ("skel-quad", "rigid")
SUBSETS = ("rgb,depth,mask", "normal,mask", "gauss_mask,mask")


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def models(monkeypatch_module):
    """{fg_motion: (JAX model, geo, params, port model, eval batch)}."""
    for k in ("LAB4D_EVAL_TOPK", "LAB4D_EVAL_CHANNELS", "LAB4D_EVAL_MERGED"):
        monkeypatch_module.delenv(k, raising=False)
    rng = np.random.default_rng(0)
    hxy = np.concatenate(
        [rng.uniform(0, 64, (1, N_RAYS, 2)), np.ones((1, N_RAYS, 1))], -1).astype(np.float32)
    batch = {"dataid": np.zeros(1, np.int64), "frameid_sub": np.array([3], np.int64),
             "crop2raw": np.array([[1.0, 1.0, 0.0, 0.0]], np.float32), "hxy": hxy}
    out = {}
    for motion in MOTIONS:
        jmodel, jbatch = make_model_and_batch("fg", motion, M=2, N=4)
        variables = init_params_with_intrinsics_prior(jmodel, jbatch, compute_sched(100))
        params = jax.tree.map(np.asarray, dict(variables["params"]))
        fi = jmodel.frame_info
        model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                         fg_motion=motion, device="cpu")
        model.load_state_dict(params_from_flax(params), strict=True)
        out[motion] = (jmodel, jbatch["geo"], params, model.eval().requires_grad_(False), batch)
    return out


def jax_eval(entry, env):
    """JAX's evaluate_rays under the given LAB4D_EVAL_* variables (read at
    trace time, so each call traces anew)."""
    jmodel, geo, params, _, batch = entry
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        def run(p, b):
            samples = jmodel.apply({"params": p}, b, method=jmodel.prepare_eval_samples)
            return jmodel.apply({"params": p}, samples, sched=None, method=jmodel.evaluate_rays)

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["geo"] = geo
        return {k: np.asarray(v) for k, v in jax.jit(run)(params, jb).items()}
    finally:
        mp.undo()


def port_eval(entry, **kwargs):
    """The port's evaluate_rays; with topk, also the union weights of each
    ray (the input of nerf.topk_indices)."""
    jmodel, geo, _, model, batch = entry
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["geo"] = {"fg": {k: torch.tensor(np.asarray(v)) for k, v in geo["fg"].items()}}
    seen = []
    orig = port_nerf.topk_indices

    def record(weights, k):
        seen.append(weights.numpy().reshape(-1, weights.shape[-1]))
        return orig(weights, k)

    port_nerf.topk_indices = record
    try:
        with torch.no_grad():
            out = model.evaluate_rays(model.prepare_eval_samples(tb), **kwargs)
    finally:
        port_nerf.topk_indices = orig
    return {k: v.numpy() for k, v in out.items()}, (seen[0] if seen else None)


@pytest.fixture(scope="module")
def topk_both(models):
    out = {}
    for motion in MOTIONS:
        for k in (8, 16):
            got, w_all = port_eval(models[motion], topk=k)
            want = jax_eval(models[motion], {"LAB4D_EVAL_TOPK": str(k)})
            w_sorted = -np.sort(-w_all, axis=-1)
            kept = np.abs(w_sorted[:, k - 1] - w_sorted[:, k]) > TIE_GAP
            out[motion, k] = got, want, kept, w_all
    return out


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("motion", MOTIONS)
def test_topk_matches_jax(topk_both, motion, k):
    got, want, kept, w_all = topk_both[motion, k]
    assert sorted(got) == sorted(want) == sorted(
        TOL if motion == "skel-quad" else set(TOL) - {"gauss_mask"})
    # not vacuous: rays hit the object, and their weights spread over more
    # than K samples, so the selection matters
    assert float(want["mask"].max()) > 0.1
    assert (np.count_nonzero(w_all > 1e-6, axis=-1) > k).any()
    print(f"{motion} K={k}: {int((~kept).sum())} of {len(kept)} rays set aside as near ties")
    assert kept.mean() >= 0.95
    np.testing.assert_allclose(got["mask"], want["mask"], **TOL["mask"])
    for name in sorted(got):
        a, b = got[name][0][kept], want[name][0][kept]
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL[name])


@pytest.mark.parametrize("motion", MOTIONS)
def test_topk_full_budget_matches_exact(models, motion, monkeypatch):
    """K = n_depth dispatches to the exact path; forced through the top-k
    implementation it selects every union sample and must give the exact
    eval's channels."""
    exact, _ = port_eval(models[motion])

    def force_topk(self, samples_dict, n_depth=64, topk=None, channels=None):
        return self.query_field_eval_topk(samples_dict, n_depth=n_depth, topk=n_depth,
                                          channels=channels)

    monkeypatch.setattr(port_nerf.NeRF, "query_field_eval", force_topk)
    topk, w_all = port_eval(models[motion])
    assert w_all is not None and w_all.shape[-1] == 64
    assert sorted(exact) == sorted(topk)
    for k in exact:
        np.testing.assert_allclose(topk[k], exact[k], rtol=5e-4, atol=5e-4, err_msg=k)


TIE_CASES = {
    "all-zero": np.zeros((3, 64), np.float32),
    "repeated": np.tile(np.array([0.1, 0.3, 0.3, 0.0, 0.3, 0.2, 0.2, 0.3, 0.1, 0.2] * 6
                                 + [0.3, 0.0, 0.2, 0.3], np.float32), (2, 1)),
    "random-with-repeats": np.random.default_rng(3).integers(0, 5, (4, 64)).astype(np.float32)
    / 4.0,
}


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_topk_ties_pick_jax_indices(case, k):
    w = TIE_CASES[case]
    want = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(w), k)[1]), axis=-1)
    got = port_nerf.topk_indices(torch.tensor(w), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def channels_both(models):
    entry = models["skel-quad"]
    full, _ = port_eval(entry)
    out = {}
    for subset in SUBSETS:
        keys = frozenset(subset.split(","))
        got, _ = port_eval(entry, channels=keys)
        want = jax_eval(entry, {"LAB4D_EVAL_CHANNELS": subset})
        out[subset] = got, want, full
    return out


@pytest.mark.parametrize("subset", SUBSETS)
def test_channels_match_the_full_pass(channels_both, subset):
    got, _, full = channels_both[subset]
    assert sorted(got) == sorted(subset.split(","))
    for k, v in got.items():
        np.testing.assert_allclose(v, full[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("subset", SUBSETS)
def test_channels_match_jax(channels_both, subset):
    got, want, _ = channels_both[subset]
    for k in subset.split(","):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL[k])
    # JAX's eval skips the same producers
    for k in {"normal", "eikonal", "feature", "vis", "cyc_dist", "gauss_mask"} - set(got):
        if k != "eikonal" or "normal" not in got:
            assert k not in want, k


def test_topk_with_channels(models):
    """The CLI's default top-k with a channel subset: the subset of the
    top-k eval's channels."""
    entry = models["skel-quad"]
    full, _ = port_eval(entry, topk=8)
    got, _ = port_eval(entry, topk=8, channels=frozenset({"rgb", "mask"}))
    assert sorted(got) == ["mask", "rgb"]
    for k, v in got.items():
        np.testing.assert_allclose(v, full[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_bev_of_a_bg_model_matches_jax():
    """The bev viewpoint of a bg model: the port's render batch poses the
    camera above the first frame's, as JAX's does."""
    from lab4d_tpu.render import construct_batch_from_opts as jax_construct
    from lab4d_tpu_torch.render import construct_batch_from_opts

    jmodel, jbatch = make_model_and_batch("bg", M=2, N=4)
    params = jax.tree.map(np.asarray, dict(
        init_params_with_intrinsics_prior(jmodel, jbatch, compute_sched(100))["params"]))
    fi = jmodel.frame_info
    model = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                     field_type="bg", device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    model.eval().requires_grad_(False)
    geo_state = {"bg": {"aabb": np.asarray(jbatch["geo"]["bg"]["aabb"])}}
    opts = {"inst_id": 0, "render_res": 16, "viewpoint": "bev-30", "freeze_id": 2,
            "num_frames": 3, "noskip": False}
    jb, jraw = jax_construct(opts, jmodel, params, geo_state, None,
                             {"raw_size": [(64, 64)], "frame_info": fi})
    pb, praw = construct_batch_from_opts(opts, model, geo_state,
                                         {"raw_size": [(64, 64)], "frame_info": model.frame_info},
                                         "cpu")
    assert tuple(praw) == tuple(jraw) and sorted(pb["field2cam"]) == ["bg"]
    np.testing.assert_allclose(pb["field2cam"]["bg"].numpy(), np.asarray(jb["field2cam"]["bg"]),
                               atol=1e-5)
    np.testing.assert_allclose(pb["Kinv"].numpy(), np.asarray(jb["Kinv"]), rtol=1e-6)
