"""Helpers of the whole-step stream tests (tests/test_torch_jax_streams_
step_*.py): both packages' trainers on one tiny synthetic scene, from
their own inits, with every random draw of the JAX side recorded.

- `build_pair`: the JAX Trainer and the port's Trainer on the same flags,
  each model's params captured before its prior fits, the JAX trainer's
  `jax.random.choice` draws (model.init's eikonal rays, then the
  geometry fit's, in step order) recorded through ordered debug
  callbacks, as tests/test_torch_skel_quad_psnr.py's recorder does.
- `check_init`: the port's params at construction against flax's
  model.init at PRNGKey(0), leaf by leaf.
- `check_prior_fit`: the geometry fit's eikonal rays of every step.
- `check_steps`: two training steps; the JAX steps' draws recorded by
  test_torch_skel_quad_psnr.jax_rounds, the port's derived by its own
  trainer (its swaps recorded at SwapDraws.take), compared by
  (function, shape) in call order; the port started from the JAX side's
  fitted params (its checkpoint), the first step's loss terms equal
  within the one-step tests' tolerance.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from lab4d_tpu_torch.tools import compare_psnr as CP
from tests import test_torch_skel_quad_psnr as SQ

RES, FRAMES, ITERS = 16, 9, 2
FLAGS = ("--geo_init_steps", "3", "--eval_res", "8", "--num_rounds", "1")


def make_db(workdir, num_vids):
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    db = os.path.join(workdir, "database")
    make_synthetic_dataset(db, seqname=CP.SEQNAME, num_vids=num_vids, num_frames=FRAMES,
                           res=RES, feat_res=112, scale_step=0.2 if num_vids > 1 else 0.0)
    return db


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def build_pair(workdir, extra):
    """(JAX trainer, its checkpoint path, port trainer, captured) with
    captured = {"jax_init", "port_init": flax param trees before the
    prior fits, "choice": the JAX side's recorded choice draws}."""
    import jax
    from lab4d_tpu.engine import trainer as jtrainer_mod

    from lab4d_tpu_torch import bridge
    from lab4d_tpu_torch.engine import trainer as ptrainer_mod

    captured = {"choice": []}
    mp = pytest.MonkeyPatch()
    jfit, pfit = jtrainer_mod.Trainer.mlp_init, ptrainer_mod.Trainer.mlp_init

    def jax_mlp_init(self):
        captured["jax_init"] = jax.tree.map(np.asarray, self.params)
        return jfit(self)

    def port_mlp_init(self):
        captured["port_init"] = bridge.params_to_flax(
            {n: p.detach().clone() for n, p in self.model.named_parameters()})
        return pfit(self)

    orig_choice = jax.random.choice

    def choice(*args, **kwargs):
        out = orig_choice(*args, **kwargs)
        jax.debug.callback(lambda v: captured["choice"].append(np.asarray(v)), out,
                           ordered=True)
        return out

    mp.setattr(jtrainer_mod.Trainer, "mlp_init", jax_mlp_init)
    mp.setattr(ptrainer_mod.Trainer, "mlp_init", port_mlp_init)
    mp.setattr(jax.random, "choice", choice)
    db = make_db(str(workdir), 2 if "--no-single_inst" in extra else 1)
    try:
        jt, ckpt = SQ.jax_trainer(db, str(workdir), 0, 1, RES, ITERS, FRAMES, FLAGS + extra)
        jax.effects_barrier()
        pt = CP.build_trainer(db, str(workdir), 0, 1, RES, ITERS, FRAMES, "cpu", "skel-quad",
                              FLAGS + extra)
    finally:
        mp.undo()
    return jt, ckpt, pt, captured


def check_init(captured):
    """Every leaf of the port's init equals flax's: uniform and constant
    leaves bit for bit, the normal ones (instance codes) within 2 ulp.
    Returns the number of leaves that are not bit for bit equal."""
    from lab4d_tpu_torch import bridge

    want = dict(bridge._flatten(captured["jax_init"]))
    got = dict(bridge._flatten(captured["port_init"]))
    assert set(got) == set(want)
    inexact = 0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        d = int(ulps(w, g).max()) if w.size else 0
        tol = 2 if key[-1] == "embedding" else 0
        assert d <= tol, (key, d)
        inexact += d > 0
    return inexact


def check_prior_fit(captured, categories, num_points=256):
    """The geometry fit's eikonal rays (after model.init's one draw per
    field) equal jax_streams.prior_fit_eikonal's, step by step, over the
    JAX fit's 500 steps."""
    from lab4d_tpu_torch.engine import jax_streams

    fit = captured["choice"][len(categories):]
    steps = len(fit) // len(categories)
    assert steps == 500 and len(fit) == steps * len(categories), len(fit)
    for s in range(steps):
        for i, cate in enumerate(categories):
            np.testing.assert_array_equal(
                jax_streams.prior_fit_eikonal(s, cate, num_points),
                fit[s * len(categories) + i], err_msg=f"step {s} {cate}")


def _grouped(calls):
    out = {}
    for name, v in calls:
        v = np.asarray(v)
        out.setdefault((name, v.shape), []).append(v)
    return out


def check_steps(jt, ckpt, pt, tmp_path):
    """Two training steps of each trainer: the draws equal (ints exactly,
    floats within 1 ulp), the first step's loss terms within 1e-3."""
    from lab4d_tpu_torch.nnutils import embedding as emb
    from tests.test_torch_families import jax_draw_order

    SQ.load_init(pt, ckpt)
    record = []
    try:
        SQ.jax_rounds(jt, 0, 1, record)
    finally:
        jt.trainloader.stop()
    swaps, host = [], []
    mp = pytest.MonkeyPatch()
    take, step_draws = emb.SwapDraws.take, type(pt.model).step_draws

    def recording_take(self, inst_id, num_inst, scope=()):
        out = take(self, inst_id, num_inst, scope)
        swaps.append(tuple(t.cpu().numpy() for t in out))
        return out

    def recording_step_draws(self, batch, step, given=None):
        out = step_draws(self, batch, step, given)
        host.append({c: {k: v.cpu().numpy() for k, v in d.items()}
                     for c, d in out.items() if isinstance(d, dict)})
        return out

    mp.setattr(emb.SwapDraws, "take", recording_take)
    mp.setattr(type(pt.model), "step_draws", recording_step_draws)
    try:
        CP.train_rounds(pt, 0, 1)
    finally:
        mp.undo()
        pt.close()
    assert len(record) == len(host) == ITERS
    per_step = len(swaps) // ITERS
    for i in range(ITERS):
        draws = {c: dict(d) for c, d in host[i].items()}
        if per_step:
            first = next(iter(draws))
            draws[first]["swap"] = swaps[i * per_step:(i + 1) * per_step]
        want, got = _grouped(record[i]), _grouped(jax_draw_order(draws))
        assert set(want) == set(got), (sorted(want), sorted(got))
        for key in want:
            assert len(want[key]) == len(got[key]), key
            for w, g in zip(want[key], got[key]):
                if w.dtype.kind == "f":
                    assert int(ulps(w, g).max()) <= 1, key
                else:
                    np.testing.assert_array_equal(w, g, err_msg=str(key))
    want = SQ._first_step_losses(os.path.join(str(tmp_path), "logdir_jax", f"{CP.SEQNAME}-jax0"))
    got = SQ._first_step_losses(os.path.join(str(tmp_path), "logdir", f"{CP.SEQNAME}-seed0"))
    terms = [k for k in want if k not in ("step", "grad_norm", "total")]
    for k in terms:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-9, err_msg=k)
    return terms


def run_case(tmp_path, extra, categories):
    jt, ckpt, pt, captured = build_pair(tmp_path, tuple(extra))
    check_init(captured)
    check_prior_fit(captured, categories)
    terms = check_steps(jt, ckpt, pt, tmp_path)
    print(json.dumps({"terms": terms}))
    return terms
