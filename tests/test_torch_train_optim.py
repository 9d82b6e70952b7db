"""The optimizer the port's preprocessing-net trainers share
(lab4d_tpu_torch/scripts/optim.py) against optax's chain in
scripts/train_*.py, and the checks each trainer's test file
(test_torch_train_<net>.py) runs against its JAX trainer:

- `check_batches`: make_batch from one seed, bit for bit;
- `check_init`: make_model(0) (flax_init_) leaf by leaf against
  Model().init(PRNGKey(0)): the same names and shapes, the biases equal,
  the lecun_normal kernels within 2 ulp (they matched bit for bit);
- `check_mains`: both mains at a small size, the port started from the
  flax init; the printed parameter count and step-0 loss equal as
  printed, the written files within the sign-flip bound (Adam's first
  updates are ~lr * sign(g), so a gradient within rounding of zero may
  move the two the other way: |d| <= 2 * sum(lr) + 1e-6) with >= 99.9%
  of the elements within 1e-5, and flax reads the port's file with the
  JAX net as template;
- `check_chain`: Chain on identical gradients against optax to 1e-6 at
  steps 3 (no warmup: update 0 at the peak) and 20 (a warmup of 2).
"""

import contextlib
import io
import re

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from lab4d_tpu_torch.bridge import msgpack_restore
from lab4d_tpu_torch.preprocess.backends.layers import flax_to_state_dict, state_dict_to_flax
from lab4d_tpu_torch.scripts.optim import Chain, warmup_cosine

# one torch thread per test worker: the suite runs six workers beside JAX's
# compiles, and torch's default pool of one thread per core stalls them
torch.set_num_threads(1)

CHAIN_TOL = 1e-6
INIT_ULPS = 2
CLOSE = 1e-5
CLOSE_SHARE = 0.999


def optax_chain(peak, steps):
    sched = optax.warmup_cosine_decay_schedule(0.0, peak, min(100, steps // 10), steps)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-5))


def ulps(a, b):
    """Units in the last place between two float32 arrays, elementwise."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


# ------------------------------------------------------------------ checks


def check_batches(jax_batch, port_batch):
    a, b = jax_batch(np.random.default_rng(0)), port_batch(np.random.default_rng(0))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def check_init(jax_params, port_model):
    want = dict(_leaves(_np_tree(jax_params)))
    got = dict(_leaves(state_dict_to_flax(port_model)))
    assert list(got) == sorted(want), (list(got), sorted(want))
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if name.endswith("bias"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:  # lecun_normal from the layer's flax scope key (utils/flax_rng.py)
            assert int(ulps(w, g).max()) <= INIT_ULPS, name


def _run(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def _loss_text(stdout, step):
    m = re.search(rf"^step {step}: loss=(\S+)", stdout, re.M)
    assert m, stdout
    return m.group(1)


def check_mains(jax_main, port_main, jax_params, port_model, out_dir, steps=3, peak=3e-4,
                **kw):
    """Both mains from the same init; returns both printed outputs."""
    port_model.load_state_dict(flax_to_state_dict(_np_tree(jax_params)))
    jax_out, port_out = out_dir / "jax.msgpack", out_dir / "port.msgpack"
    _, jax_log = _run(lambda: jax_main(steps=steps, out_path=str(jax_out), **kw))
    _, port_log = _run(lambda: port_main(steps=steps, out_path=str(port_out), model=port_model,
                                         device="cpu", **kw))
    n_params = re.search(r"^params: (\d+)", jax_log, re.M).group(1)
    assert f"params: {n_params}" in port_log
    assert _loss_text(port_log, 0) == _loss_text(jax_log, 0), (jax_log, port_log)
    assert "wrote " in port_log and "held-out" in port_log

    want = dict(_leaves(msgpack_restore(jax_out.read_bytes())))
    got = dict(_leaves(msgpack_restore(port_out.read_bytes())))
    assert list(got) == list(want)
    sched = warmup_cosine(peak, steps)
    bound = 2 * sum(sched(k) for k in range(steps)) + 1e-6
    n_close = n_all = 0
    for name, w in want.items():
        d = np.abs(got[name].astype(np.float64) - w)
        assert d.max() <= bound, (name, d.max(), bound)
        n_close += int((d <= CLOSE).sum())
        n_all += d.size
    assert n_close >= CLOSE_SHARE * n_all, (n_close, n_all)
    # flax reads the port's file with the JAX net's template
    restored = serialization.from_bytes(jax_params, port_out.read_bytes())
    for (name, a), (_, b) in zip(_leaves(_np_tree(restored)), _leaves(got)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    return jax_log, port_log


def _apply(tx, grads, opt_state, params):
    upd, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, upd), opt_state


def check_chain(port_model, peak, steps, n_updates=None, seed=0):
    """Chain and optax's chain on the same gradients (seeded numpy, some
    above the clip norm) from the same parameters."""
    n_updates = n_updates or steps
    params = state_dict_to_flax(port_model)
    tx = optax_chain(peak, steps)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, o, p: _apply(tx, g, o, p))
    chain = Chain(port_model.parameters(), peak, steps)
    named = dict(port_model.named_parameters())
    rng = np.random.default_rng(seed)
    for k in range(n_updates):
        scale = 10.0 ** rng.uniform(-5, 0)  # the global norm on either side of 1
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        params = _np_tree(params)
        for name, g in flax_to_state_dict(grads).items():
            named[name].grad = g.clone()
        chain.step()
        got = dict(_leaves(state_dict_to_flax(port_model)))
        for name, want in _leaves(params):
            np.testing.assert_allclose(got[name], want, rtol=0, atol=CHAIN_TOL,
                                       err_msg=f"update {k}: {name}")


# ------------------------------------------------------------------ the optimizer


@pytest.mark.parametrize("steps", [1, 3, 9, 10, 20, 150, 1200, 1500])
def test_schedule_matches_optax(steps):
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, min(100, steps // 10), steps)
    mine = warmup_cosine(3e-4, steps)
    for k in list(range(min(steps + 3, 130))) + [steps - 1, steps, steps + 5]:
        assert abs(mine(k) - float(sched(k))) <= 1e-6 * 3e-4, (k, mine(k), float(sched(k)))


def test_first_updates_without_warmup():
    """steps < 10: no warmup, update 0 at the peak (3 steps: 3e-4, 2.25e-4,
    7.5e-5); steps >= 10: update 0 at lr 0."""
    s = warmup_cosine(3e-4, 3)
    np.testing.assert_allclose([s(0), s(1), s(2)], [3e-4, 2.25e-4, 7.5e-5], rtol=1e-12)
    assert warmup_cosine(3e-4, 20)(0) == 0.0


@pytest.mark.parametrize("norm", [0.5, 0.999999, 1.0, 3.0])
def test_clip_matches_optax(norm):
    rng = np.random.default_rng(1)
    g = [rng.standard_normal(s).astype(np.float32) for s in ((7, 5), (11,))]
    total = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g))
    g = [(x / total * norm).astype(np.float32) for x in g]
    want, _ = optax.clip_by_global_norm(1.0).update(g, optax.EmptyState())
    ps = [torch.nn.Parameter(torch.zeros(x.shape)) for x in g]
    for p, x in zip(ps, g):
        p.grad = torch.from_numpy(x.copy())
    Chain(ps, 3e-4, 3).clip()
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=0, atol=1e-7)


@pytest.mark.parametrize("steps", [3, 20])
def test_chain_matches_optax_small_net(steps):
    net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 2))
    torch.nn.init.normal_(net[0].weight, generator=torch.Generator().manual_seed(0))
    net = _Named(net)
    check_chain(net, 3e-4, steps)


class _Named(torch.nn.Module):
    """A small net with flax's names (Dense_0, Dense_1)."""

    def __init__(self, seq):
        super().__init__()
        self.Dense_0, self.Dense_1 = seq[0], seq[2]


def write_flax_inits(out_dir, key=0):
    """Each net's flax init (PRNGKey(key); the JAX trainers draw
    PRNGKey(0)) as <out_dir>/<weights name>.msgpack, for the port's
    trainers to start from (tools/train_nets_report.py --init)."""
    import os

    from preprocess.backends import depth_unet, feat_net, flow_raft, seg_unet, viewpoint_net

    os.makedirs(out_dir, exist_ok=True)
    nets = {"flow_raft": (flow_raft.RAFTLite(), 2, (128, 128, 3)),
            "seg_unet": (seg_unet.SegUNet(), 1, (128, 128, 4)),
            "depth_unet": (depth_unet.DepthUNet(), 1, (128, 128, 3)),
            "feat_net": (feat_net.FeatNet(), 1, (112, 112, 3)),
            "viewpoint_net": (viewpoint_net.ViewpointNet(), 1, (96, 96, 3))}
    for name, (model, n_in, shape) in nets.items():
        params = model.init(jax.random.PRNGKey(key), *[np.zeros(shape, np.float32)] * n_in)
        with open(os.path.join(out_dir, f"{name}.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(params["params"]))


if __name__ == "__main__":
    import sys

    write_flax_inits(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 0)
