"""The port's descriptor-net trainer (lab4d_tpu_torch/scripts/
train_feat_net.py) against scripts/train_feat_net.py on the CPU: the pairs
and their matches from seed 0 bit for bit (the rejection loop included),
flax's init, both mains at the net's 112^2 (batch 2, 3 steps) from the
same init, and the optimizer chain on the net's parameters against optax
(the checks of test_torch_train_optim.py)."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import lab4d_tpu_torch.scripts.train_feat_net as port
from tests.test_torch_train_optim import check_batches, check_chain, check_init, check_mains


@functools.lru_cache(maxsize=1)
def _flax_params():
    from preprocess.backends.feat_net import FeatNet

    d = jnp.zeros((port.RES, port.RES, 3), jnp.float32)
    return FeatNet().init(jax.random.PRNGKey(0), d)["params"]


def test_make_batch_bitwise():
    import scripts.train_feat_net as ref

    check_batches(lambda r: ref.make_batch(r, 3), lambda r: port.make_batch(r, 3))


def test_flax_init():
    check_init(_flax_params(), port.make_model(torch.Generator().manual_seed(0)))


def test_main_against_jax(tmp_path):
    import scripts.train_feat_net as ref

    jax_log, port_log = check_mains(ref.main, port.main, _flax_params(),
                                    port.make_model(torch.Generator().manual_seed(1)), tmp_path,
                                    peak=port.PEAK_LR, batch=2)
    assert "held-out top-1 correspondence acc (K=192): net=" in port_log


@pytest.mark.parametrize("steps", [3, 20])
def test_chain_matches_optax(steps):
    check_chain(port.make_model(torch.Generator().manual_seed(0)), port.PEAK_LR, steps,
                n_updates=min(steps, 6))


def test_make_batch_rejections_bitwise(monkeypatch):
    """With K at 10,000 matches, pairs 1, 5 and 6 of seed 0 have too few
    valid pixels: both loops drop them after drawing them."""
    import scripts.train_feat_net as ref

    monkeypatch.setattr(ref, "K", 10000)
    monkeypatch.setattr(port, "K", 10000)
    check_batches(lambda r: ref.make_batch(r, 4), lambda r: port.make_batch(r, 4))
