"""The port's depth U-Net trainer (lab4d_tpu_torch/scripts/
train_depth_unet.py) against scripts/train_depth_unet.py on the CPU: the
frames and depths from seed 0 bit for bit, flax's init (the output bias
at 3.0), both mains at 64^2 (batch 2, 3 steps) from the same init, and the
optimizer chain on the net's parameters against optax (the checks of
test_torch_train_optim.py)."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import lab4d_tpu_torch.scripts.train_depth_unet as port
from tests.test_torch_train_optim import check_batches, check_chain, check_init, check_mains

RES = 64


@functools.lru_cache(maxsize=1)
def _flax_params():
    from preprocess.backends.depth_unet import DepthUNet

    return DepthUNet().init(jax.random.PRNGKey(0), jnp.zeros((RES, RES, 3), jnp.float32))["params"]


def test_make_batch_bitwise():
    import scripts.train_depth_unet as ref

    check_batches(lambda r: ref.make_batch(r, 3, RES), lambda r: port.make_batch(r, 3, RES))


def test_flax_init():
    check_init(_flax_params(), port.make_model(torch.Generator().manual_seed(0)))


def test_main_against_jax(tmp_path):
    import scripts.train_depth_unet as ref

    jax_log, port_log = check_mains(ref.main, port.main, _flax_params(),
                                    port.make_model(torch.Generator().manual_seed(1)), tmp_path,
                                    peak=port.PEAK_LR, res=RES, batch=2)
    assert "held-out siLog-RMSE: unet=" in port_log


@pytest.mark.parametrize("steps", [3, 20])
def test_chain_matches_optax(steps):
    check_chain(port.make_model(torch.Generator().manual_seed(0)), port.PEAK_LR, steps,
                n_updates=min(steps, 6))
