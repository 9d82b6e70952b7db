"""The port's segmentation U-Net trainer (lab4d_tpu_torch/scripts/
train_seg_unet.py) against scripts/train_seg_unet.py on the CPU: the
samples from seed 0 bit for bit (both renderers, the corrupted previous
masks), flax's init, both mains at 64^2 (batch 2, 3 steps) from the same
init, and the optimizer chain on the net's parameters against optax (the
checks of test_torch_train_optim.py)."""

import functools

import jax
import jax.numpy as jnp
import pytest

import lab4d_tpu_torch.scripts.train_seg_unet as port
from tests.test_torch_train_optim import check_batches, check_chain, check_init, check_mains

RES = 64


@functools.lru_cache(maxsize=1)
def _flax_params():
    from preprocess.backends.seg_unet import SegUNet

    return SegUNet().init(jax.random.PRNGKey(0), jnp.zeros((RES, RES, 4), jnp.float32))["params"]


def test_make_batch_bitwise():
    import scripts.train_seg_unet as ref

    check_batches(lambda r: ref.make_batch(r, 8, RES), lambda r: port.make_batch(r, 8, RES))


def test_flax_init():
    check_init(_flax_params(), port.make_model(0))


def test_main_against_jax(tmp_path):
    import scripts.train_seg_unet as ref

    jax_log, port_log = check_mains(ref.main, port.main, _flax_params(),
                                    port.make_model(1), tmp_path,
                                    peak=port.PEAK_LR, res=RES, batch=2)
    assert "held-out IoU: unet=" in port_log


@pytest.mark.parametrize("steps", [3, 20])
def test_chain_matches_optax(steps):
    check_chain(port.make_model(0), port.PEAK_LR, steps,
                n_updates=min(steps, 6))
