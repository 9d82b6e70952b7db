"""The port's viewpoint-net trainer (lab4d_tpu_torch/scripts/
train_viewpoint.py) against scripts/train_viewpoint.py on the CPU: the
crops and rotations from seed 0 bit for bit (out-of-frame redraws
included), flax's init, both mains at the net's 96^2 (batch 2, 3 steps)
from the same init, and the optimizer chain on the net's parameters
against optax (the checks of test_torch_train_optim.py)."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import lab4d_tpu_torch.scripts.train_viewpoint as port
from tests.test_torch_train_optim import check_batches, check_chain, check_init, check_mains


@functools.lru_cache(maxsize=1)
def _flax_params():
    from preprocess.backends.viewpoint_net import ViewpointNet

    d = jnp.zeros((port.RES, port.RES, 3), jnp.float32)
    return ViewpointNet().init(jax.random.PRNGKey(0), d)["params"]


def test_make_batch_bitwise():
    import scripts.train_viewpoint as ref

    check_batches(lambda r: ref.make_batch(r, 6), lambda r: port.make_batch(r, 6))


def test_flax_init():
    check_init(_flax_params(), port.make_model(torch.Generator().manual_seed(0)))


def test_main_against_jax(tmp_path):
    import scripts.train_viewpoint as ref

    jax_log, port_log = check_mains(ref.main, port.main, _flax_params(),
                                    port.make_model(torch.Generator().manual_seed(1)), tmp_path,
                                    peak=port.PEAK_LR, batch=2)
    assert "held-out geodesic error: median=" in port_log


@pytest.mark.parametrize("steps", [3, 20])
def test_chain_matches_optax(steps):
    check_chain(port.make_model(torch.Generator().manual_seed(0)), port.PEAK_LR, steps,
                n_updates=min(steps, 6))


def _dropping(crop, drop):
    """crop_masked that finds no object at the calls numbered in `drop`."""
    calls = []

    def wrapped(rgb, mask):
        calls.append(1)
        return None if len(calls) in drop else crop(rgb, mask)
    return wrapped


def test_make_batch_redraws_bitwise(monkeypatch):
    """An object out of frame is drawn again from the same rng (the 2nd and
    3rd renders of the batch here), in both packages."""
    import preprocess.backends.viewpoint_net as jax_vp
    import scripts.train_viewpoint as ref

    import lab4d_tpu_torch.preprocess.backends.viewpoint_net as port_vp

    monkeypatch.setattr(jax_vp, "crop_masked", _dropping(jax_vp.crop_masked, {2, 3}))
    monkeypatch.setattr(port_vp, "crop_masked", _dropping(port_vp.crop_masked, {2, 3}))
    check_batches(lambda r: ref.make_batch(r, 3), lambda r: port.make_batch(r, 3))


def run_jax_from_key(key, out_dir):
    """JAX's scripts/train_viewpoint.py at its defaults with the init drawn
    from PRNGKey(key) in place of its PRNGKey(0), after writing flax's init
    from that key as <out_dir>/key<key>/<net>.msgpack for the port to start
    from (tools/train_nets_report.py --init DIR); returns JAX's held-out
    median geodesic error.

        JAX_PLATFORMS=cpu python -m tests.test_torch_train_viewpoint KEY OUT_DIR
    """
    import os

    import scripts.train_viewpoint as ref

    from tests.test_torch_train_optim import write_flax_inits

    write_flax_inits(os.path.join(out_dir, f"key{key}"), key)
    draw = jax.random.PRNGKey
    jax.random.PRNGKey = lambda seed: draw(key)  # the trainer's one draw is its init
    try:
        return ref.main(out_path=os.path.join(out_dir, f"jax_viewpoint_key{key}.msgpack"))
    finally:
        jax.random.PRNGKey = draw


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    run_jax_from_key(int(sys.argv[1]), sys.argv[2])
