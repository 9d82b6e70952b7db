"""lab4d_tpu_torch/utils/jax_random.py and utils/flax_rng.py against
jax.random (JAX 0.9, jax_threefry_partitionable on) and flax's key
derivation, over seeds and shapes drawn by hypothesis.

Exact: keys (PRNGKey, fold_in, split), random bits, randint, uniform
(bounded too), permutation and choice(replace=False). Within 2 ulp: normal
and truncated_normal (through XLA's float32 erfinv and its CPU log1p /
log), which matched bit for bit on every sample drawn here; the tests
count and print the samples that are not bit for bit equal.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lab4d_tpu_torch.utils import flax_rng
from lab4d_tpu_torch.utils import jax_random as jr

SEEDS = st.integers(0, 2**31 - 1)
SHAPES = st.lists(st.integers(1, 37), min_size=1, max_size=3).map(tuple)
FAST = settings(max_examples=25, deadline=None)


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


@FAST
@given(seed=SEEDS, data=st.integers(0, 2**32 - 1), num=st.integers(1, 9))
def test_keys_exact(seed, data, num):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), jr.PRNGKey(seed))
    np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, data)),
                                  jr.fold_in(jr.PRNGKey(seed), data))
    np.testing.assert_array_equal(np.asarray(jax.random.split(key, num)),
                                  jr.split(jr.PRNGKey(seed), num))


@FAST
@given(seed=SEEDS, shape=SHAPES)
def test_bits_exact(seed, shape):
    np.testing.assert_array_equal(np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape)),
                                  jr.random_bits(jr.PRNGKey(seed), shape))


@FAST
@given(seed=SEEDS, shape=SHAPES, lo=st.floats(-3, 3, width=32),
       span=st.floats(2.0**-10, 5, width=32))
def test_uniform_exact(seed, shape, lo, span):
    key, k = jax.random.PRNGKey(seed), jr.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, shape)), jr.uniform(k, shape))
    hi = np.float32(lo) + np.float32(span)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
    np.testing.assert_array_equal(want, jr.uniform(k, shape, lo, hi))


@FAST
@given(seed=SEEDS, shape=SHAPES, lo=st.integers(-1000, 1000), span=st.integers(-3, 2**31 - 1001))
def test_randint_exact(seed, shape, lo, span):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, lo + span))
    np.testing.assert_array_equal(want, jr.randint(jr.PRNGKey(seed), shape, lo, lo + span))


@settings(max_examples=15, deadline=None)
@given(seed=SEEDS, n=st.integers(1, 5000), frac=st.floats(0.0, 1.0))
def test_permutation_and_choice_exact(seed, n, frac):
    """Up to 1,625 elements one sort round, above it two (5,000 is past the
    flagship step's 4,096 rays)."""
    size = max(1, int(n * frac))
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(key, n)),
                                  jr.permutation(jr.PRNGKey(seed), n))
    np.testing.assert_array_equal(np.asarray(jax.random.choice(key, n, (size,), replace=False)),
                                  jr.choice(jr.PRNGKey(seed), n, size))


@pytest.mark.parametrize("n", [4096, 70_000])
def test_choice_flagship_sizes_exact(n):
    """The eikonal draw's sizes: 4,096 rays of a flagship step, and a batch
    past 2^16 (still two rounds)."""
    for seed in (0, 42):
        want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (n // 16,),
                                            replace=False))
        np.testing.assert_array_equal(want, jr.choice(jr.PRNGKey(seed), n, n // 16))


def _within_2ulp(want, got, name):
    d = ulps(want, got)
    assert d.max() <= 2, (name, int(d.max()))
    print(f"{name}: {int((d > 0).sum())} of {d.size} samples not bit for bit equal")
    return int((d > 0).sum())


@FAST
@given(seed=SEEDS, shape=SHAPES)
def test_normal_within_2ulp(seed, shape):
    _within_2ulp(jax.random.normal(jax.random.PRNGKey(seed), shape),
                 jr.normal(jr.PRNGKey(seed), shape), "normal")


@FAST
@given(seed=SEEDS, shape=SHAPES)
def test_truncated_normal_within_2ulp(seed, shape):
    _within_2ulp(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2, 2, shape),
                 jr.truncated_normal(jr.PRNGKey(seed), -2, 2, shape), "truncated_normal")


@pytest.mark.parametrize("name", ["normal", "truncated_normal"])
def test_normal_draws_large_sample(name):
    """200,000 samples of each through every branch of erfinv and log1p:
    within 2 ulp (bit for bit when measured)."""
    key = jax.random.PRNGKey(3)
    if name == "normal":
        want, got = jax.random.normal(key, (200_000,)), jr.normal(jr.PRNGKey(3), (200_000,))
    else:
        want = jax.random.truncated_normal(key, -2, 2, (200_000,))
        got = jr.truncated_normal(jr.PRNGKey(3), -2, 2, (200_000,))
    _within_2ulp(want, got, name)


def test_log_and_log1p_match_xla():
    """XLA's CPU float32 log over [2^-10, 2^10) and log1p over (-1, 1)."""
    lo, hi = (np.array(v, np.float32).view(np.int32) for v in (2.0**-10, 2.0**10))
    x = np.arange(lo, hi, 997, dtype=np.int32).view(np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.log)(x)), jr.log32(x))
    u = jr.uniform(jr.PRNGKey(1), (100_000,), -1.0, 1.0)
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.log1p)(u)), jr.log1p32(u))


def test_truncated_normal_other_bounds_refused():
    with pytest.raises(ValueError):
        jr.truncated_normal(jr.PRNGKey(0), -1, 1, (3,))


# ------------------------------------------------------------ flax's keys


@FAST
@given(path=st.lists(st.sampled_from(["fields", "field_params_fg", "basefield", "Conv_0",
                                      "inst_embedding", "ü"]), max_size=4),
       count=st.integers(1, 300))
def test_scope_hash_is_flax(path, count):
    """flax 0.12's _fold_in_static: SHA-1 of the path names and the count,
    the first 4 bytes big-endian, no separators."""
    from flax.core.scope import _fold_in_static

    m = hashlib.sha1()
    for x in path:
        m.update(x.encode())
    m.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    assert flax_rng.scope_hash(path, count) == int.from_bytes(m.digest()[:4], "big")
    want = _fold_in_static(jax.random.PRNGKey(5), tuple(path) + (count,))
    np.testing.assert_array_equal(np.asarray(want),
                                  flax_rng.make_rng(jr.PRNGKey(5), path, count))


def test_make_rng_counts_per_scope():
    """A module's make_rng("aux") calls: the count runs per scope and per
    rng name, as flax's Scope.rng_counters do."""
    import flax.linen as fnn

    class Leaf(fnn.Module):
        @fnn.compact
        def __call__(self):
            return jnp.stack([self.make_rng("aux"), self.make_rng("aux")])

    class Top(fnn.Module):
        @fnn.compact
        def __call__(self):
            a = self.make_rng("aux")
            return a, Leaf(name="leaf")(), self.make_rng("aux")

    a, leaf, b = Top().apply({}, rngs={"aux": jax.random.PRNGKey(9)})
    root = jr.PRNGKey(9)
    np.testing.assert_array_equal(np.asarray(a), flax_rng.make_rng(root, (), 1))
    np.testing.assert_array_equal(np.asarray(b), flax_rng.make_rng(root, (), 2))
    for i in range(2):
        np.testing.assert_array_equal(np.asarray(leaf[i]),
                                      flax_rng.make_rng(root, ("leaf",), i + 1))


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (128, 6), (1, 1, 32, 1)])
def test_lecun_normal_within_2ulp(shape):
    import flax.linen as fnn

    want = fnn.initializers.lecun_normal()(jax.random.PRNGKey(4), shape)
    _within_2ulp(want, flax_rng.lecun_normal(jr.PRNGKey(4), shape), "lecun_normal")


@pytest.mark.parametrize("shape", [(1, 32), (2, 256), (300, 16)])
def test_embed_normal_within_2ulp(shape):
    """nn.Embed's table under jit (the JAX trainer jits its init)."""
    import flax.linen as fnn

    init = jax.jit(fnn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0),
                   static_argnums=1)
    _within_2ulp(init(jax.random.PRNGKey(6), shape),
                 flax_rng.embed_normal(jr.PRNGKey(6), shape), "embed_normal")


@pytest.mark.parametrize("fan_in", [1, 7, 128, 519])
def test_torch_linear_uniform_exact(fan_in):
    from lab4d_tpu.nnutils.linear import torch_linear_init

    want = torch_linear_init(fan_in)(jax.random.PRNGKey(8), (fan_in, 5))
    np.testing.assert_array_equal(
        np.asarray(want), flax_rng.torch_linear_uniform(jr.PRNGKey(8), (fan_in, 5), fan_in))
