"""JAX's random streams in numpy: the threefry2x32 counter-based generator
and the `jax.random` functions the JAX package calls, bit for bit.

The JAX package draws every random number of a training step from
`jax.random` keys (the regularizers' points, the eikonal rays, the
instance-code swaps). This module reproduces JAX
0.9's draws with `jax_threefry_partitionable` on (its default), so that
the port takes the same draws without importing JAX:

- a key is a (2,) uint32 array; `PRNGKey(seed)` is [seed >> 32, seed & ~0];
- `fold_in(key, d)` hashes the counter pair (0, d) under `key`;
- `split(key, n)` hashes the counter pairs (0, i), i < n;
- the 32 random bits of a shape are `bits1 ^ bits2` of threefry over the
  shape's flat iota (hi, lo words of a 64-bit counter);
- `uniform` sets the 23 mantissa bits of 1.0 from the top of those bits;
  `randint` takes two words per value and folds them into the span as
  `lax`'s uint32 arithmetic does (wrapping); `permutation` / `choice
  (replace=False)` sort by fresh random keys, ceil(3 ln n / ln(2^32 - 1))
  rounds of a stable sort;
- bits, ints, permutations and uniforms are exact by construction
  (`uniform`'s scale and shift one fused multiply-add, as XLA's CPU
  backend contracts it).

Every function takes and returns numpy arrays and runs on the host.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def threefry2x32(key, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2),
    uint32 arrays of one shape, under `key`."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = np.array(x1, _U32, copy=True), np.array(x2, _U32, copy=True)
    tmp = np.empty_like(b)
    with np.errstate(over="ignore"):
        a += ks[0]
        b += ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                a += b
                np.left_shift(b, _U32(r), out=tmp)  # b = rotl(b, r) ^ a, in place
                b >>= _U32(32 - r)
                b |= tmp
                b ^= a
            a += ks[(i + 1) % 3]
            b += ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) of a non-negative seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data), data taken as uint32."""
    a, b = threefry2x32(key, np.zeros(1, _U32), np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def _iota_2x32(shape) -> Tuple[np.ndarray, np.ndarray]:
    n = math.prod(shape)
    iota = np.arange(n, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(_U32).reshape(shape)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(_U32).reshape(shape)
    return hi, lo


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    hi, lo = _iota_2x32((num,))
    b1, b2 = threefry2x32(key, hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of `shape` (jax.random.bits, uint32)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(shape)
    b1, b2 = threefry2x32(key, hi, lo)
    return b1 ^ b2


def uniform(key, shape: Sequence[int] = (), minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform in float32 over [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA's CPU backend contracts floats * span + lo to one fused multiply-add
    span = np.full_like(floats, hi - lo)
    return np.maximum(lo, _fma32(floats, span, np.full_like(floats, lo))).astype(np.float32)


def randint(key, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) as int32."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(1 if maxval <= minval else (int(maxval) - int(minval)) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = (higher % span) * multiplier + lower % span
        offset = offset % span
        return (np.int32(minval) + offset.view(np.int32)).astype(np.int32)


def permutation(key, n: int) -> np.ndarray:
    """jax.random.permutation(key, n): arange(n) shuffled by rounds of a
    stable sort on fresh 32-bit keys (int32)."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def choice(key, n: int, size: int) -> np.ndarray:
    """jax.random.choice(key, n, (size,), replace=False)."""
    if size > n:
        raise ValueError(f"cannot take {size} of {n} without replacement")
    return permutation(key, n)[:size]


def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the product of two float32s is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)
