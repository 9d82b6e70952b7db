"""JAX's random streams in numpy: the threefry2x32 counter-based generator
and the `jax.random` functions the JAX package calls, bit for bit.

The JAX package draws every random number from `jax.random` keys (its
initializers, the prior fits' and the training step's regularizer points,
the eikonal rays, the instance-code swaps). This module reproduces JAX
0.9's draws with `jax_threefry_partitionable` on (its default), so that
the port starts from the same parameters and takes the same draws without
importing JAX:

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
- `normal` and `truncated_normal` go through XLA's float32 erfinv (Giles'
  polynomial on -log1p(-x^2)) and its CPU log1p / log (Cephes), with the
  fused multiply-adds XLA's CPU backend contracts them to. Bits, ints,
  permutations and uniforms are exact by construction; these two matched
  JAX 0.9's CPU draws on every sample tested, and are held to 2 ulp.

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


# ------------------------------------------------------- normal draws (erfinv)

def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the product of two float32s is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _horner32(x, coefs):
    p = np.full_like(x, np.float32(coefs[0]))
    for c in coefs[1:]:
        p = _fma32(p, x, np.float32(c))
    return p


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def log32(x) -> np.ndarray:
    """XLA's CPU float32 log of x > 0: Cephes' degree-8 polynomial on the
    mantissa in [sqrt(1/2), sqrt 2) (Eigen's plog), contracted to fused
    multiply-adds as LLVM contracts it."""
    f = np.float32
    t = np.maximum(np.array(0x00800000, np.int32).view(f), np.asarray(x, f))
    bits = t.view(np.int32)
    e = (f(1) + ((bits >> 23) - 0x7F).astype(f)).astype(f)
    t = ((bits & ~0x7F800000) | np.array(0.5, f).view(np.int32)).view(f)
    mask = t < f(0.707106781186547524)
    tmp = np.where(mask, t, f(0))
    t = (t - f(1)).astype(f)
    e = (e - np.where(mask, f(1), f(0))).astype(f)
    t = (t + tmp).astype(f)
    x2 = (t * t).astype(f)
    x3 = (x2 * t).astype(f)
    p = [f(v) for v in _LOG_P]
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(_fma32(y, x3, y1), x3, y2), x3, (f(-2.12194440e-4) * e).astype(f))
    t = _fma32(f(-0.5), x2, t)
    t = (t + y).astype(f)
    return _fma32(f(0.693359375), e, t)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p32(x) -> np.ndarray:
    """XLA's float32 log1p: Cephes' rational approximation where |x| <
    sqrt 2 - 1, else log32(1 + x)."""
    f = np.float32
    x = np.asarray(x, f)
    x2 = (x * x).astype(f)
    small = (_horner32(x, _LOG1P_NUM) / _horner32(x, _LOG1P_DEN)).astype(f)
    small = ((x * x2).astype(f) * small).astype(f)
    small = (x + _fma32(f(-0.5), x2, small)).astype(f)
    with np.errstate(divide="ignore", invalid="ignore"):
        large = log32((x + f(1)).astype(f))
    return np.where(np.abs(x) < f(0.41421356237309504880), small, large).astype(f)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x) -> np.ndarray:
    """XLA's float32 inverse error function (Giles' single-precision
    polynomial), with its edge rule erfinv(+-1) = +-inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -log1p32(-(x * x).astype(np.float32))
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        coef = [np.where(small, np.float32(s), np.float32(g)).astype(np.float32)
                for s, g in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
        p = coef[0]
        for c in coef[1:]:
            p = _fma32(p, w, c)
        out = (p * x).astype(np.float32)
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out).astype(
            np.float32)


SQRT2 = np.float32(np.sqrt(2))


def normal(key, shape: Sequence[int] = ()) -> np.ndarray:
    """jax.random.normal in float32: sqrt(2) erfinv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return (SQRT2 * erfinv32(u)).astype(np.float32)


# erf(-+2 / sqrt 2) in XLA's float32 erf: the bounds of the uniform draw of
# truncated_normal(-2, 2), the one the lecun_normal initializers make
_ERF_TRUNC2 = (np.float32(-0.9544997), np.float32(0.9544997))


def truncated_normal(key, lower: float, upper: float, shape: Sequence[int] = ()) -> np.ndarray:
    """jax.random.truncated_normal(key, -2, 2, shape) in float32: sqrt(2)
    erfinv(u), u uniform between erf(-+2 / sqrt 2), clipped to the open
    interval (-2, 2). Other bounds are not replicated."""
    if (lower, upper) != (-2, 2):
        raise ValueError(f"truncated_normal is replicated for bounds (-2, 2), not {(lower, upper)}")
    u = uniform(key, shape, *_ERF_TRUNC2)
    out = (SQRT2 * erfinv32(u)).astype(np.float32)
    lo = np.nextafter(np.float32(lower), np.float32(np.inf))
    hi = np.nextafter(np.float32(upper), np.float32(-np.inf))
    return np.clip(out, lo, hi).astype(np.float32)
