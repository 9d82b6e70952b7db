"""flax.linen's key derivation and the initializers the JAX package uses,
on top of utils/jax_random.py (numpy, no JAX).

A flax scope derives the key of its n-th `make_rng(name)` call (n from 1,
counted per scope and per rng name) from the root key of that name:
`fold_in(root, h)`, h the first 4 bytes (big-endian) of the SHA-1 of the
scope's path names (utf-8) followed by n (big-endian, fewest bytes), as
flax 0.12's `_fold_in_static` hashes them (no separator bytes: the
`flax_fix_rng_separator` flag is off). A parameter's key is its scope's
next `make_rng("params")`, so the k-th parameter a scope creates takes
count k; so do the training step's `make_rng("aux")` / `make_rng("swap")`
draws, counted apart from the parameters.

The initializers (each returns float32 numpy):
- `torch_linear_uniform`: the JAX package's torch_linear_init, kernel and
  bias ~ U(+-1/sqrt(fan_in)) (lab4d_tpu/nnutils/linear.py);
- `lecun_normal`: nn.Dense / nn.Conv's kernel init, a normal truncated at
  +-2 scaled by sqrt(1/fan_in) / 0.8796..., fan_in the product of every
  axis but the last;
- `embed_normal`: nn.Embed's variance_scaling(1, "fan_in", "normal",
  out_axis=0), normal / sqrt(features).
Zero and constant leaves draw nothing, but still take their count.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence

import numpy as np

from lab4d_tpu_torch.utils import jax_random as jr


def scope_hash(path: Sequence[str], count: int) -> int:
    """The uint32 that flax folds into a root key for the count-th rng
    call of the scope at `path`."""
    m = hashlib.sha1()
    for x in tuple(path) + (int(count),):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def make_rng(root, path: Sequence[str], count: int) -> np.ndarray:
    """The key of the count-th (from 1) make_rng call of one rng name in
    the scope at `path`, under that name's root key."""
    return jr.fold_in(root, scope_hash(path, count))


def torch_linear_uniform(key, shape: Sequence[int], fan_in: int) -> np.ndarray:
    bound = 1.0 / np.sqrt(max(int(fan_in), 1))
    return jr.uniform(key, tuple(shape), -bound, bound)


_TRUNC_STD = np.float32(0.87962566103423978)


def lecun_normal(key, shape: Sequence[int]) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    fan_in = math.prod(shape[:-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNC_STD
    return (jr.truncated_normal(key, -2, 2, shape) * np.float32(stddev)).astype(np.float32)


def embed_normal(key, shape: Sequence[int]) -> np.ndarray:
    """nn.Embed's table as the JAX trainer's jitted init computes it: XLA
    folds normal's sqrt(2) and the scale into one constant factor."""
    shape = tuple(int(s) for s in shape)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = jr.uniform(key, shape, lo, np.float32(1.0))
    factor = np.float32(jr.SQRT2 * np.sqrt(np.float32(1.0 / shape[-1])))
    return (jr.erfinv32(u) * factor).astype(np.float32)
