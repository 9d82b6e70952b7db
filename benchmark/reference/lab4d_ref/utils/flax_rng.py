"""flax.linen's key derivation, on top of utils/jax_random.py (numpy, no
JAX).

A flax scope derives the key of its n-th `make_rng(name)` call (n from 1,
counted per scope and per rng name) from the root key of that name:
`fold_in(root, h)`, h the first 4 bytes (big-endian) of the SHA-1 of the
scope's path names (utf-8) followed by n (big-endian, fewest bytes), as
flax 0.12's `_fold_in_static` hashes them (no separator bytes: the
`flax_fix_rng_separator` flag is off). A parameter's key is its scope's
next `make_rng("params")`, so the k-th parameter a scope creates takes
count k; so do the training step's `make_rng("aux")` / `make_rng("swap")`
draws, counted apart from the parameters.

"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from benchmark.reference.lab4d_ref.utils import jax_random as jr


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
