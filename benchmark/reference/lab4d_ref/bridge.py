"""The flax scope of a torch parameter name of the program's DVRModel (the
JAX package's param tree, which the random streams hash: flax_rng.py):

  module list entry  `head.0`          -> `head_0`
  field dict entry   `field_params.fg` -> `field_params_fg`
  BaseMLP layer      `linear_3.weight`, `linear_3.bias` -> `linear_3`, `bias_3`
  dense layer        `weight`          -> `kernel`
  embedding table    `mapping.weight`  -> `mapping/embedding`
"""

from __future__ import annotations

import re
from typing import Tuple


def torch_to_flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """(flax path, whether the value is transposed) of a torch key."""
    parts = key.split(".")
    path = []
    i = 0
    while i < len(parts) - 1:
        p, nxt = parts[i], parts[i + 1]
        if p == "field_params":
            path.append(f"field_params_{nxt}")
            i += 2
        elif nxt.isdigit():
            path.append(f"{p}_{nxt}")
            i += 2
        else:
            path.append(p)
            i += 1
    if i == len(parts) - 1:
        path.append(parts[-1])
    *mods, leaf = path
    m = re.match(r"^linear_(\d+|final)$", mods[-1]) if mods else None
    if m and leaf in ("weight", "bias"):
        name = ("linear_" if leaf == "weight" else "bias_") + m.group(1)
        return tuple(mods[:-1] + [name]), leaf == "weight"
    if leaf == "weight":
        if mods[-1] == "mapping":
            return tuple(mods + ["embedding"]), False
        return tuple(mods + ["kernel"]), True
    return tuple(mods + [leaf]), False
