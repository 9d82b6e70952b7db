"""Weights and checkpoints from the JAX package.

- `params_from_flax` maps a flax param tree (nested dicts of numpy
  arrays, as `DVRModel.init` makes and `Trainer.save_checkpoint` writes
  under "model") to a torch state_dict of the port's DVRModel, and
  `params_to_flax` maps it back. Flax dense kernels are stored (in, out);
  torch.nn.Linear weights are (out, in).
- `load_flax_checkpoint` reads a `ckpt_*.flax` file with a small msgpack
  decoder, so a model fitted by the JAX trainer loads where neither flax
  nor msgpack is installed.

Name mapping, flax -> torch:
  module list entry  `head_0`          -> `head.0`
  field dict entry   `field_params_fg` -> `field_params.fg`
  BaseMLP layer      `linear_3`, `bias_3` -> `linear_3.weight` (transposed), `linear_3.bias`
                     `linear_final`, `bias_final` -> `linear_final.weight`, `linear_final.bias`
  dense layer        `kernel`          -> `weight` (transposed)
  embedding table    `mapping/embedding` -> `mapping.weight`
  anything else keeps its name.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, Tuple

import numpy as np
import torch

_LIST_ENTRY = re.compile(r"^(.*)_(\d+)$")
_FIELD_ENTRY = re.compile(r"^field_params_(\w+)$")
_MLP_PARAM = re.compile(r"^(linear|bias)_(\d+|final)$")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_to_torch(name: str) -> str:
    m = _FIELD_ENTRY.match(name)
    if m:
        return f"field_params.{m.group(1)}"
    m = _LIST_ENTRY.match(name)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    return name


def flax_to_torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(torch state_dict key, whether the value is transposed)."""
    *mods, leaf = path
    mods = [_module_to_torch(m) for m in mods]
    m = _MLP_PARAM.match(leaf)
    if m:
        kind, idx = m.groups()
        layer = f"linear_{idx}"
        return ".".join(mods + [layer, "weight" if kind == "linear" else "bias"]), kind == "linear"
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), True
    if leaf == "embedding":
        return ".".join(mods + ["weight"]), False
    return ".".join(mods + [leaf]), False


def torch_to_flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """Inverse of flax_to_torch_key."""
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


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax param tree -> torch state_dict (float32 tensors on the CPU)."""
    state = {}
    for path, value in _flatten(tree):
        key, transpose = flax_to_torch_key(path)
        arr = np.array(value, dtype=np.float32)  # a writable copy
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr.T if transpose else arr))
    return state


def params_to_flax(state_dict) -> Dict:
    """Torch state_dict -> flax param tree of numpy arrays."""
    tree: Dict = {}
    for key, value in state_dict.items():
        path, transpose = torch_to_flax_path(key)
        arr = value.detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
    return tree


# ------------------------------------------------------------------ msgpack

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """Decoder for the msgpack subset flax writes: maps, arrays, strings,
    binaries, numbers, nil/bools, and its ndarray ext types."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            return self.ext(n) if kind == "ext" else getattr(self, kind)(n)
        numbers = {
            0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
        }
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n):
        return {self.value(): self.value() for _ in range(n)}

    def array(self, n):
        return [self.value() for _ in range(n)]

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n):
        return bytes(self.take(n))

    def ext(self, n):
        code = self.unpack("b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes):
    """Decode bytes written by flax.serialization.msgpack_serialize."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_flax_checkpoint(path: str):
    """Read a checkpoint written by the JAX trainer: a dict with "model"
    (flax params), "geo_state", "proxy", "manifest" and, when present,
    "opt_state"; the manifest keys are also copied to the top level."""
    with open(path, "rb") as f:
        ckpt = msgpack_restore(f.read())
    ckpt.update(ckpt.get("manifest", {}))
    return ckpt
