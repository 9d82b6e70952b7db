"""Weights and checkpoints from the JAX package.

- `params_from_flax` maps a flax param tree (nested dicts of numpy
  arrays, as `DVRModel.init` makes and `Trainer.save_checkpoint` writes
  under "model") to a torch state_dict of the port's DVRModel, and
  `params_to_flax` maps it back. Flax dense kernels are stored (in, out);
  torch.nn.Linear weights are (out, in).
- `load_flax_checkpoint` reads a `ckpt_*.flax` file with a small msgpack
  decoder, so a model fitted by the JAX trainer loads where neither flax
  nor msgpack is installed; `msgpack_dumps` is the matching encoder, with
  which the port's trainer writes its checkpoints in the same format.
- `opt_state_to_optax` / `opt_state_from_optax` write and read the AdamW
  moments in the layout the JAX trainer's optax state serializes to, so
  that either trainer resumes the other's checkpoint with its moments.

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


# ------------------------------------------------- optimizer state (optax)

OPTAX_LAYOUT = "optax.chain(clip_with_norm, multi_transform(adamw))"
PORT_LAYOUT = "lab4d_tpu_torch.AdamW"
ADAMW_LABELS = ("base", "explicit")


def _set_path(tree: Dict, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _leaves(tree, prefix=()):
    """(path, array) of every leaf; empty dicts (optax's masked entries)
    have none."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def opt_state_to_optax(moments, labels, count: int, grad_norm: float = 0.0) -> Dict:
    """The AdamW state of the port as the JAX trainer's optimizer state
    serializes (flax.serialization.to_state_dict of optax.chain(
    clip_with_norm, multi_transform({"base": adamw, "explicit": adamw,
    "frozen": set_to_zero}))):

        {"0": {"grad_norm"}, "1": {"inner_states": {label: {"inner_state":
         {"0": {"count", "mu", "nu"}, "1": {}, "2": {"count"}}}},
         "frozen": {"inner_state": {}}}}}

    mu / nu are flax param trees holding the moments of the label's
    parameters and an empty dict at every other parameter. moments:
    {torch name: (exp_avg, exp_avg_sq)} numpy arrays in the torch layout;
    labels: {torch name: label}; count: the updates taken."""
    c = np.asarray(count, np.int32)
    inner = {}
    for label in ADAMW_LABELS:
        mu, nu = {}, {}
        for name, lab in labels.items():
            path, transpose = torch_to_flax_path(name)
            if lab == label:
                m, v = (np.ascontiguousarray(a.T if transpose else a) for a in moments[name])
            else:
                m, v = {}, {}
            _set_path(mu, path, m)
            _set_path(nu, path, v)
        inner[label] = {"inner_state": {"0": {"count": c, "mu": mu, "nu": nu}, "1": {},
                                        "2": {"count": c}}}
    inner["frozen"] = {"inner_state": {}}
    return {"0": {"grad_norm": np.asarray(grad_norm, np.float32)}, "1": {"inner_states": inner}}


def opt_state_leaves(tree) -> Dict:
    """{path: shape} of the leaves of an optimizer state in the optax
    layout; a missing grad_norm leaf counts as the scalar it is (the JAX
    trainer backfills it for checkpoints written before it had one)."""
    shapes = {path: np.shape(v) for path, v in _leaves(tree)}
    shapes.setdefault(("0", "grad_norm"), ())
    return shapes


def opt_state_from_optax(tree) -> Tuple[int, Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """(count, {torch name: (exp_avg, exp_avg_sq)}) of an optimizer state
    in the optax layout (opt_state_to_optax) or the port's earlier
    manifest layout ({"layout": PORT_LAYOUT, "step", "params": {torch name:
    {"exp_avg", "exp_avg_sq"}}})."""
    if tree.get("layout") == PORT_LAYOUT:
        return int(tree["step"]), {n: (np.asarray(ms["exp_avg"]), np.asarray(ms["exp_avg_sq"]))
                                   for n, ms in tree["params"].items()}
    moments, count = {}, 0
    for label in ADAMW_LABELS:
        adam = tree["1"]["inner_states"][label]["inner_state"]["0"]
        count = int(adam["count"])
        nu = dict(_leaves(adam["nu"]))
        for path, m in _leaves(adam["mu"]):
            key, transpose = flax_to_torch_key(path)
            v = np.asarray(nu[path])
            m = np.asarray(m)
            moments[key] = (m.T, v.T) if transpose else (m, v)
    return count, moments


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


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack(">B", fixed[n])
    elif n < 1 << 8:
        head = struct.pack(">BB", 0xC7, n)
    elif n < 1 << 16:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack(">b", code) + payload


_UINTS = ((1 << 8, ">BB", 0xCC), (1 << 16, ">BH", 0xCD), (1 << 32, ">BI", 0xCE),
          (1 << 64, ">BQ", 0xCF))
_INTS = ((1 << 7, ">Bb", 0xD0), (1 << 15, ">Bh", 0xD1), (1 << 31, ">Bi", 0xD2),
         (1 << 63, ">Bq", 0xD3))


def _pack_int(obj: int) -> bytes:
    """An int at msgpack's smallest width, as msgpack (and so flax) writes
    it: a fixint, else uint 8/16/32/64 when >= 0, int 8/16/32/64 when < 0."""
    if 0 <= obj <= 0x7F or -32 <= obj < 0:
        return struct.pack(">b" if obj < 0 else ">B", obj)
    for bound, fmt, code in (_UINTS if obj >= 0 else _INTS):
        if (obj < bound) if obj >= 0 else (obj >= -bound):
            return struct.pack(fmt, code, obj)
    raise OverflowError(f"int {obj} does not fit msgpack's 64 bits")


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        arr = np.asarray(obj, order="C")  # not ascontiguousarray: it makes 0-d arrays 1-d
        out.append(_pack_ext(_EXT_NDARRAY, msgpack_dumps(
            [list(arr.shape), arr.dtype.name, arr.tobytes()])))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        out.append(_pack_ext(_EXT_NPSCALAR, msgpack_dumps([[], arr.dtype.name, arr.tobytes()])))
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(struct.pack(">B", 0xA0 | n))
        elif n < 1 << 8:
            out.append(struct.pack(">BB", 0xD9, n))
        elif n < 1 << 16:
            out.append(struct.pack(">BH", 0xDA, n))
        else:
            out.append(struct.pack(">BI", 0xDB, n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        out.append(struct.pack(">BB", 0xC4, n) if n < 1 << 8 else
                   struct.pack(">BH", 0xC5, n) if n < 1 << 16 else struct.pack(">BI", 0xC6, n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(struct.pack(">B", 0x90 | n) if n < 16 else
                   struct.pack(">BH", 0xDC, n) if n < 1 << 16 else struct.pack(">BI", 0xDD, n))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out.append(struct.pack(">B", 0x80 | n) if n < 16 else
                   struct.pack(">BH", 0xDE, n) if n < 1 << 16 else struct.pack(">BI", 0xDF, n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def msgpack_dumps(obj) -> bytes:
    """Encode nested dicts / lists of numbers, strings, bytes and numpy
    arrays the way flax.serialization.msgpack_serialize does (arrays as
    ext type 1 holding [shape, dtype name, C-order bytes])."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def load_flax_checkpoint(path: str):
    """Read a checkpoint written by the JAX trainer: a dict with "model"
    (flax params), "geo_state", "proxy", "manifest" and, when present,
    "opt_state"; the manifest keys are also copied to the top level."""
    with open(path, "rb") as f:
        ckpt = msgpack_restore(f.read())
    ckpt.update(ckpt.get("manifest", {}))
    return ckpt
