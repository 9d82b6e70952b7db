"""The pieces the five preprocessing nets share: flax.linen's Conv on
NCHW tensors, jax.image.resize's bilinear resize, the U-Net of
the depth and segmentation nets, and the loader of their flax msgpack
weights (read with the port's own msgpack reader, never with flax).

flax's padding "SAME" pads (total // 2, total - total // 2) with
total = (out - 1) * stride + (k - 1) * dilation + 1 - size and
out = ceil(size / stride): a 3x3 stride-2 conv pads (0, 1) on an even
size, at the bottom and right only, which nn.Conv2d(padding=1) does not.
Kernels go from flax's HWIO to torch's OIHW, Dense kernels from (in, out)
to (out, in).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lab4d_tpu_torch.bridge import msgpack_restore


def same_padding(size: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """flax / lax "SAME" padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax.linen.Conv (padding "SAME", bias) on NCHW tensors."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.k, self.stride, self.dilation = k, stride, dilation
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = same_padding(x.shape[-2], self.k, self.stride, self.dilation)
        left, right = same_padding(x.shape[-1], self.k, self.stride, self.dilation)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") over the last two axes of an NCHW
    tensor: half-pixel centres, the weights renormalised at the edges
    (which clamping the source coordinate reproduces), and on a downscale
    the triangle kernel widened by the scale (antialiasing)."""
    size = (int(size[0]), int(size[1]))
    down = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=down)


class UNet(nn.Module):
    """The depth and segmentation nets' U-Net (preprocess/backends/
    depth_unet.py, seg_unet.py): 4 stride-2 stages, a 128-wide bottleneck,
    a decoder with skips, one logit per pixel. (B, cin, H, W) -> (B, H, W)."""

    CHANNELS = (32, 48, 64, 96)

    def __init__(self, cin: int):
        super().__init__()
        convs, prev = [], cin
        for ch in self.CHANNELS:
            convs += [Conv(prev, ch, 3, stride=2), Conv(ch, ch)]
            prev = ch
        convs.append(Conv(prev, 128))
        prev = 128
        for ch in reversed(self.CHANNELS):
            convs.append(Conv(prev + ch, ch))
            prev = ch
        convs += [Conv(prev, 16), Conv(16, 1, 1)]
        for i, conv in enumerate(convs):  # flax's names, in its call order
            setattr(self, f"Conv_{i}", conv)

    def conv(self, i: int) -> Conv:
        return getattr(self, f"Conv_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, h = [], x
        for s in range(len(self.CHANNELS)):
            h = F.relu(self.conv(2 * s)(h))
            h = F.relu(self.conv(2 * s + 1)(h))
            skips.append(h)
        i = 2 * len(self.CHANNELS)
        h = F.relu(self.conv(i)(h))
        for s in reversed(skips):
            i += 1
            h = resize_bilinear(h, s.shape[-2:])
            h = F.relu(self.conv(i)(torch.cat([h, s], 1)))
        h = resize_bilinear(h, x.shape[-2:])
        h = F.relu(self.conv(i + 1)(h))
        return self.conv(i + 2)(h)[:, 0]


# ------------------------------------------------------------------ weights


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def flax_to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """A flax params tree ({"Conv_0": {"kernel", "bias"}, ...}) -> the
    state dict of the module whose attributes carry flax's names."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, np.float32)  # a writable copy
        *mod, leaf_name = path
        if leaf_name == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf_name = "weight"
        elif leaf_name != "bias":
            raise ValueError(f"unexpected leaf {'/'.join(path)}")
        out[".".join(mod + [leaf_name])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_to_flax(module: nn.Module) -> Dict:
    """flax_to_state_dict's inverse: the module's parameters as the flax
    params tree, "weight" back to "kernel" (a conv's (O, I, kh, kw) to
    (kh, kw, I, O), a dense layer's (out, in) to (in, out)), float32 numpy
    leaves, the keys of every level in lexical order as flax writes a
    tree that went through jit (Conv_0, Conv_1, Conv_10, ...; bias before
    kernel). msgpack_dumps of it is flax.serialization.to_bytes's output."""
    tree: Dict = {}
    for name, t in module.state_dict().items():
        *mod, leaf = name.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {name}")
        node = tree
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)

    def ordered(node):
        if not isinstance(node, dict):
            return node
        return {k: ordered(node[k]) for k in sorted(node)}

    return ordered(tree)


# flax's lecun_normal: variance_scaling(1.0, "fan_in", "truncated_normal"),
# a normal truncated at +-2 std whose std is divided by the truncated
# normal's own std (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `module` in place as flax initialises the net: every
    kernel lecun_normal (fan_in = kh * kw * in for a conv, in for a dense
    layer), every bias zero, except the biases the module names in its
    BIAS_INIT ({parameter name: constant}). The draws come from
    `generator` (on the CPU), in the order of named_parameters."""
    consts = getattr(module, "BIAS_INIT", {})
    for name, p in module.named_parameters():
        if name.endswith("weight"):
            fan_in = p[0].numel()  # (O, I, kh, kw) or (out, in)
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            draw = torch.empty(p.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
            p.copy_(draw)
        else:
            p.fill_(consts.get(name, 0.0))
    return module


@functools.lru_cache(maxsize=8)
def _read_state_dict(path: str, mtime: float) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        return flax_to_state_dict(msgpack_restore(f.read()))


def load_flax_weights(module: nn.Module, path: str) -> nn.Module:
    """Load a flax msgpack checkpoint into `module` (strict: every name and
    shape must match, as flax.serialization.from_bytes requires of its
    template). Raises on a missing, corrupt or mismatched file."""
    module.load_state_dict(_read_state_dict(path, os.path.getmtime(path)), strict=True)
    return module


def load_net(cls, path: str, name: str, fallback: str, device="cpu"):
    """`cls()` with the weights at `path` on `device`, in eval mode, or None
    when the file is absent or unusable (the caller then runs its
    classical backend, as the JAX package's available() does)."""
    if not os.path.exists(path):
        return None
    try:
        model = load_flax_weights(cls(), path)
    except Exception as e:  # a corrupt or stale file must not kill preprocessing
        print(f"[warn] {name} weights unusable ({e}); {fallback}")
        return None
    return model.to(device).eval().requires_grad_(False)


def to_nchw(frames: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, C) float32 numpy -> (B, C, H, W) tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(device).permute(0, 3, 1, 2)
