"""The five preprocessing nets of the port (lab4d_tpu_torch/preprocess/
backends/) against the JAX package's flax nets at the weights that ship
in database/weights/, on seeded numpy inputs, on the CPU:

- the msgpack load (the port's own reader) equals flax's
  serialization.from_bytes, leaf for leaf;
- each net at its working size (256^2 for the U-Nets and RAFT, RAFT also
  at 64^2, 112^2 for the descriptor net, 96^2 for the viewpoint net) and
  at one odd size, which pins flax's "SAME" padding of the stride-2 and
  dilated convs: max |port - flax| <= 1e-4 * max |flax|;
- flax's Conv (stride 2, dilation) and jax.image.resize (up, antialiased
  down, mixed) against the port's layers at even and odd sizes;
- a corrupt weights file sends every stage to its classical backend, as
  the JAX package's available() does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
import flax.linen as nn

from lab4d_tpu_torch.preprocess.backends import layers

NET_TOL = 1e-4  # of the flax output's largest magnitude; fp32, summation order only
LAYER_TOL = 1e-5  # absolute, one conv / resize of O(1) values


def _flax_nets():
    from preprocess.backends import (depth_unet, feat_net, flow_raft, seg_unet,
                                     viewpoint_net)

    return {
        "flow_raft": (flow_raft.RAFTLite(), flow_raft.weights_path(), 2, (64, 64, 3)),
        "seg_unet": (seg_unet.SegUNet(), seg_unet.weights_path(), 1, (64, 64, 4)),
        "depth_unet": (depth_unet.DepthUNet(), depth_unet.weights_path(), 1, (64, 64, 3)),
        "feat_net": (feat_net.FeatNet(), feat_net.weights_path(), 1, (112, 112, 3)),
        "viewpoint_net": (viewpoint_net.ViewpointNet(), viewpoint_net.weights_path(), 1,
                          (96, 96, 3)),
    }


def _port_net(name):
    from lab4d_tpu_torch.preprocess.backends import (depth_unet, feat_net, flow_raft,
                                                     seg_unet, viewpoint_net)

    mods = {"flow_raft": flow_raft, "seg_unet": seg_unet, "depth_unet": depth_unet,
            "feat_net": feat_net, "viewpoint_net": viewpoint_net}
    model = mods[name].load_model()
    assert model is not None, name
    return model


_PARAMS = {}


def _flax_params(name):
    if name not in _PARAMS:
        model, path, n_in, shape = _flax_nets()[name]
        dummy = [jnp.zeros(shape, jnp.float32)] * n_in
        template = model.init(jax.random.PRNGKey(0), *dummy)["params"]
        with open(path, "rb") as f:
            _PARAMS[name] = serialization.from_bytes(template, f.read())
    return _PARAMS[name]


NAMES = ["flow_raft", "seg_unet", "depth_unet", "feat_net", "viewpoint_net"]


@pytest.mark.parametrize("name", NAMES)
def test_msgpack_load_equals_flax(name):
    """The port's reader (bridge.msgpack_restore) against flax's
    from_bytes: every leaf of the tree, bit for bit, in the port's layout."""
    want = layers.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, _flax_params(name)))
    got = _port_net(name).state_dict()
    assert set(got) == set(want) and len(got) == len(
        jax.tree_util.tree_leaves(_flax_params(name))), name
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())


# (net, input HWC) at the working size and one odd size
CASES = [
    ("flow_raft", (256, 256)), ("flow_raft", (64, 64)), ("flow_raft", (75, 61)),
    ("seg_unet", (256, 256)), ("seg_unet", (97, 83)),
    ("depth_unet", (256, 256)), ("depth_unet", (97, 83)),
    ("feat_net", (112, 112)), ("feat_net", (97, 83)),
    ("viewpoint_net", (96, 96)), ("viewpoint_net", (97, 83)),
]


@pytest.mark.parametrize("name,hw", CASES, ids=[f"{n}-{h}x{w}" for n, (h, w) in CASES])
def test_net_matches_flax(name, hw):
    model, _, n_in, shape = _flax_nets()[name]
    rng = np.random.default_rng(CASES.index((name, hw)))
    xs = [rng.random(hw + shape[-1:]).astype(np.float32) for _ in range(n_in)]
    want = np.asarray(jax.jit(model.apply)({"params": _flax_params(name)},
                                           *[jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = _port_net(name)(*[torch.from_numpy(x).permute(2, 0, 1)[None] for x in xs])[0]
    got = got.numpy()
    if name in ("flow_raft", "feat_net"):  # (C, H, W) -> flax's (H, W, C)
        got = np.moveaxis(got, 0, -1)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= NET_TOL * scale, (name, hw, err, scale)


@pytest.mark.parametrize("size", [8, 9, 16, 17, 32, 33])
@pytest.mark.parametrize("k,stride,dilation", [(3, 1, 1), (3, 2, 1), (1, 1, 1), (3, 1, 2),
                                               (3, 1, 4)])
def test_conv_same_padding_matches_flax(size, k, stride, dilation):
    conv = nn.Conv(5, (k, k), strides=(stride, stride), kernel_dilation=(dilation, dilation))
    rng = np.random.default_rng(size * 100 + k * 10 + stride + dilation)
    x = rng.standard_normal((size, size + 3, 4)).astype(np.float32)
    params = conv.init(jax.random.PRNGKey(size), jnp.asarray(x))["params"]
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = layers.Conv(4, 5, k, stride, dilation)
    port.load_state_dict(layers.flax_to_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(2, 0, 1)[None])[0].permute(1, 2, 0).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LAYER_TOL
    # nn.Conv2d(padding=k // 2) is wrong at stride 2 on an even size
    if stride == 2 and size % 2 == 0:
        assert layers.same_padding(size, k, stride) == (0, 1)


@pytest.mark.parametrize("src,dst", [((36, 36), (72, 72)), ((25, 25), (49, 49)),
                                     ((224, 224), (112, 112)), ((256, 256), (224, 224)),
                                     ((97, 83), (40, 40)), ((13, 17), (96, 96)),
                                     ((300, 200), (224, 224))])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(sum(src + dst)).random(src + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + (3,), "bilinear"))
    got = layers.resize_bilinear(torch.from_numpy(x).permute(2, 0, 1)[None], dst)
    got = got[0].permute(1, 2, 0).numpy()
    # a downscale antialiases: the widened triangle's edge weights renormalised
    assert np.abs(got - want).max() <= 2e-5, np.abs(got - want).max()


def test_corrupt_weights_fall_back(tmp_path, monkeypatch):
    from lab4d_tpu_torch.preprocess.backends import (depth_backends, feat_net, flow_raft,
                                                     seg_backends, viewpoint_net)
    from lab4d_tpu_torch.preprocess.scripts.compute_flow import pick_flow_backend

    for name in ("flow_raft", "seg_unet", "depth_unet", "feat_net", "viewpoint_net"):
        (tmp_path / f"{name}.msgpack").write_bytes(b"\x82\xa4junk")
    monkeypatch.setenv("LAB4D_WEIGHTS_DIR", str(tmp_path))
    for var in ("LAB4D_FLOW_BACKEND", "LAB4D_SEG_BACKEND", "LAB4D_DEPTH_BACKEND",
                "LAB4D_FEAT_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    assert flow_raft.load_model() is None
    assert pick_flow_backend("cpu")[0] == "classical"
    assert seg_backends.pick_seg_backend() == "grabcut"
    assert depth_backends.pick_depth_backend() == "flowdisp"
    assert not feat_net.probe_feat_net()
    assert not viewpoint_net.available("quad")
    # the shipped weights load from any working directory
    monkeypatch.delenv("LAB4D_WEIGHTS_DIR")
    monkeypatch.chdir(tmp_path)
    assert os.path.exists(flow_raft.weights_path()) and flow_raft.available()
