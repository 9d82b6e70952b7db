"""Weights and checkpoints from the JAX package into lab4d_tpu_torch.

- the flagship (fg / skel-quad) flax param tree maps onto the port's
  DVRModel state_dict leaf for leaf, and back, exactly;
- a checkpoint in the JAX trainer's layout, written with
  flax.serialization.msgpack_serialize, decodes through the port's own
  msgpack reader to the same arrays flax's msgpack_restore gives.
"""

import numpy as np
import jax
import msgpack
import pytest
from flax import serialization
from flax.traverse_util import flatten_dict

from lab4d_tpu.engine.schedules import compute_sched
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import RNGS, make_model_and_batch


@pytest.fixture(scope="module")
def flagship():
    """(flax param tree with seeded random values, port model)."""
    model, batch = make_model_and_batch("fg", "skel-quad", M=2, N=4)
    shapes = jax.eval_shape(
        lambda b: model.init(RNGS, b, compute_sched(100), train=True), batch
    )["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    fi = model.frame_info
    tmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      fg_motion="skel-quad")
    return jax.tree.map(np.asarray, dict(params)), tmodel


def test_every_leaf_maps_once(flagship):
    params, tmodel = flagship
    flat = flatten_dict(params)
    state = bridge.params_from_flax(params)
    assert len(state) == len(flat) == 154
    assert set(state) == set(tmodel.state_dict())
    for path, value in flat.items():
        key, transpose = bridge.flax_to_torch_key(path)
        want = value.T if transpose else value
        assert tuple(state[key].shape) == want.shape, key
        assert tuple(tmodel.state_dict()[key].shape) == want.shape, key


def test_roundtrip_is_exact(flagship):
    params, tmodel = flagship
    tmodel.load_state_dict(bridge.params_from_flax(params), strict=True)
    back = flatten_dict(bridge.params_to_flax(tmodel.state_dict()))
    flat = flatten_dict(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))


def test_dense_layout_is_transposed(flagship):
    params, tmodel = flagship
    tmodel.load_state_dict(bridge.params_from_flax(params))
    cam = params["fields"]["field_params_fg"]["camera_mlp"]
    torch_cam = tmodel.fields.field_params["fg"].camera_mlp
    np.testing.assert_array_equal(torch_cam.backbone.linear_2.weight.detach().numpy(),
                                  cam["backbone"]["linear_2"].T)
    np.testing.assert_array_equal(torch_cam.trans_head[1].weight.detach().numpy(),
                                  cam["trans_head_1"]["kernel"].T)
    np.testing.assert_array_equal(
        torch_cam.time_embedding.inst_embedding.mapping.weight.detach().numpy(),
        cam["time_embedding"]["inst_embedding"]["mapping"]["embedding"])


def _trainer_payload(params):
    """A checkpoint dict in the layout Trainer.save_checkpoint writes."""
    rng = np.random.default_rng(1)
    return {
        "manifest": {"format": 1, "current_steps": 4000, "current_round": 20},
        "model": params,
        "opt_state": {
            "0": {"count": np.asarray(7, np.int32),
                  "mu": {"w": rng.standard_normal((3, 2)).astype(np.float32)}},
            "1": {"grad_norm": np.asarray(0.5, np.float32)},
        },
        "geo_state": {"fg": {
            "aabb": rng.standard_normal((2, 3)).astype(np.float32),
            "near_far": rng.random((12, 2)).astype(np.float32),
            "corners": rng.standard_normal((8, 3)).astype(np.float32),
        }},
        "proxy": {"fg": {
            "vertices": rng.standard_normal((30, 3)).astype(np.float32),
            "faces": rng.integers(0, 30, (56, 3)).astype(np.int32),
        }},
    }


def _assert_same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want and type(got) is type(want), where


def test_checkpoint_decodes_like_flax(flagship, tmp_path):
    params, tmodel = flagship
    path = tmp_path / "ckpt_latest.flax"
    path.write_bytes(serialization.msgpack_serialize(_trainer_payload(params)))
    want = serialization.msgpack_restore(path.read_bytes())
    got = bridge.load_flax_checkpoint(str(path))
    assert got.pop("format") == 1 and got.pop("current_steps") == 4000
    assert got.pop("current_round") == 20
    _assert_same_tree(got, want)
    tmodel.load_state_dict(bridge.params_from_flax(got["model"]), strict=True)


@pytest.mark.parametrize(
    "obj",
    [
        0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128, -129,
        -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
        0.5, -1e300, True, False, None, "", "x" * 31, "y" * 32, "z" * 300, "z" * 70000,
        b"", b"\x00" * 300, b"\x01" * 70000, list(range(15)), list(range(16)),
        list(range(70000)), {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
        {"nested": [{"a": [1, 2.5, "s"]}, None]},
    ],
    ids=lambda o: type(o).__name__ + str(len(o) if hasattr(o, "__len__") else o)[:12],
)
def test_msgpack_scalars_and_containers(obj):
    """Every msgpack format the reader decodes, against msgpack itself."""
    data = msgpack.packb(obj, use_bin_type=True)
    got = bridge.msgpack_restore(data)
    want = msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint8", "bool"])
@pytest.mark.parametrize("shape", [(), (0,), (5,), (2, 3, 4)])
def test_msgpack_ndarray_ext(dtype, shape):
    arr = (np.arange(int(np.prod(shape))) % 7).reshape(shape).astype(dtype)
    data = serialization.msgpack_serialize({"a": arr, "s": arr.reshape(-1)[:1].copy()[0]
                                            if arr.size else np.float32(2.0)})
    got, want = bridge.msgpack_restore(data), serialization.msgpack_restore(data)
    _assert_same_tree({"a": got["a"]}, {"a": want["a"]})
    assert got["s"] == want["s"] and type(got["s"]) is type(want["s"])


def test_msgpack_rejects_truncated_data():
    data = serialization.msgpack_serialize({"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError):
        bridge.msgpack_restore(data[:-3])
