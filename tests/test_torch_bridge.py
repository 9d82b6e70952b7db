"""Weights and checkpoints from the JAX package into lab4d_tpu_torch.

- the flagship (fg / skel-quad) and the bg flax param trees map onto the
  port's DVRModel state_dict leaf for leaf, and back, exactly;
- a checkpoint in the JAX trainer's layout, written with
  flax.serialization.msgpack_serialize, decodes through the port's own
  msgpack reader to the same arrays flax's msgpack_restore gives;
- the port's msgpack encoder (its trainer's checkpoints) writes what
  msgpack and flax read back unchanged.
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


def _both_models(field_type, fg_motion):
    """(flax param tree with seeded random values, port model)."""
    model, batch = make_model_and_batch(field_type, fg_motion, M=2, N=4)
    shapes = jax.eval_shape(
        lambda b: model.init(RNGS, b, compute_sched(100), train=True), batch
    )["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    fi = model.frame_info
    tmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      field_type=field_type, fg_motion=fg_motion, device="cpu")
    return jax.tree.map(np.asarray, dict(params)), tmodel


@pytest.fixture(scope="module")
def flagship():
    return _both_models("fg", "skel-quad")


@pytest.fixture(scope="module")
def bg_models():
    return _both_models("bg", "rigid")


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


def test_bg_every_leaf_maps_once(bg_models):
    """The bg field, the intrinsics and the camera MLP, leaf for leaf."""
    params, tmodel = bg_models
    flat = flatten_dict(params)
    state = bridge.params_from_flax(params)
    assert len(state) == len(flat)
    assert set(state) == set(tmodel.state_dict())
    assert {p[:2] for p in flat} == {("fields", "field_params_bg"), ("intrinsics", "backbone"),
                                    ("intrinsics", "focal_head_0"), ("intrinsics", "focal_head_1"),
                                    ("intrinsics", "time_embedding"),
                                    ("intrinsics", "base_logfocal"), ("intrinsics", "base_ppoint")}
    tmodel.load_state_dict(state, strict=True)
    back = flatten_dict(bridge.params_to_flax(tmodel.state_dict()))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    bg = params["fields"]["field_params_bg"]
    field = tmodel.fields.field_params["bg"]
    np.testing.assert_array_equal(field.basefield.backbone.linear_5.weight.detach().numpy(),
                                  bg["basefield"]["backbone"]["linear_5"].T)
    np.testing.assert_array_equal(field.camera_mlp.base_quat.detach().numpy(),
                                  bg["camera_mlp"]["base_quat"])
    np.testing.assert_array_equal(field.vis_mlp.basefield.backbone.linear_final.bias.detach().numpy(),
                                  bg["vis_mlp"]["basefield"]["backbone"]["bias_final"])


@pytest.mark.parametrize(
    "obj",
    [
        {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros((0, 3), np.int32)},
        {"s": np.float32(2.5), "i": np.int32(-4), "m": {"n": [1, 300, -1000, 2**40, 0.5, "x" * 40]}},
        {"t": True, "f": False, "z": None, "b": b"\x00" * 300, "l": list(range(20))},
    ],
    ids=["arrays", "scalars", "containers"],
)
def test_msgpack_encoder_reads_back(obj):
    """bridge.msgpack_dumps against flax's reader and the port's own."""
    data = bridge.msgpack_dumps(obj)
    _assert_same_tree(serialization.msgpack_restore(data), obj)
    _assert_same_tree(bridge.msgpack_restore(data), obj)


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
