"""The port's init against flax's model.init(PRNGKey(0)), leaf by leaf:
the lab4d model of every BASELINE.json family (bg, fg at each fg_motion,
both fields composed, the multi-video category model) as DVRModel builds
it without a generator (engine/jax_streams.init_params_like_jax, what
the trainer runs), and the five preprocessing nets as their trainers'
make_model(0) builds them. Uniform-drawn and constant leaves are equal
bit for bit, normal-drawn ones (instance codes, the nets' lecun_normal
kernels) within 2 ulp; every leaf matched bit for bit when measured."""

import importlib

import jax
import numpy as np
import pytest
import torch

from lab4d_tpu.engine.schedules import compute_sched
from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from tests.test_model import LOSS_WEIGHTS, RNGS, make_model_and_batch

torch.set_num_threads(1)

NORMAL_LEAVES = ("embedding",)


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _jax_category(fg_motion):
    from tests.test_torch_category import make_category

    jmodel, batch, _ = make_category(fg_motion)
    return jmodel, batch


def _compare(want, got, normal=NORMAL_LEAVES):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if not w.size:
            continue
        d = int(ulps(w, g).max())
        assert d <= (2 if key[-1] in normal else 0), (key, d)


@pytest.mark.parametrize("field_type,fg_motion,category", [
    ("bg", "rigid", False),
    ("fg", "rigid", False), ("fg", "bob", False), ("fg", "skel-human", False),
    ("fg", "skel-quad", False), ("fg", "dense", False), ("fg", "nvp", False),
    ("fg", "comp_skel-human_dense", False), ("fg", "comp_skel-quad_dense", False),
    ("comp", "comp_skel-human_dense", False),
    ("fg", "skel-quad", True), ("fg", "comp_skel-human_dense", True),
])
def test_model_init_equals_flax(field_type, fg_motion, category):
    if category:
        jmodel, batch = _jax_category(fg_motion)
    else:
        jmodel, batch = make_model_and_batch(field_type, fg_motion, M=2, N=4)
    want = dict(bridge._flatten(jax.tree.map(np.asarray, jax.jit(
        jmodel.init, static_argnames=("train",))(RNGS, batch, compute_sched(0),
                                                 train=True)["params"])))
    fi = jmodel.frame_info
    pmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      field_type=field_type, fg_motion=fg_motion, num_inst=jmodel.num_inst,
                      device="cpu", intrinsics_init=jmodel.intrinsics_init,
                      rtmat_fg=jmodel.rtmat_fg, rtmat_bg=jmodel.rtmat_bg,
                      train_res=jmodel.train_res, loss_weights=LOSS_WEIGHTS)
    got = dict(bridge._flatten(bridge.params_to_flax(
        {n: p.detach() for n, p in pmodel.named_parameters()})))
    _compare(want, got)
    if category:  # the instance codes are tables of two rows
        assert want[("fields", "field_params_fg", "basefield", "inst_embedding", "mapping",
                     "embedding")].shape[0] == 2


NETS = {
    "viewpoint": ("viewpoint_net", "ViewpointNet", lambda m: (m.RES, m.RES, 3)),
    "seg_unet": ("seg_unet", "SegUNet", None),
    "depth_unet": ("depth_unet", "DepthUNet", None),
    "flow_raft": ("flow_raft", "RAFTLite", None),
    "feat_net": ("feat_net", "FeatNet", None),
}


@pytest.mark.parametrize("net", sorted(NETS))
def test_net_init_equals_flax(net):
    """make_model(0) against the JAX trainer's Net().init(PRNGKey(0), ...)
    (the trainer tests' _flax_params)."""
    from lab4d_tpu_torch.preprocess.backends.layers import state_dict_to_flax

    tests = importlib.import_module(f"tests.test_torch_train_{net}")
    port = importlib.import_module(f"lab4d_tpu_torch.scripts.train_{net}")
    want = dict(bridge._flatten(jax.tree.map(np.asarray, dict(tests._flax_params()))))
    got = dict(bridge._flatten(state_dict_to_flax(port.make_model(0))))
    _compare(want, got, normal=("kernel",))
