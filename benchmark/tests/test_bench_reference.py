"""The reference against the program at a tiny size on the CPU, where both
run plain fp32; the control (the reference in TF32) against the cells'
limits; on a card, the control at the cells' own sizes."""

import numpy as np
import pytest
import torch

from benchmark import control, limits, scene, weights
from benchmark.reference import geometry, model as ref_model, render as ref_render
from benchmark.tests.conftest import TINY

SEED = 2**32 + 77


def _priors(n=4, res=64):
    p = scene.scene_params(SEED, n, res)
    return {"num_frames": n, "intrinsics": np.tile(p["K"], (n, 1)).astype(np.float32),
            "rtmat": scene.orbit(p).astype(np.float32), "train_res": res}


@pytest.mark.parametrize("motion", ["skel-quad", "dense"])
def test_reference_frames_match_program(motion, torch_threads):
    from lab4d_tpu_torch.engine.model import DVRModel
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo
    from lab4d_tpu_torch.render import construct_batch_from_opts, render_batch

    cfg = {"field_type": "fg", "fg_motion": motion}
    pri = _priors()
    state = weights.make_state(cfg, pri, SEED, "cpu")
    prog = DVRModel(FrameInfo.single_video(4), field_type="fg", fg_motion=motion, device="cpu",
                    generator=torch.Generator().manual_seed(1), intrinsics_init=pri["intrinsics"],
                    rtmat_fg=pri["rtmat"], rtmat_bg=pri["rtmat"])
    prog.load_state_dict(state)
    prog.eval().requires_grad_(False)
    ref = ref_model.build(cfg, pri, "cpu")
    ref.load_state_dict(state)
    ref.eval().requires_grad_(False)
    _, bounds, corners = geometry.proxy_sphere()
    geo = {"fg": {"aabb": bounds.astype(np.float32), "corners": corners.astype(np.float32)}}
    opts = {"inst_id": 0, "render_res": 16, "viewpoint": "ref", "freeze_id": -1, "noskip": False,
            "num_frames": -1}
    data_info = {"raw_size": np.array([[64, 64]]), "frame_info": FrameInfo.single_video(4)}
    batch, _ = construct_batch_from_opts(opts, prog, geo, data_info, "cpu")
    rbatch = ref_render.ref_view_batch(ref, (64, 64), 16, "cpu")
    torch.testing.assert_close(rbatch["Kinv"], batch["Kinv"])
    got = render_batch(prog, {k: v[2:3] for k, v in batch.items()}, geo, chunk=64, topk=8)
    want = ref_render.render_frame(ref, rbatch, geo, 2, 64, topk=8)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k], rtol=1e-5, atol=1e-6)


def test_weights_are_the_seeds():
    cfg = {"field_type": "fg", "fg_motion": "dense"}
    a = weights.make_state(cfg, _priors(), SEED, "cpu")
    b = weights.make_state(cfg, _priors(), SEED, "cpu")
    c = weights.make_state(cfg, _priors(), SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "fields.field_params.fg.warp.backward_map.backbone.linear_2.weight"
    assert not torch.equal(a[w], c[w])
    assert float(a[w].abs().max()) <= 1 / 16 + 1e-7


@pytest.mark.parametrize("cell", ["dense.train", "skel-quad.render-topk", "dense.render-topk"])
def test_control_fails_and_program_passes_at_test_size(cell, torch_threads):
    """At a test's size on the CPU (TF32 emulated in the forward's products)
    the control fails at least one of the cell's limits; the program passes
    them all."""
    tiny = TINY["train" if cell.endswith("train") else "render"]
    out = control.readings(cell, [SEED], control_seeds=1, device="cpu", overrides=tiny,
                           log=lambda *a: None)
    lim = limits.load(cell)
    prog, ctrl = out["program"][str(SEED)], out["control"][str(SEED)]
    assert all(prog[k] <= v for k, v in lim.items()), prog
    assert any(ctrl[k] > v for k, v in lim.items()), ctrl


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dense.train", "skel-quad.render-topk", "dense.render-topk"])
def test_control_fails_at_cell_size(cell, card):
    """On the card at the cell's own size, three seeds: the control fails a
    limit on each, the program passes them all."""
    seeds = [3 * 2**31 + s for s in (1, 2, 3)]
    out = control.readings(cell, seeds, control_seeds=3, log=lambda *a: None)
    lim = limits.load(cell)
    for s in map(str, seeds):
        assert all(out["program"][s][k] <= v for k, v in lim.items()), out["program"][s]
        assert any(out["control"][s][k] > v for k, v in lim.items()), out["control"][s]
