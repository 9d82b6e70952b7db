"""Each kernel entry's operations and bytes against the 3xTF32 bound of the
port's kernel table (PERF.md) at one of its shapes, 262,144 rows."""

import pytest
import torch

from benchmark.peaks import ceiling_s
from benchmark.spans import KERNEL_SPANS, work_function

ROWS = 262144


def _mlp(in_dims, out_dims):
    ws = [torch.empty(o, i) for i, o in zip(in_dims, out_dims)]
    return ws, [torch.empty(o) for o in out_dims]


def _ms(entry, args):
    return ceiling_s(*work_function(entry)(args, {})) * 1e3


def test_k3_dense_map():
    # the dense warp map with its code folded: 167 inputs, D6 W256, skip 4, 3 outputs
    ws, bs = _mlp([167, 256, 256, 256, 423, 256, 256], [256] * 6 + [3])
    x, g = torch.empty(ROWS, 167), torch.empty(ROWS, 3)
    assert _ms("fused_relu_mlp", (x, ws, bs, (4,), False)) == pytest.approx(1.315, abs=5e-4)
    assert _ms("fused_relu_mlp_backward", (x, g, ws, bs, (4,))) == pytest.approx(2.631, abs=5e-4)


def test_k4_feature_field():
    # the feature field: 3 coordinates x 6 frequencies, W128 x5, skip 4, 16 outputs
    ws, bs = _mlp([39, 128, 128, 128, 167, 128], [128] * 5 + [16])
    x, g = torch.empty(ROWS, 3), torch.empty(ROWS, 16)
    freqs = tuple(2.0**i for i in range(6))
    assert _ms("fused_pe_mlp", (x, None, ws, bs, freqs)) == pytest.approx(0.246, abs=5e-4)
    assert _ms("fused_pe_mlp_backward", (x, g, None, ws, bs, freqs)) == pytest.approx(0.493,
                                                                                  abs=5e-4)


def test_k1_k2_flagship_heads():
    def net(in_dims, out_dims):
        ws, bs = _mlp(in_dims, out_dims)
        return [t for wb in zip(ws, bs) for t in wb]

    nets = {"base": net([63, 128, 128, 128, 191, 128], [128] * 6), "sdf": net([128], [1]),
            "color": net([75, 128, 128], [128] * 3), "rgb1": net([160], [64]),
            "rgb2": net([64], [3]), "vis": net([63, 64, 64], [64, 64, 1]),
            "feat": net([39, 128, 128, 128, 167, 128], [128] * 5 + [16])}
    spp = 1024
    x, appr, ibeta = torch.empty(ROWS, 3), torch.empty(ROWS // spp, 32), torch.empty(1)
    g = [torch.empty(ROWS, c) for c in (1, 3, 1, 16)]
    assert _ms("fused_nerf_heads", (x, appr, None, None, nets, ibeta, None, spp)) == \
        pytest.approx(0.746, abs=5e-4)
    assert _ms("fused_nerf_heads_backward", (x, g, appr, None, None, nets, ibeta, None, spp)) == \
        pytest.approx(1.491, abs=1e-3)


def test_every_kernel_span_has_a_work_function():
    for entry in KERNEL_SPANS.values():
        assert callable(work_function(entry))


def test_bytes_bound_at_one_row():
    # one row of a TimeMLP backbone (D5 W256): the weights' bytes bound it
    ws, bs = _mlp([256] * 6, [256] * 6)
    flops, nbytes = work_function("fused_relu_mlp")((torch.empty(1, 256), ws, bs, (), True), {})
    assert nbytes / 3.35e12 > flops / (495e12 / 3)
    assert ceiling_s(flops, nbytes) * 1e6 == pytest.approx(0.47, abs=0.01)
