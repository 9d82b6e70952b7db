"""K3, the fused ReLU MLP: the port's fused_relu_mlp against the JAX
package's Pallas kernel (interpret mode on the CPU, as
tests/test_mlp_kernel.py runs it) and its jnp oracle, at that file's
cases and at the render path's shapes.

On the CPU the port's wrapper takes its plain version (mlp_reference);
the CUDA kernel itself is compared with it by the `cuda`-marked test,
which needs a card and runs there without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_mlp_kernel.py

Tolerance: fp32 with sums in another order. The cases of
tests/test_mlp_kernel.py use N(0, 1/fan_in) weights and O(1) outputs,
where that file's own kernel-vs-oracle bound is atol 2e-4; the render
shapes use torch's default init and O(0.1) outputs, compared at 1e-5.
"""

import numpy as np
import pytest
import torch

from lab4d_tpu_torch.ops import mlp_kernel as K


def normal_mlp(dims, skips, seed=0):
    """Weights (in, out) as tests/test_mlp_kernel.py makes them."""
    weights = [
        (np.random.default_rng(i).standard_normal(
            (dims[i] + (dims[0] if i in skips else 0), dims[i + 1])) / np.sqrt(dims[i])
         ).astype(np.float32)
        for i in range(len(dims) - 1)
    ]
    rng = np.random.default_rng(seed)
    biases = [(rng.standard_normal(c) * 0.01).astype(np.float32) for c in dims[1:]]
    return weights, biases


def torch_init_mlp(C_in, D, W, seed):
    """torch.nn.Linear default init, (in, out) like the JAX package."""
    rng = np.random.default_rng(seed)
    weights, biases, fan_in = [], [], C_in
    for _ in range(D + 1):
        b = 1 / np.sqrt(fan_in)
        weights.append(rng.uniform(-b, b, (fan_in, W)).astype(np.float32))
        biases.append(rng.uniform(-b, b, W).astype(np.float32))
        fan_in = W
    return weights, biases


def compare(x, weights, biases, skips, final_act, atol):
    # jax is imported here so that the card, which has no jax, can run
    # this file's cuda-marked test
    import jax.numpy as jnp

    from lab4d_tpu.ops.mlp_kernel import fused_relu_mlp as jax_fused_relu_mlp
    from lab4d_tpu.ops.mlp_kernel import mlp_reference as jax_mlp_reference

    want_kernel = np.asarray(jax_fused_relu_mlp(
        jnp.asarray(x), [jnp.asarray(w) for w in weights], [jnp.asarray(b) for b in biases],
        tuple(skips), final_act))
    want_ref = np.asarray(jax_mlp_reference(
        jnp.asarray(x), [jnp.asarray(w) for w in weights], [jnp.asarray(b) for b in biases],
        tuple(skips), final_act))
    tw = [torch.tensor(w.T.copy()) for w in weights]  # nn.Linear layout
    tb = [torch.tensor(b) for b in biases]
    launches = K.fused_relu_mlp.launches
    got = K.fused_relu_mlp(torch.tensor(x), tw, tb, skips, final_act).numpy()
    assert K.fused_relu_mlp.launches == launches  # a CPU tensor never launches
    plain = K.mlp_reference(torch.tensor(x), tw, tb, tuple(skips), final_act).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, want_kernel, atol=atol)
    np.testing.assert_allclose(got, want_ref, atol=atol)


@pytest.mark.parametrize(
    "P,dims,skips,final_act",
    [
        (256, (63, 128, 128, 64), (), False),
        (1500, (95, 256, 256, 256, 256, 256), (2,), True),  # skip concat
        (1024, (16, 64, 1), (), False),
    ],
)
def test_cases_of_jax_kernel_test(P, dims, skips, final_act):
    x = np.random.default_rng(1).standard_normal((P, dims[0])).astype(np.float32)
    weights, biases = normal_mlp(dims, skips)
    compare(x, weights, biases, skips, final_act, atol=2e-4)


RENDER_SHAPES = [  # (rows, C_in, D, W): TimeMLP backbones on the render path
    (1, 256, 5, 256),  # camera / intrinsics, one frame
    (7, 256, 5, 256),  # several frames at once
    (1, 64, 2, 64),  # appearance
    (7, 64, 2, 64),
]


@pytest.mark.parametrize("rows,C_in,D,W", RENDER_SHAPES)
def test_render_shapes(rows, C_in, D, W):
    x = np.random.default_rng(rows + W).standard_normal((rows, C_in)).astype(np.float32)
    weights, biases = torch_init_mlp(C_in, D, W, seed=W)
    compare(x, weights, biases, (), True, atol=1e-5)


def _layers(C_in, widths, skips=()):
    ws, bs, prev = [], [], C_in
    for i, w in enumerate(widths):
        ws.append(torch.zeros(w, prev + (C_in if i in skips else 0)))
        bs.append(torch.zeros(w))
        prev = w
    return ws, bs


@pytest.mark.parametrize(
    "x_shape,widths,skips,bias_fix,match",
    [
        ((3, 8), [16, 4], (), None, None),  # valid
        ((8,), [16, 4], (), None, "rows, C_in"),
        ((3, 8), [16] * 17, (), None, "layers"),
        ((3, 8), [16, 4], (0,), None, "layer 0"),
        ((3, 8), [16, 4], (1,), None, None),  # skip layer takes [x, h]
        ((3, 8), [16, 4], (), "short", "layer 1"),
    ],
)
def test_wrapper_checks(x_shape, widths, skips, bias_fix, match):
    """The wrapper's argument checks, which run before any launch."""
    x = torch.zeros(x_shape)
    ws, bs = _layers(8, widths, skips)
    if bias_fix == "short":
        bs[1] = torch.zeros(3)
    if match is None:
        K._check_args(x, ws, bs, skips)
    else:
        with pytest.raises(ValueError, match=match):
            K._check_args(x, ws, bs, skips)


def test_wrapper_rejects_non_contiguous_and_other_devices():
    ws, bs = _layers(8, [16, 4])
    with pytest.raises(ValueError, match="contiguous"):
        K._check_args(torch.zeros(8, 3).t(), ws, bs, ())
    with pytest.raises(NotImplementedError):
        K.fused_relu_mlp(torch.zeros(3, 8, device="meta"), ws, bs)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C_in,D,W", RENDER_SHAPES + [(300, 95, 5, 128)])
def test_cuda_kernel_matches_plain(rows, C_in, D, W):
    """The CUDA kernel against its plain version on the card (fp32 FMA vs
    cuBLAS fp32, TF32 off: atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    weights, biases = torch_init_mlp(C_in, D, W, seed=W)
    tw = [torch.tensor(w.T.copy()).cuda() for w in weights]
    tb = [torch.tensor(b).cuda() for b in biases]
    x = torch.randn(rows, C_in, generator=torch.Generator().manual_seed(0)).cuda()
    skips = (4,) if D >= 5 and C_in == 95 else ()
    if skips:
        tw[4] = torch.randn(W, W + C_in, device="cuda") / np.sqrt(W + C_in)
    launches = K.fused_relu_mlp.launches
    got = K.fused_relu_mlp(x, tw, tb, skips, True)
    want = K.mlp_reference(x, tw, tb, skips, True)
    torch.cuda.synchronize()
    assert K.fused_relu_mlp.launches == launches + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
