"""K3 and K4, the fused MLPs: the port's kernels' wrappers against the
JAX package's Pallas kernels (interpret mode on the CPU, as
tests/test_mlp_kernel.py runs them) and its jnp oracles.

- K3f (fused_relu_mlp forward) at that file's cases and the render
  path's shapes;
- K3b (fused_relu_mlp_backward) against JAX `_bwd` and jax.vjp of the
  oracle, and the autograd of fused_relu_mlp (final ReLU mask included)
  against the JAX custom VJP;
- K4f / K4b (fused_pe_mlp and its backward) against JAX `_pe_fwd` /
  `_pe_bwd_call` and the oracle, with and without skip, final ReLU and
  annealing window, at the bg field's widths.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels themselves are compared with those by the `cuda`-marked tests,
which need a card and run there without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_mlp_kernel.py

Tolerance: fp32 with sums in another order. The cases of
tests/test_mlp_kernel.py use N(0, 1/fan_in) weights and O(1) outputs,
where that file's own kernel-vs-oracle bound is atol 2e-4; gradients,
which sum over the rows, are held to 2e-4 of each array's largest entry.
The render shapes use torch's default init and O(0.1) outputs, compared
at 1e-5. On the card the kernels' fp32 FMA sums meet cuBLAS's at 1e-4 of
each array's largest entry (forward outputs at atol 1e-4).
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


K3_CASES = [
    (256, (63, 128, 128, 64), (), False),
    (1500, (95, 256, 256, 256, 256, 256), (2,), True),  # skip concat
    (1024, (16, 64, 1), (), False),
]


@pytest.mark.parametrize("P,dims,skips,final_act", K3_CASES)
def test_cases_of_jax_kernel_test(P, dims, skips, final_act):
    x = np.random.default_rng(1).standard_normal((P, dims[0])).astype(np.float32)
    weights, biases = normal_mlp(dims, skips)
    compare(x, weights, biases, skips, final_act, atol=2e-4)


def assert_close_scaled(got, want, rel=2e-4, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def _jax_lists(weights, biases):
    import jax.numpy as jnp

    return [jnp.asarray(w) for w in weights], [jnp.asarray(b) for b in biases]


@pytest.mark.parametrize("P,dims,skips,final_act", K3_CASES)
def test_k3b_matches_jax_bwd(P, dims, skips, final_act):
    """The plain K3b against JAX `_bwd` (Pallas, interpret mode) and
    jax.vjp of the oracle; with final_act, the autograd of fused_relu_mlp
    (mask by out > 0, then K3b) against the JAX custom VJP."""
    import jax
    import jax.numpy as jnp

    from lab4d_tpu.ops import mlp_kernel as J

    rng = np.random.default_rng(3)
    x = rng.standard_normal((P, dims[0])).astype(np.float32)
    g = rng.standard_normal((P, dims[-1])).astype(np.float32)
    weights, biases = normal_mlp(dims, skips)
    jw, jb = _jax_lists(weights, biases)
    want_kernel = J._bwd(jnp.asarray(x), jnp.asarray(g), jw, jb, tuple(skips))
    _, vjp = jax.vjp(lambda x_, w_, b_: J.mlp_reference(x_, w_, b_, tuple(skips)),
                     jnp.asarray(x), jw, jb)
    want_ref = vjp(jnp.asarray(g))
    tw = [torch.tensor(w.T.copy()) for w in weights]
    tb = [torch.tensor(b) for b in biases]
    launches = K.fused_relu_mlp_backward.launches
    dx, dws, dbs = K.fused_relu_mlp_backward(torch.tensor(x), torch.tensor(g), tw, tb, skips)
    assert K.fused_relu_mlp_backward.launches == launches
    for want in (want_kernel, want_ref):
        assert_close_scaled(dx.numpy(), want[0], err_msg="dx")
        for i, (a, b) in enumerate(zip(dws, want[1])):
            assert_close_scaled(a.numpy().T, b, err_msg=f"dW{i}")
        for i, (a, b) in enumerate(zip(dbs, want[2])):
            assert_close_scaled(a.numpy(), np.asarray(b).reshape(-1), err_msg=f"db{i}")
    if final_act:
        _, vjp_k = jax.vjp(lambda x_, w_, b_: J.fused_relu_mlp(x_, w_, b_, tuple(skips), True),
                           jnp.asarray(x), jw, jb)
        want = vjp_k(jnp.asarray(g))
        xt = torch.tensor(x, requires_grad=True)
        params = [t.requires_grad_(True) for t in tw + tb]
        out = K.fused_relu_mlp(xt, params[: len(tw)], params[len(tw):], skips, True)
        grads = torch.autograd.grad(out, [xt] + params, torch.tensor(g))
        assert_close_scaled(grads[0].numpy(), want[0], err_msg="dx")
        for a, b in zip(grads[1 : 1 + len(tw)], want[1]):
            assert_close_scaled(a.numpy().T, b)


# (rows, C, n_freqs, hidden widths, out, skips, final_act, window): the bg
# field's base (skip at 4), colour and visibility MLPs at a few rows
PE_CASES = [
    (300, 3, 6, (32,) * 5, 32, (4,), True, True),
    (200, 3, 8, (48, 48), 48, (), True, True),
    (257, 3, 10, (16, 16), 1, (), False, False),
    (64, 3, 4, (24, 24, 24), 8, (2,), False, True),
]


def _pe_case(rows, C, n_freqs, hidden, out, skips, window):
    rng = np.random.default_rng(rows)
    x = (rng.uniform(-1, 1, (rows, C)) * 0.8).astype(np.float32)
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    c_x = C * (2 * n_freqs + 1)
    weights, biases = normal_mlp((c_x,) + tuple(hidden) + (out,), skips, seed=rows)
    win = (np.linspace(0.0, 1.0, n_freqs) ** 0.5).astype(np.float32) if window else None
    g = rng.standard_normal((rows, out)).astype(np.float32)
    return x, freqs, weights, biases, win, g


@pytest.mark.parametrize("rows,C,n_freqs,hidden,out,skips,final_act,window", PE_CASES)
def test_k4f_matches_jax_pe_fwd(rows, C, n_freqs, hidden, out, skips, final_act, window):
    """The plain K4f (fourier_embed's block layout) against JAX `_pe_fwd`
    (Pallas, interpret mode) and its oracle."""
    import jax.numpy as jnp

    from lab4d_tpu.ops import mlp_kernel as J

    x, freqs, weights, biases, win, _ = _pe_case(rows, C, n_freqs, hidden, out, skips, window)
    jw, jb = _jax_lists(weights, biases)
    jwin = None if win is None else jnp.asarray(win)
    want_kernel = J._pe_fwd(jnp.asarray(x), jwin, jw, jb, freqs, tuple(skips), final_act)
    want_ref = J.pe_mlp_reference(jnp.asarray(x), jwin, jw, jb, freqs, tuple(skips), final_act)
    tw = [torch.tensor(w.T.copy()) for w in weights]
    tb = [torch.tensor(b) for b in biases]
    twin = None if win is None else torch.tensor(win)
    launches = K.fused_pe_mlp.launches
    got = K.fused_pe_mlp(torch.tensor(x), twin, tw, tb, freqs, skips, final_act).numpy()
    assert K.fused_pe_mlp.launches == launches
    np.testing.assert_array_equal(
        got, K.pe_mlp_reference(torch.tensor(x), twin, tw, tb, freqs, skips, final_act).numpy())
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(want_ref), atol=2e-4)


@pytest.mark.parametrize("rows,C,n_freqs,hidden,out,skips,final_act,window", PE_CASES)
def test_k4b_matches_jax_pe_bwd(rows, C, n_freqs, hidden, out, skips, final_act, window):
    """The plain K4b against JAX `_pe_bwd_call` (Pallas, interpret mode)
    and jax.vjp of the oracle; the autograd of fused_pe_mlp (final ReLU
    mask, no window gradient) against the JAX custom VJP."""
    import jax
    import jax.numpy as jnp

    from lab4d_tpu.ops import mlp_kernel as J

    x, freqs, weights, biases, win, g = _pe_case(rows, C, n_freqs, hidden, out, skips, window)
    jw, jb = _jax_lists(weights, biases)
    jwin = None if win is None else jnp.asarray(win)
    want_kernel = J._pe_bwd_call(jnp.asarray(x), jnp.asarray(g), jwin, jw, jb, freqs,
                                 tuple(skips))
    _, vjp = jax.vjp(lambda x_, w_, b_: J.pe_mlp_reference(x_, jwin, w_, b_, freqs,
                                                           tuple(skips)),
                     jnp.asarray(x), jw, jb)
    want_ref = vjp(jnp.asarray(g))
    tw = [torch.tensor(w.T.copy()) for w in weights]
    tb = [torch.tensor(b) for b in biases]
    twin = None if win is None else torch.tensor(win)
    launches = K.fused_pe_mlp_backward.launches
    dx, dws, dbs = K.fused_pe_mlp_backward(torch.tensor(x), torch.tensor(g), twin, tw, tb,
                                           freqs, skips)
    assert K.fused_pe_mlp_backward.launches == launches
    for want in (want_kernel, want_ref):
        assert_close_scaled(dx.numpy(), want[0], err_msg="dx")
        for i, (a, b) in enumerate(zip(dws, want[1])):
            assert_close_scaled(a.numpy().T, b, err_msg=f"dW{i}")
        for i, (a, b) in enumerate(zip(dbs, want[2])):
            assert_close_scaled(a.numpy(), np.asarray(b).reshape(-1), err_msg=f"db{i}")
    # the custom VJPs, final ReLU included
    _, vjp_k = jax.vjp(lambda x_, w_, b_: J.fused_pe_mlp(x_, jwin, w_, b_, freqs, tuple(skips),
                                                         final_act),
                       jnp.asarray(x), jw, jb)
    want = vjp_k(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    params = [t.requires_grad_(True) for t in tw + tb]
    out_t = K.fused_pe_mlp(xt, twin, params[: len(tw)], params[len(tw):], freqs, skips,
                           final_act)
    grads = torch.autograd.grad(out_t, [xt] + params, torch.tensor(g))
    assert_close_scaled(grads[0].numpy(), want[0], err_msg="dx")
    for a, b in zip(grads[1 : 1 + len(tw)], want[1]):
        assert_close_scaled(a.numpy().T, b)


@pytest.mark.parametrize(
    "c_x,widths,skips,rows,backward,want_rows",
    [
        (39, (128,) * 6, (4,), 262144, False, 64),  # base field, K4f
        (39, (128,) * 6, (4,), 262144, True, 48),  # base field, K4b
        (63, (64, 64, 1), (), 262144, True, 64),  # vis field, K4b
        (256, (256,) * 6, (), 256, True, 8),  # camera TimeMLP, K3b: short tiles, more blocks
    ],
)
def test_tile_plan(c_x, widths, skips, rows, backward, want_rows):
    """Tile heights and grids of the row-tiled kernels fit the card: shared
    memory within sm_90's 227 KB, a workspace slice per block, and a
    backward grid no larger than its tiles."""
    in_dims = [c_x] + [w + (c_x if i + 1 in skips else 0) for i, w in enumerate(widths[:-1])]
    plan = K.tile_plan(c_x, in_dims, list(widths), rows, backward, n_sm=132)
    assert plan.tile_rows == want_rows
    assert plan.smem_bytes <= K.SMEM_PER_SM
    assert plan.n_params == sum(o * (i + 1) for i, o in zip(in_dims, widths))
    ntiles = -(-rows // plan.tile_rows)
    assert plan.grid == (min(ntiles, 132 * max(1, min(2, K.SMEM_PER_SM // plan.smem_bytes)))
                         if backward else ntiles)


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


def _cuda_mlp(c_x, widths, skips, seed):
    g = torch.Generator().manual_seed(seed)
    ws, bs, prev = [], [], c_x
    for i, w in enumerate(widths):
        fan = prev + (c_x if i in skips else 0)
        ws.append(((torch.rand(w, fan, generator=g) * 2 - 1) / fan**0.5).cuda())
        bs.append(((torch.rand(w, generator=g) * 2 - 1) / fan**0.5).cuda())
        prev = w
    return ws, bs


def _assert_close_rel(got, want, rel=1e-4):
    torch.testing.assert_close(got, want, rtol=0, atol=rel * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C_in,D,W,skips", [(256, 256, 5, 256, ()), (300, 95, 5, 128, (4,))])
def test_cuda_k3b_matches_plain(rows, C_in, D, W, skips):
    """K3b against mlp_backward_reference on the card (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    ws, bs = _cuda_mlp(C_in, [W] * (D + 1), skips, seed=rows)
    x = torch.randn(rows, C_in, device="cuda")
    g = torch.randn(rows, W, device="cuda")
    launches = K.fused_relu_mlp_backward.launches
    got = K.fused_relu_mlp_backward(x, g, ws, bs, skips)
    want = K.mlp_backward_reference(x, g, ws, bs, skips)
    torch.cuda.synchronize()
    assert K.fused_relu_mlp_backward.launches == launches + 1
    _assert_close_rel(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        _assert_close_rel(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_freqs,widths,skips,final_act,window", [
    (70000, 6, (128,) * 6, (4,), True, True),  # base field
    (70000, 8, (128,) * 3, (), True, True),  # colour field
    (70000, 10, (64, 64, 1), (), False, False),  # visibility field
    (512, 10, (64, 64, 1), (), False, False),  # visibility-decay points
])
def test_cuda_k4_matches_plain(rows, n_freqs, widths, skips, final_act, window):
    """K4f and K4b against pe_mlp_reference / pe_mlp_backward_reference
    on the card (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    ws, bs = _cuda_mlp(3 * (2 * n_freqs + 1), widths, skips, seed=rows)
    x = (torch.rand(rows, 3, device="cuda") * 2 - 1) * 0.5
    win = torch.linspace(0.3, 1.0, n_freqs, device="cuda") if window else None
    counts = (K.fused_pe_mlp.launches, K.fused_pe_mlp_backward.launches)
    y = K.fused_pe_mlp(x, win, ws, bs, freqs, skips, final_act)
    torch.testing.assert_close(y, K.pe_mlp_reference(x, win, ws, bs, freqs, skips, final_act),
                               atol=1e-4, rtol=0)
    g = torch.randn_like(y)
    got = K.fused_pe_mlp_backward(x, g, win, ws, bs, freqs, skips)
    want = K.pe_mlp_backward_reference(x, g, win, ws, bs, freqs, skips)
    torch.cuda.synchronize()
    assert (K.fused_pe_mlp.launches, K.fused_pe_mlp_backward.launches) == (counts[0] + 1,
                                                                          counts[1] + 1)
    _assert_close_rel(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        _assert_close_rel(a, b)
