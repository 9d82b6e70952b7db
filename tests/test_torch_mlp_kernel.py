"""K3 and K4, the fused MLPs: the port's kernels' wrappers against the
JAX package's Pallas kernels (interpret mode on the CPU, as
tests/test_mlp_kernel.py runs them) and its jnp oracles.

- K3f (fused_relu_mlp forward) at that file's cases and the render
  path's shapes;
- K3b (fused_relu_mlp_backward) against JAX `_bwd` and jax.vjp of the
  oracle, and the autograd of fused_relu_mlp (final ReLU mask included)
  against the JAX custom VJP; their saved-output plain versions
  (mlp_forward_saved_reference, whose hidden layer outputs K3f saves, and
  mlp_backward_saved_reference, K3b's dataflow from them) against the
  Pallas kernels, the autograd wiring that hands K3f's saved outputs to
  K3b, K3f / K3b's launch plan, and K3's 3xTF32 arithmetic against fp64;
- K4f / K4b (fused_pe_mlp and its backward) against JAX `_pe_fwd` /
  `_pe_bwd_call` and the oracle, with and without skip, final ReLU and
  annealing window, at the bg field's widths; also their saved-output
  plain versions (pe_mlp_forward_saved_reference, which returns the hidden
  layer outputs K4f saves, and pe_mlp_backward_saved_reference, K4b's
  dataflow from them), the autograd wiring that hands K4f's saved outputs
  to K4b, K4f / K4b's launch plan, and a CPU emulation of their 3xTF32
  arithmetic against fp64 at the three widths of the bg field.

On the CPU the port's wrappers take their plain versions; the CUDA
kernels themselves are compared with those by the `cuda`-marked tests,
which need a card and run there without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_mlp_kernel.py

Tolerance: fp32 with sums in another order. The cases of
tests/test_mlp_kernel.py use N(0, 1/fan_in) weights and O(1) outputs,
where that file's own kernel-vs-oracle bound is atol 2e-4; gradients,
which sum over the rows, are held to 2e-4 of each array's largest entry.
The render shapes use torch's default init and O(0.1) outputs, compared
at 1e-5. On the card the kernels (fp32 FMA for K3, 3xTF32 tensor-core
products with fp32 sums for K4) meet cuBLAS's fp32 at 1e-4 of each
array's largest entry (forward outputs at atol 1e-4).
"""

import ctypes

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


# (rows, dims, skips, final_act): the TimeMLP backbones' D5 W256 at the
# training step's 256 rows, D2 W64, a skip layer, final ReLU on and off,
# a ragged row count
K3_SAVED_CASES = [
    (256, (256,) * 7, (), True),
    (256, (64,) * 4, (), True),
    (300, (95, 128, 128, 128, 128, 128, 64), (4,), False),
    (37, (48, 64, 64, 16), (2,), True),
    (1001, (32, 64, 64, 8), (), False),
]


def _k3_saved_case(P, dims, skips):
    rng = np.random.default_rng(P + len(dims))
    x = rng.standard_normal((P, dims[0])).astype(np.float32)
    g = rng.standard_normal((P, dims[-1])).astype(np.float32)
    weights, biases = normal_mlp(dims, skips, seed=P)
    return x, g, weights, biases


@pytest.mark.parametrize("P,dims,skips,final_act", K3_SAVED_CASES)
def test_k3f_saved_matches_jax_fwd(P, dims, skips, final_act):
    """mlp_forward_saved_reference, the plain K3f with the hidden outputs it
    saves: its output is mlp_reference's and JAX `_fwd`'s (Pallas,
    interpret mode) and its oracle's; its saved blocks (pe_act_layout) are
    the hidden layers' ReLU outputs, which rebuild the output through the
    last layer; with pre_activations, the ReLU inputs that give them."""
    import jax.numpy as jnp

    from lab4d_tpu.ops import mlp_kernel as J

    x, _, weights, biases = _k3_saved_case(P, dims, skips)
    jw, jb = _jax_lists(weights, biases)
    want_kernel = J._fwd(jnp.asarray(x), jw, jb, tuple(skips), final_act)
    want_ref = J.mlp_reference(jnp.asarray(x), jw, jb, tuple(skips), final_act)
    tw = [torch.tensor(w.T.copy()) for w in weights]
    tb = [torch.tensor(b) for b in biases]
    tx = torch.tensor(x)
    got, acts = K.mlp_forward_saved_reference(tx, tw, tb, skips, final_act)
    np.testing.assert_array_equal(got.numpy(), K.mlp_reference(tx, tw, tb, skips, final_act).numpy())
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    offs, per_row = K.pe_act_layout(tw)
    assert per_row == sum(dims[1:-1]) and acts.shape == (P * per_row,)
    assert (acts >= 0).all()
    last_in = acts[offs[-1] * P:].view(P, dims[-2])
    if len(tw) - 1 in skips:
        last_in = torch.cat([tx, last_in], dim=-1)
    rebuilt = torch.nn.functional.linear(last_in, tw[-1], tb[-1])
    np.testing.assert_allclose(got.numpy(), (torch.relu(rebuilt) if final_act else rebuilt).numpy(),
                               rtol=0, atol=1e-5)
    _, z = K.mlp_forward_saved_reference(tx, tw, tb, skips, final_act, pre_activations=True)
    torch.testing.assert_close(torch.relu(z), acts, rtol=0, atol=0)
    assert (z < 0).any()


@pytest.mark.parametrize("P,dims,skips,final_act", K3_SAVED_CASES)
def test_k3b_saved_matches_jax_bwd(P, dims, skips, final_act):
    """mlp_backward_saved_reference, the plain K3b from K3f's saved hidden
    outputs, against JAX `_bwd` (Pallas, interpret mode) and jax.vjp of
    the oracle, at the tolerances of test_k3b_matches_jax_bwd; through
    fused_relu_mlp_backward with saved= on the CPU; with final_act, the
    Function's gradients (the final ReLU's mask, then the saved-output
    backward) against the JAX custom VJP."""
    import jax
    import jax.numpy as jnp

    from lab4d_tpu.ops import mlp_kernel as J

    x, g, weights, biases = _k3_saved_case(P, dims, skips)
    jw, jb = _jax_lists(weights, biases)
    want_kernel = J._bwd(jnp.asarray(x), jnp.asarray(g), jw, jb, tuple(skips))
    _, vjp = jax.vjp(lambda x_, w_, b_: J.mlp_reference(x_, w_, b_, tuple(skips)),
                     jnp.asarray(x), jw, jb)
    want_ref = vjp(jnp.asarray(g))
    tw = [torch.tensor(w.T.copy()) for w in weights]
    tb = [torch.tensor(b) for b in biases]
    tx, tg = torch.tensor(x), torch.tensor(g)
    _, acts = K.mlp_forward_saved_reference(tx, tw, tb, skips, final_act)
    launches = K.fused_relu_mlp_backward.launches
    dx, dws, dbs = K.fused_relu_mlp_backward(tx, tg, tw, tb, skips, saved=acts)
    assert K.fused_relu_mlp_backward.launches == launches  # a CPU tensor never launches
    plain = K.mlp_backward_saved_reference(tx, tg, tw, tb, skips, acts)
    for a, b in zip([dx] + dws + dbs, [plain[0]] + plain[1] + plain[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
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
        xt = tx.clone().requires_grad_(True)
        params = [t.clone().requires_grad_(True) for t in tw + tb]
        out = K._FusedReluMLP.apply(xt, tuple(skips), True, True, *params)
        grads = torch.autograd.grad(out, [xt] + params, tg)
        assert_close_scaled(grads[0].numpy(), want[0], err_msg="dx")
        for a, b in zip(grads[1: 1 + len(tw)], want[1]):
            assert_close_scaled(a.numpy().T, b)
        for a, b in zip(grads[1 + len(tw):], want[2]):
            assert_close_scaled(a.numpy(), np.asarray(b).reshape(-1))


def test_k3_autograd_backward_receives_the_saved_outputs(monkeypatch):
    """_FusedReluMLP on CPU tensors runs the plain versions of K3f / K3b's
    dataflow: with save it keeps the hidden outputs, its backward gets
    exactly those (with the final ReLU's mask on g) and follows them when
    they are changed between the forward and the backward; without save
    (an eval call) it keeps none, and a backward then raises."""
    P, dims, skips, _ = K3_SAVED_CASES[3]
    x, g, weights, biases = _k3_saved_case(P, dims, skips)
    tw = [torch.tensor(w.T.copy()).requires_grad_() for w in weights]
    tb = [torch.tensor(b).requires_grad_() for b in biases]
    xt = torch.tensor(x).requires_grad_()
    tg = torch.tensor(g)
    seen = {}
    fwd, bwd = K.mlp_forward_saved_reference, K.mlp_backward_saved_reference

    def fwd_spy(*a, **k):
        seen["fwd"] = fwd(*a, **k)
        return seen["fwd"]

    def bwd_spy(*a):
        seen["bwd"] = a
        return bwd(*a)

    monkeypatch.setattr(K, "mlp_forward_saved_reference", fwd_spy)
    monkeypatch.setattr(K, "mlp_backward_saved_reference", bwd_spy)
    y = K._FusedReluMLP.apply(xt, skips, True, True, *tw, *tb)
    out, acts = seen["fwd"]
    grads = torch.autograd.grad(y, [xt] + tw + tb, tg)
    assert seen["bwd"][-1].data_ptr() == acts.data_ptr()
    torch.testing.assert_close(seen["bwd"][1], tg * (out > 0), rtol=0, atol=0)
    want = K.mlp_backward_reference(torch.tensor(x), tg * (out > 0).float(),
                                    [t.detach() for t in tw], [t.detach() for t in tb], skips)
    for a, b in zip(grads, [want[0]] + want[1] + want[2]):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))
    # the backward reads the saved outputs, not a recomputed forward: a
    # forward that hands over other ones gives their gradients
    def tamper_spy(*a, **k):
        out_, acts_ = fwd(*a, **k)
        seen["tampered"] = acts_ * 2.0
        return out_, seen["tampered"]

    monkeypatch.setattr(K, "mlp_forward_saved_reference", tamper_spy)
    tampered = torch.autograd.grad(K._FusedReluMLP.apply(xt, skips, True, True, *tw, *tb),
                                   [xt] + tw + tb, tg)
    want_t = bwd(xt.detach(), tg * (out > 0), [t.detach() for t in tw], [t.detach() for t in tb],
                 skips, seen["tampered"])
    for a, b in zip(tampered, [want_t[0]] + want_t[1] + want_t[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.equal(a, b) for a, b in zip(tampered, grads))
    monkeypatch.setattr(K, "mlp_forward_saved_reference", fwd_spy)
    seen.clear()
    with torch.no_grad():
        y2 = K._FusedReluMLP.apply(xt, skips, True, K.needs_saved(xt, *tw, *tb), *tw, *tb)
    assert "fwd" not in seen
    torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)
    y3 = K._FusedReluMLP.apply(xt, skips, True, False, *tw, *tb)
    with pytest.raises(RuntimeError, match="without saving"):
        torch.autograd.grad(y3.sum(), xt)


def test_needs_saved_for_a_time_mlp():
    """K3f saves its layer outputs only when autograd may call K3b: for a
    TimeMLP backbone's inputs and parameters, needs_saved is True in grad
    mode, False under torch.no_grad() and for a frozen model
    (requires_grad_(False)), as a render runs it."""
    from lab4d_tpu_torch.nnutils.base import BaseMLP

    mlp = BaseMLP(64, D=2, W=64, out_channels=64, skips=(), final_act=True,
                  generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 64)
    params = list(mlp.parameters())
    assert K.needs_saved(x, *params)
    with torch.no_grad():
        assert not K.needs_saved(x, *params)
    mlp.requires_grad_(False)
    assert not K.needs_saved(x, *params)


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


@pytest.mark.parametrize("rows,C,n_freqs,hidden,out,skips,final_act,window", PE_CASES)
def test_k4f_saved_matches_jax_pe_fwd(rows, C, n_freqs, hidden, out, skips, final_act, window):
    """pe_mlp_forward_saved_reference, the plain K4f with the hidden outputs
    it saves: its output is pe_mlp_reference's and JAX `_pe_fwd`'s (Pallas,
    interpret mode), and its saved blocks (pe_act_layout) are the hidden
    layers' ReLU outputs, which rebuild the output through the last layer;
    with pre_activations, the ReLU inputs that give them."""
    import jax.numpy as jnp

    from lab4d_tpu.ops import mlp_kernel as J

    x, freqs, weights, biases, win, _ = _pe_case(rows, C, n_freqs, hidden, out, skips, window)
    jw, jb = _jax_lists(weights, biases)
    jwin = None if win is None else jnp.asarray(win)
    want = J._pe_fwd(jnp.asarray(x), jwin, jw, jb, freqs, tuple(skips), final_act)
    tw = [torch.tensor(w.T.copy()) for w in weights]
    tb = [torch.tensor(b) for b in biases]
    twin = None if win is None else torch.tensor(win)
    tx = torch.tensor(x)
    got, acts = K.pe_mlp_forward_saved_reference(tx, twin, tw, tb, freqs, skips, final_act)
    np.testing.assert_array_equal(
        got.numpy(), K.pe_mlp_reference(tx, twin, tw, tb, freqs, skips, final_act).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    offs, per_point = K.pe_act_layout(tw)
    assert per_point == sum(hidden) and acts.shape == (rows * per_point,)
    assert offs == [sum(hidden[:i]) for i in range(len(hidden))]
    h_last = acts[offs[-1] * rows:].view(rows, hidden[-1])
    assert (acts >= 0).all()
    last_in = h_last
    if len(tw) - 1 in skips:
        from lab4d_tpu_torch.nnutils.embedding import fourier_embed

        last_in = torch.cat([fourier_embed(tx, freqs, twin), h_last], dim=-1)
    rebuilt = torch.nn.functional.linear(last_in, tw[-1], tb[-1])
    np.testing.assert_allclose(got.numpy(), (torch.relu(rebuilt) if final_act else rebuilt).numpy(),
                               rtol=0, atol=1e-6)
    _, z = K.pe_mlp_forward_saved_reference(tx, twin, tw, tb, freqs, skips, final_act,
                                            pre_activations=True)
    torch.testing.assert_close(torch.relu(z), acts, rtol=0, atol=0)
    assert (z < 0).any()


@pytest.mark.parametrize("rows,C,n_freqs,hidden,out,skips,final_act,window", PE_CASES)
def test_k4b_saved_matches_jax_pe_bwd(rows, C, n_freqs, hidden, out, skips, final_act, window):
    """pe_mlp_backward_saved_reference, the plain K4b from the saved hidden
    outputs, against JAX `_pe_bwd_call` (Pallas, interpret mode) and jax.vjp
    of the oracle; through the plain versions of fused_pe_mlp_backward with
    saved= on the CPU."""
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
    tx, tg = torch.tensor(x), torch.tensor(g)
    _, acts = K.pe_mlp_forward_saved_reference(tx, twin, tw, tb, freqs, skips, final_act)
    launches = K.fused_pe_mlp_backward.launches
    dx, dws, dbs = K.fused_pe_mlp_backward(tx, tg, twin, tw, tb, freqs, skips, saved=acts)
    assert K.fused_pe_mlp_backward.launches == launches
    plain = K.pe_mlp_backward_saved_reference(tx, tg, twin, tw, tb, freqs, skips, acts)
    for a, b in zip([dx] + dws + dbs, [plain[0]] + plain[1] + plain[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for want in (want_kernel, want_ref):
        assert_close_scaled(dx.numpy(), want[0], err_msg="dx")
        for i, (a, b) in enumerate(zip(dws, want[1])):
            assert_close_scaled(a.numpy().T, b, err_msg=f"dW{i}")
        for i, (a, b) in enumerate(zip(dbs, want[2])):
            assert_close_scaled(a.numpy(), np.asarray(b).reshape(-1), err_msg=f"db{i}")


# the bg field's three MLPs (chip_smoke.K4_SHAPES): (n_freqs, widths, skips, final_act)
K4_WIDTHS = {
    "base": (6, (128,) * 6, (4,), True),
    "colour": (8, (128,) * 3, (), True),
    "vis": (10, (64, 64, 1), (), False),
}


def _tf32(t):
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernels compute it: each operand split into TF32 hi and
    lo, hi.hi + hi.lo + lo.hi with fp32 sums (csrc/heads_mma.cuh)."""
    a, b = a.contiguous(), b.contiguous()
    ah, bh = _tf32(a), _tf32(b)
    return ah @ bh + (_tf32(a - ah) @ bh + ah @ _tf32(b - bh))


def _kernel_dataflow(x, g, window, weights, biases, freqs, skips, final_act, mm, mm_dw=None,
                     masks=None):
    """K4f then K4b from its saved outputs (K3f then K3b without
    frequencies), with every product of the layers and dIn through mm, and
    dW through mm_dw (by default mm): (out, dx, dWs, dbs, masks), dtype of
    x; masks: each ReLU's (input > 0), or, given, the ReLUs take these
    instead (another run's, so that both compare outside the ReLU ties)."""
    mm_dw = mm_dw or mm
    from lab4d_tpu_torch.nnutils.embedding import fourier_embed

    xl = x.detach().requires_grad_(True)
    with torch.enable_grad():
        X = fourier_embed(xl, freqs, window) if freqs else xl * 1.0
    Xd = X.detach()
    h, hs = Xd, []
    n = len(weights)
    masks = list(masks) if masks is not None else [None] * n
    for i in range(n):
        if i in skips:
            h = torch.cat([Xd, h], dim=-1)
        h = mm(h, weights[i].T) + biases[i]
        if i < n - 1 or final_act:
            if masks[i] is None:
                masks[i] = h > 0
            h = h * masks[i]
        hs.append(h)
    out = h
    gcur = g * masks[n - 1] if final_act else g
    dX = torch.zeros_like(Xd)
    dws, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        hprev = hs[i - 1] if i > 0 else None
        A = Xd if i == 0 else (torch.cat([Xd, hprev], dim=-1) if i in skips else hprev)
        dws[i] = mm_dw(gcur.T, A)
        dbs[i] = gcur.sum(0)
        din = mm(gcur, weights[i])
        if i == 0 or i in skips:
            dX = dX + din[:, : Xd.shape[1]]
            din = din[:, Xd.shape[1]:]
        if i > 0:
            gcur = din * masks[i - 1]
    dx = torch.autograd.grad(X, xl, dX)[0]
    return out, dx, dws, dbs, masks


def _trunc32(t):
    """float64 to float32, rounded toward zero."""
    f = t.float()
    return torch.where(f.double().abs() > t.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _tf32_rz(t):
    """fp32 cut to TF32 (its low 13 mantissa bits cleared)."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_wgmma_3xtf32(chunk):
    """a @ b as K3's row engine computes it (csrc/fused_relu_mlp.cu, rw_*):
    each operand split as rw_split does (hi = the operand cut to TF32, lo =
    the rest, which the tensor core is taken to cut to TF32 too); per chunk
    of `chunk` along the reduction (a weight slab of 16, a G slab of 32 rows
    for dW), each k8 step's three products (lo.hi, hi.lo, hi.hi) added in
    turn to a partial sum that starts from zero, every such sum cut to fp32
    toward zero (a pessimistic model of wgmma's accumulation in the tensor
    core); each chunk's partial then added to the fp32 result, rounded to
    nearest."""
    def mm(a, b):
        a, b = a.contiguous(), b.contiguous()
        ah, bh = _tf32_rz(a), _tf32_rz(b)
        al, bl = _tf32_rz(a - ah), _tf32_rz(b - bh)
        K = a.shape[1]
        out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
        for k0 in range(0, K, chunk):
            t = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
            for k in range(k0, min(K, k0 + chunk), 8):
                ks = slice(k, min(K, k + 8))
                for u, v in ((al, bh), (ah, bl), (ah, bh)):
                    t = _trunc32(t + u[:, ks].double() @ v[ks].double()).double()
            out = out + t.float()
        return out
    return mm


# K3 at the TimeMLP backbones' widths (C_in, widths, skips, final_act)
K3_WIDTHS = {
    "k3-D5W256": (256, (256,) * 6, (), True),
    "k3-D2W64": (64, (64,) * 3, (), True),
}
# and at the warps' CondMLPs on the row engine: PE(xyz) + time code, 3
# outputs without a final ReLU (chip_smoke.K3_WARP_SHAPES)
K3_ROWS_WIDTHS = {
    "k3-dense-D6W256-skip4": (167, (256,) * 6 + (3,), (4,), False),
    "k3-postwarp-D2W256": (167, (256,) * 2 + (3,), (), False),
}


@pytest.mark.parametrize("field", list(K4_WIDTHS) + list(K3_WIDTHS) + list(K3_ROWS_WIDTHS))
def test_3xtf32_error_budget(field):
    """K4f / K4b's arithmetic emulated on the CPU at each bg field MLP's
    widths and frequency ladder (1,024 points, live window), and K3f /
    K3b's at the TimeMLP backbones' D5 W256 and D2 W64 (256 rows, no
    embedding): every product of the forward, dW and dIn in 3xTF32 with
    fp32 sums stays within chip_smoke.KERNEL_TOL (1e-4) of fp64: the
    output's max abs error, and each gradient's max error over its largest
    entry. At the warps' dense map and post-warp (2,048 rows) the products
    follow the row engine's order instead (_mm_wgmma_3xtf32: in-core sums
    of 16-deep weight slabs and of 32-row G slabs for dW, cut toward zero,
    then fp32), and so do K4's (its wgmma engine: in-core sums of 32-deep
    weight slabs; dW's 32-row G slabs as K3's). The ReLU masks are the fp64
    run's, as a comparison outside ReLU ties takes them."""
    rng = np.random.default_rng(7)
    mm, mm_dw = _mm_3xtf32, None
    if field in K3_ROWS_WIDTHS:
        C, widths, skips, final_act = K3_ROWS_WIDTHS[field]
        n_freqs, rows, c_x = 0, 2048, C
        mm, mm_dw = _mm_wgmma_3xtf32(16), _mm_wgmma_3xtf32(32)
    elif field in K3_WIDTHS:
        C, widths, skips, final_act = K3_WIDTHS[field]
        n_freqs, rows, c_x = 0, 256, C
    else:
        n_freqs, widths, skips, final_act = K4_WIDTHS[field]
        rows, C = 1024, 3
        c_x = C * (2 * n_freqs + 1)
        mm, mm_dw = _mm_wgmma_3xtf32(32), _mm_wgmma_3xtf32(32)
    weights, biases, prev = [], [], c_x
    for i, w in enumerate(widths):
        fan = prev + (c_x if i in skips else 0)
        weights.append(torch.tensor(rng.uniform(-1, 1, (w, fan)) / np.sqrt(fan), dtype=torch.float32))
        biases.append(torch.tensor(rng.uniform(-1, 1, w) / np.sqrt(fan), dtype=torch.float32))
        prev = w
    x = torch.tensor(rng.uniform(-0.5, 0.5, (rows, C)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((rows, widths[-1])), dtype=torch.float32)
    win = torch.linspace(0.3, 1.0, n_freqs)
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    ref = _kernel_dataflow(x.double(), g.double(), win.double(), [w.double() for w in weights],
                           [b.double() for b in biases], freqs, skips, final_act, torch.matmul)
    threads = torch.get_num_threads()
    if field in K4_WIDTHS:  # many small products: one thread, beside other test processes
        torch.set_num_threads(1)
    try:
        got = _kernel_dataflow(x, g, win, weights, biases, freqs, skips, final_act, mm, mm_dw,
                               masks=ref[4])
    finally:
        torch.set_num_threads(threads)
    fwd = float((got[0].double() - ref[0]).abs().max())
    bwd = max(float((a.double() - r).abs().max()) / max(1.0, float(r.abs().max()))
              for a, r in zip([got[1]] + got[2] + got[3], [ref[1]] + ref[2] + ref[3]))
    one = _kernel_dataflow(x, g, win, weights, biases, freqs, skips, final_act,
                           lambda a, b: _tf32(a.contiguous()) @ _tf32(b.contiguous()),
                           masks=ref[4])
    fwd1 = float((one[0].double() - ref[0]).abs().max())
    print(f"{field}: 3xTF32 forward {fwd:.2e}, backward {bwd:.2e}; 1xTF32 forward {fwd1:.2e}")
    assert fwd <= 1e-4 and bwd <= 1e-4, (fwd, bwd)
    assert fwd1 > fwd  # the emulation does round


# (C_in, widths, skips, rows, want): want = (K3f on its FMA tile, dW
# chunks, K3b's launches, engine)
K3_PLAN_CASES = [
    (256, (256,) * 6, (), 1, (True, 1, 2, "cluster")),  # a render's camera query
    (256, (256,) * 6, (), 7, (True, 1, 2, "cluster")),
    (256, (256,) * 6, (), 9, (False, 1, 2, "cluster")),  # past 8 rows: 3xTF32 on 32-row tiles
    (256, (256,) * 6, (), 32, (False, 1, 2, "cluster")),  # the camera over a scene's frames
    (256, (256,) * 6, (), 128, (False, 1, 2, "cluster")),  # the category camera's frames
    (256, (256,) * 6, (), 256, (False, 1, 2, "cluster")),  # the training step's TimeMLPs
    (256, (256,) * 6, (), 512, (False, 1, 2, "cluster")),  # the articulation's t + rest
    (64, (64,) * 3, (), 256, (False, 1, 2, "cluster")),  # appearance
    (95, (128,) * 6, (4,), 300, (False, 1, 2, "cluster")),  # a skip layer
    (256, (256,) * 6, (), 70001, (False, 22, 4, "rows")),  # many rows: the row engine
    (256, (256,) * 7, (), 262144, (False, 19, 4, "rows")),  # D6 W256
    (167, (256,) * 6 + (3,), (4,), 262144, (False, 18, 4, "rows")),  # the dense warp's maps
    (167, (256,) * 2 + (3,), (), 262144, (False, 53, 4, "rows")),  # the post-warp
    (167, (256,) * 6 + (3,), (4,), 262143, (False, 18, 4, "rows")),  # ragged
    (167, (256,) * 2 + (3,), (), 1024, (False, 1, 3, "rows")),  # the crossover, 1,024 rows
    (167, (256,) * 2 + (3,), (), 512, (False, 1, 2, "cluster")),  # below it
    (512, (256,) * 6, (), 70001, (False, 5, 3, "cluster")),  # x wider than the row engine takes
]


def _k3_in_dims(c_x, widths, skips):
    return [c_x] + [w + (c_x if i + 1 in skips else 0) for i, w in enumerate(widths[:-1])]


@pytest.mark.parametrize("c_x,widths,skips,rows,want", K3_PLAN_CASES)
def test_relu_mlp_plan(c_x, widths, skips, rows, want):
    """K3f / K3b's row-count decisions: the cluster engine up to
    K3_ROWS_MIN rows (K3f's fp32 FMA tile of 8 rows up to 8 rows, else
    3xTF32 on 32-row tiles for both; one chunk of rows for dW up to 1,024
    rows, dW straight into the gradient, 2 launches), the row engine from
    there on where x and every layer are at most 256 wide (K3f: the split
    of the weights and the engine, 2 launches; K3b: the split, dIn, dW
    and the chunks' reduction, 4 launches), else chunks of whole 32-row
    slabs that cover the rows, at most 512, and a reduction launch; the
    gradients', saved outputs' and scratch floats; one plan per shape, made
    once. (test_cuda_k3_plan holds the library's layouts against these.)"""
    in_dims = _k3_in_dims(c_x, widths, skips)
    plan = K.relu_mlp_plan(c_x, in_dims, list(widths), rows)
    assert (plan.fwd_fma, plan.n_chunks, plan.bwd_launches, plan.engine) == want
    assert plan.chunk_rows % 32 == 0 and plan.n_chunks <= 512
    assert (plan.n_chunks - 1) * plan.chunk_rows < rows <= plan.n_chunks * plan.chunk_rows
    n_params = sum(o * (i + 1) for i, o in zip(in_dims, widths))
    assert plan.n_params == n_params and plan.act_floats == sum(widths[:-1])
    ws = [torch.zeros(o, i) for i, o in zip(in_dims, widths)]
    assert K.pe_act_layout(ws)[1] == plan.act_floats
    ws_floats = plan.n_chunks * n_params if plan.n_chunks > 1 else 0
    if plan.engine == "rows":
        pk, pt, gimg, _ = K.rows_engine_layout(c_x, in_dims, widths, rows)
        assert (plan.pack_floats, plan.fwd_launches) == (pk, 2)
        assert plan.scratch_floats == pt + gimg + ws_floats
    else:
        assert (plan.pack_floats, plan.fwd_launches) == (0, 1)
        assert plan.scratch_floats == rows * plan.act_floats + ws_floats
    assert K.relu_mlp_plan(c_x, tuple(in_dims), widths, rows) is plan


@pytest.mark.parametrize("widths,skips", [((256,) * 6 + (3,), (4,)), ((256,) * 2 + (3,), ())])
def test_relu_mlp_plan_crossover(widths, skips):
    """The engine changes at K3_ROWS_MIN rows (the measured crossover) and
    can be forced either way (the profilers' sweep); the row engine refuses
    layers wider than 256."""
    in_dims = _k3_in_dims(167, widths, skips)
    n = K.K3_ROWS_MIN
    assert K.relu_mlp_plan(167, in_dims, widths, n - 1).engine == "cluster"
    assert K.relu_mlp_plan(167, in_dims, widths, n).engine == "rows"
    assert K.relu_mlp_plan(167, in_dims, widths, 1, engine="rows").engine == "rows"
    assert K.relu_mlp_plan(167, in_dims, widths, 262144, engine="cluster").engine == "cluster"
    with pytest.raises(ValueError, match="at most 256"):
        K.relu_mlp_plan(167, [167, 512], [512, 3], 262144, engine="rows")


def test_rows_engine_layout():
    """The row engine's buffers for the post-warp (167 -> 256 -> 256 -> 3)
    at 100 rows, counted by hand. K3f's split weights, per layer passes x
    16-deep slabs x 64 nw floats (hi and lo of 2 nw columns): 1 x 11 x 8,192
    + 1 x 16 x 8,192 + 1 x 16 x 512 (the 3 outputs on n8). K3b's, over the
    input columns: layer 2 one h pass of 1 slab (3 outputs padded to 16),
    layer 1 one of 16 slabs, layer 0 one x pass of 16 slabs, each 8,192. G's
    slabs for dW: 128 rows (two 64-row tiles) = 4 slabs of 32 rows, of 2 x
    32 x 128 floats per 128 outputs (two for 256, one n8 of 2 x 32 x 8 for
    3). dW blocks: 2 x 2 + 2 x 2 + 2 x 1 (128 inputs x an output slab)."""
    pk, pt, gimg, tiles = K.rows_engine_layout(167, [167, 256, 256], [256, 256, 3], 100)
    assert pk == 11 * 8192 + 16 * 8192 + 16 * 512
    assert pt == 1 * 8192 + 16 * 8192 + 16 * 8192
    assert gimg == 4 * (2 * 8192 + 2 * 8192 + 512)
    assert tiles == 10


def test_relu_mlp_plan_rejects_wide_layers():
    """K3f / K3b take layers of at most 512 inputs and outputs (64 columns
    of each of a cluster's 8 blocks); wider ones raise. (Where the buffers
    of narrower layers do not fit in shared memory, the library refuses
    the launch: test_cuda_k3_plan.)"""
    with pytest.raises(ValueError, match="at most 512"):
        K.relu_mlp_plan(256, [256, 640], [640, 8], 16)
    with pytest.raises(ValueError, match="at most 512"):
        K.relu_mlp_plan(256, [640, 256], [256, 8], 16)
    K.relu_mlp_plan(256, [256, 512], [512, 8], 16)


def _torch_mlp(c_x, widths, skips, seed, device="cpu"):
    """Random (out, in) weights and biases of an MLP on c_x inputs."""
    g = torch.Generator().manual_seed(seed)
    ws, bs, prev = [], [], c_x
    for i, w in enumerate(widths):
        fan = prev + (c_x if i in skips else 0)
        ws.append(((torch.rand(w, fan, generator=g) * 2 - 1) / fan**0.5).to(device))
        bs.append(((torch.rand(w, generator=g) * 2 - 1) / fan**0.5).to(device))
        prev = w
    return ws, bs


K4_PLAN_CASES = [  # (n_freqs, widths, skips, rows)
    (6, (128,) * 6, (4,), 262144),  # base field
    (6, (128,) * 6, (4,), 70000),  # base field, a ragged count
    (10, (64, 64, 1), (), 257),  # visibility field, a tail tile
]


@pytest.mark.parametrize("n_freqs,widths,skips,rows", K4_PLAN_CASES)
def test_k4_saved_layout(n_freqs, widths, skips, rows):
    """What the CPU side of K4f / K4b owns at the bg field's widths: the
    widths pass the kernels' limit, and pe_act_layout places every hidden
    output (not the last layer's) one after another, the blocks that
    pe_mlp_forward_saved_reference fills, each the layer's ReLU output."""
    c_x = 3 * (2 * n_freqs + 1)
    K.check_pe_widths(c_x, widths)
    ws, bs = _torch_mlp(c_x, widths, skips, seed=rows)
    offs, total = K.pe_act_layout(ws)
    assert offs == [sum(widths[:i]) for i in range(len(widths) - 1)]
    assert total == sum(widths[:-1])
    n = 37  # a few of the rows
    x = torch.rand(n, 3, generator=torch.Generator().manual_seed(rows)) - 0.5
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    out, acts = K.pe_mlp_forward_saved_reference(x, None, ws, bs, freqs, skips)
    assert acts.shape == (n * total,)
    X = torch.cat([x] + [torch.sin(x * f) for f in freqs] + [torch.cos(x * f) for f in freqs], -1)
    h = X
    for i, (off, w) in enumerate(zip(offs, widths[:-1])):
        if i in skips:
            h = torch.cat([X, h], -1)
        h = torch.relu(torch.nn.functional.linear(h, ws[i], bs[i]))
        torch.testing.assert_close(acts[off * n: (off + w) * n].view(n, w), h, atol=1e-5, rtol=0)
    torch.testing.assert_close(out, K.pe_mlp_reference(x, None, ws, bs, freqs, skips), atol=0, rtol=0)


def test_k4_plan_rejects_wide_layers():
    """K4f / K4b take layers and embeddings of at most 128 columns (a
    warpgroup holds every output column of its rows); wider ones raise."""
    with pytest.raises(ValueError, match="at most 128"):
        K.check_pe_widths(39, [256, 3])
    with pytest.raises(ValueError, match="at most 128"):
        K.check_pe_widths(135, [8])
    K.check_pe_widths(63, [128, 8])


def test_needs_saved():
    """fused_pe_mlp saves K4f's layer outputs only when autograd may call
    its backward: grad mode on and an input that requires a gradient."""
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert K.needs_saved(a, b) and not K.needs_saved(a, None)
    with torch.no_grad():
        assert not K.needs_saved(a, b)


def test_autograd_backward_receives_the_saved_outputs(monkeypatch):
    """_FusedPEMLP on CPU tensors runs the plain versions of K4f / K4b's
    dataflow: with save it keeps the hidden outputs and its backward gets
    exactly those, with the final ReLU's mask on g, and the gradients equal
    the plain VJP; without save (an eval call) it keeps none."""
    x, freqs, weights, biases, win, g = _pe_case(*PE_CASES[0][:6], PE_CASES[0][7])
    skips, final_act = PE_CASES[0][5], PE_CASES[0][6]
    tw = [torch.tensor(w.T.copy()).requires_grad_() for w in weights]
    tb = [torch.tensor(b).requires_grad_() for b in biases]
    twin = torch.tensor(win)
    xt = torch.tensor(x).requires_grad_()
    seen = {}
    fwd, bwd = K.pe_mlp_forward_saved_reference, K.pe_mlp_backward_saved_reference

    def fwd_spy(*a, **k):
        seen["fwd"] = fwd(*a, **k)
        return seen["fwd"]

    def bwd_spy(*a):
        seen["bwd"] = a
        return bwd(*a)

    monkeypatch.setattr(K, "pe_mlp_forward_saved_reference", fwd_spy)
    monkeypatch.setattr(K, "pe_mlp_backward_saved_reference", bwd_spy)
    y = K._FusedPEMLP.apply(xt, twin, freqs, skips, final_act, True, *tw, *tb)
    tg = torch.tensor(g)
    grads = torch.autograd.grad(y, [xt] + tw + tb, tg)
    out, acts = seen["fwd"]
    assert seen["bwd"][-1].data_ptr() == acts.data_ptr()
    torch.testing.assert_close(seen["bwd"][1], tg * (out > 0), rtol=0, atol=0)
    want = K.pe_mlp_backward_reference(torch.tensor(x), tg * (out > 0).float(), twin,
                                       [t.detach() for t in tw], [t.detach() for t in tb], freqs,
                                       skips)
    for a, b in zip(grads, [want[0]] + want[1] + want[2]):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))
    seen.clear()
    with torch.no_grad():
        y2 = K._FusedPEMLP.apply(xt, twin, freqs, skips, final_act,
                                 K.needs_saved(xt, *tw, *tb), *tw, *tb)
    assert "fwd" not in seen
    torch.testing.assert_close(y2, y.detach(), rtol=0, atol=0)


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


def _cuda_mlp(c_x, widths, skips, seed):
    return _torch_mlp(c_x, widths, skips, seed, "cuda")


def _assert_close_rel(got, want, rel=1e-4):
    torch.testing.assert_close(got, want, rtol=0, atol=rel * max(1.0, float(want.abs().max())))


# (rows, C_in, widths, skips, final_act): the render and training rows of
# the TimeMLPs (camera / intrinsics / articulation D5 W256, appearance D2
# W64, final ReLU), a skip layer on both of K3f's cluster tiles (C_in 95:
# the 4-byte weight staging), K3f's FMA tile's edge (8 / 9 rows) and a
# ragged large count; then the row engine at the warps' CondMLPs (167
# inputs, 3 outputs without a final ReLU): the dense warp's maps, the
# composed warp's post-warp, and a ragged count
K3_CUDA_CASES = [(r, c, (w,) * (d + 1), s, True) for r, c, d, w, s in [
    (*shape, ()) for shape in RENDER_SHAPES] + [
    (2, 256, 5, 256, ()), (8, 256, 5, 256, ()), (9, 256, 5, 256, ()), (256, 256, 5, 256, ()),
    (256, 64, 2, 64, ()), (300, 95, 5, 128, (4,)), (5, 95, 5, 128, (4,)), (70001, 256, 5, 256, ()),
]] + [
    (262144, 167, (256,) * 6 + (3,), (4,), False),
    (262144, 167, (256,) * 2 + (3,), (), False),
    (262143, 167, (256,) * 6 + (3,), (4,), False),
]


def _k3_cuda_case(rows, C_in, widths, skips):
    ws, bs = _cuda_mlp(C_in, list(widths), skips, seed=rows + widths[0])
    x = torch.randn(rows, C_in, generator=torch.Generator().manual_seed(rows)).cuda()
    return x, ws, bs


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C_in,widths,skips,final_act", K3_CUDA_CASES)
def test_cuda_kernel_matches_plain(rows, C_in, widths, skips, final_act):
    """K3f against mlp_forward_saved_reference on the card (the cluster
    engine's fp32 FMA up to 8 rows, else 3xTF32; the row engine's wgmma
    3xTF32 from K3_ROWS_MIN rows; vs cuBLAS fp32 with TF32 off: atol 1e-4):
    its output with and without saving, and its saved hidden outputs, on
    the plan's engine; the row engine's output also against fp64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ws, bs = _k3_cuda_case(rows, C_in, widths, skips)
    launches = K.fused_relu_mlp.launches
    got = K.fused_relu_mlp(x, ws, bs, skips, final_act)  # nothing requires a gradient: no saving
    got_s, acts = K.mlp_forward_saved(x, ws, bs, skips, final_act)
    want, want_acts = K.mlp_forward_saved_reference(x, ws, bs, skips, final_act)
    torch.cuda.synchronize()
    assert K.fused_relu_mlp.launches == launches + 2
    plan = K.relu_mlp_plan(C_in, [w.shape[1] for w in ws], list(widths), rows)
    assert K.fused_relu_mlp.engine == plan.engine
    assert K.fused_relu_mlp.cuda_launches == plan.fwd_launches
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    torch.testing.assert_close(got_s, got, atol=0, rtol=0)
    torch.testing.assert_close(acts, want_acts, atol=1e-4, rtol=0)
    if plan.engine == "rows":  # the tensor core's accumulation, against fp64
        want64 = K.mlp_reference(x.double(), [w.double() for w in ws], [b.double() for b in bs],
                                 skips, final_act)
        torch.testing.assert_close(got.double(), want64, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C_in,widths,skips,final_act", K3_CUDA_CASES)
def test_cuda_k3b_matches_plain(rows, C_in, widths, skips, final_act):
    """K3b from K3f's saved outputs against mlp_backward_saved_reference on
    the same ones, on the card and the plan's engine (TF32 off in cuBLAS;
    3xTF32 within 1e-4 of each array's largest entry); two calls give
    bitwise-equal gradients (no float atomics); without saved= it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ws, bs = _k3_cuda_case(rows, C_in, widths, skips)
    _, acts = K.mlp_forward_saved(x, ws, bs, skips, final_act)
    g = torch.randn(rows, widths[-1], device="cuda")
    launches = K.fused_relu_mlp_backward.launches
    got = K.fused_relu_mlp_backward(x, g, ws, bs, skips, saved=acts)
    want = K.mlp_backward_saved_reference(x, g, ws, bs, skips, acts)
    again = K.fused_relu_mlp_backward(x, g, ws, bs, skips, saved=acts)
    torch.cuda.synchronize()
    assert K.fused_relu_mlp_backward.launches == launches + 2
    plan = K.relu_mlp_plan(C_in, [w.shape[1] for w in ws], list(widths), rows)
    assert K.fused_relu_mlp_backward.cuda_launches == plan.bwd_launches
    assert K.fused_relu_mlp_backward.engine == plan.engine
    _assert_close_rel(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        _assert_close_rel(a, b)
    for a, b in zip([got[0]] + got[1] + got[2], [again[0]] + again[1] + again[2]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="saved"):
        K.fused_relu_mlp_backward(x, g, ws, bs, skips)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C_in,widths,skips,final_act", K3_CUDA_CASES[-3:])
def test_cuda_k3_large_rows_is_deterministic(rows, C_in, widths, skips, final_act):
    """K3f + K3b on the row engine, run twice on the same inputs, give
    bitwise-equal outputs, saved outputs and gradients: every sum over
    warps, blocks and chunks of rows runs in a fixed order, without float
    atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    x, ws, bs = _k3_cuda_case(rows, C_in, widths, skips)
    g = torch.randn(rows, widths[-1], generator=torch.Generator().manual_seed(3)).cuda()
    runs = []
    for _ in range(2):
        y, acts = K.mlp_forward_saved(x, ws, bs, skips, final_act)
        dx, dws, dbs = K.fused_relu_mlp_backward(x, g, ws, bs, skips, saved=acts)
        runs.append([y, acts, dx, *dws, *dbs])
    torch.cuda.synchronize()
    assert K.fused_relu_mlp.engine == K.fused_relu_mlp_backward.engine == "rows"
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C_in,widths,skips,final_act", K3_CUDA_CASES)
def test_cuda_k3_plan(rows, C_in, widths, skips, final_act):
    """The library's layout for relu_mlp_plan's engine. The cluster engine
    (lab4d_relu_mlp_smem): K3f's and K3b's dIn shared memory (as many
    layers' weight slices in flight as fit in sm_90's 227 KB, every layer
    at render rows) for the plan's tile, and the card runs at least one
    cluster of each kernel at once. The row engine
    (lab4d_relu_mlp_rows_layout): its split weights, G slabs and dW blocks
    are rows_engine_layout's, and its blocks fit in 227 KB. Either way the
    saved floats per row and the gradients' floats are the plan's; and
    widths whose buffers do not fit are refused, at launch too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the sizes are the kernel library's")
    ws, _ = _torch_mlp(C_in, list(widths), skips, seed=0)
    in_dims, out_dims = [w.shape[1] for w in ws], list(widths)
    n = len(in_dims)
    skip_mask = sum(1 << i for i in skips)
    plan = K.relu_mlp_plan(C_in, in_dims, out_dims, rows)
    lib = K._kernel_lib("fused_relu_mlp")
    ints = lambda v: (ctypes.c_int * len(v))(*v)  # noqa: E731

    def layout(in_dims, out_dims, c_in, skip_mask, fma):
        n, sizes = len(in_dims), (ctypes.c_longlong * 6)()
        err = lib.lab4d_relu_mlp_smem(ints(in_dims), ints(out_dims), n, c_in, skip_mask, int(fma),
                                      sizes)
        return err, list(sizes)

    if plan.engine == "rows":
        sizes = (ctypes.c_longlong * 9)()
        assert lib.lab4d_relu_mlp_rows_layout(ints(in_dims), ints(out_dims), n, C_in, skip_mask,
                                              rows, sizes) == 0
        pk, pt, gimg, tiles, f_smem, b_smem, dw_smem, act, n_params = list(sizes)
        assert (pk, pt, gimg, tiles) == K.rows_engine_layout(C_in, in_dims, out_dims, rows)
        assert pk == plan.pack_floats
        assert max(f_smem, b_smem, dw_smem) <= K.SMEM_PER_SM
        assert (act, n_params) == (plan.act_floats, plan.n_params)
        wide = (ctypes.c_longlong * 9)()
        assert lib.lab4d_relu_mlp_rows_layout(ints([167, 512]), ints([512, 3]), 2, 167, 0, rows,
                                              wide) != 0
        return
    err, (f_stages, f_smem, b_stages, b_smem, act, n_params) = layout(
        in_dims, out_dims, C_in, skip_mask, plan.fwd_fma)
    assert err == 0
    assert (act, n_params) == (plan.act_floats, plan.n_params)
    assert 1 <= f_stages <= n and 1 <= b_stages <= n
    assert max(f_smem, b_smem) <= K.SMEM_PER_SM
    if plan.fwd_fma and widths[0] == 256:
        assert f_stages == n  # a render's query: every layer's weights in flight at launch
    assert lib.lab4d_relu_mlp_max_clusters(0 if plan.fwd_fma else 1, f_smem) >= 1
    assert lib.lab4d_relu_mlp_max_clusters(2, b_smem) >= 1
    assert layout([256, 512], [512, 8], 256, 0, False)[0] != 0
    wide, wide_b = _torch_mlp(256, [512, 8], (), seed=1, device="cuda")
    with pytest.raises(RuntimeError, match="relu_mlp_fwd"):
        K.fused_relu_mlp(torch.zeros(16, 256, device="cuda"), wide, wide_b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_freqs,widths,skips,final_act,window", [
    (70000, 6, (128,) * 6, (4,), True, True),  # base field
    (70000, 8, (128,) * 3, (), True, True),  # colour field
    (70000, 10, (64, 64, 1), (), False, False),  # visibility field
    (512, 10, (64, 64, 1), (), False, False),  # visibility-decay points
    (2048, 10, (128,) * 6, (4,), True, True),  # the category step's gauss-skin points
    (262143, 6, (128,) * 6, (4,), True, True),  # base field, ragged: a partial tile and dW slab
    (3000, 6, (64, 64, 64, 64, 8), (2, 3), False, True),  # two skip layers: dX added to
    (1000, 10, (128, 128, 8), (), True, True),  # a tail tile of 1,000 - 896 points
    (77, 2, (30, 50, 3), (1,), False, True),  # widths that dW copies padded, 77 rows
    (1, 1, (16, 4), (), True, False),  # one point
    (300, 4, (48, 1), (), True, True),  # one output folded into the layer before, with its ReLU
])
def test_cuda_k4_matches_plain(rows, n_freqs, widths, skips, final_act, window):
    """K4f against pe_mlp_forward_saved_reference (its output and its saved
    hidden outputs) and K4b, from those saved outputs, against
    pe_mlp_backward_saved_reference on the card (TF32 off in cuBLAS; the
    kernels' 3xTF32 within 1e-4). K4b without saved= raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    ws, bs = _cuda_mlp(3 * (2 * n_freqs + 1), widths, skips, seed=rows)
    x = (torch.rand(rows, 3, device="cuda") * 2 - 1) * 0.5
    win = torch.linspace(0.3, 1.0, n_freqs, device="cuda") if window else None
    counts = (K.fused_pe_mlp.launches, K.fused_pe_mlp_backward.launches)
    y, acts = K.pe_mlp_forward_saved(x, win, ws, bs, freqs, skips, final_act)
    want_y, want_acts = K.pe_mlp_forward_saved_reference(x, win, ws, bs, freqs, skips, final_act)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=0)
    torch.testing.assert_close(acts, want_acts, atol=1e-4, rtol=0)
    g = torch.randn_like(y)
    got = K.fused_pe_mlp_backward(x, g, win, ws, bs, freqs, skips, saved=acts)
    want = K.pe_mlp_backward_saved_reference(x, g, win, ws, bs, freqs, skips, acts)
    torch.cuda.synchronize()
    assert (K.fused_pe_mlp.launches, K.fused_pe_mlp_backward.launches) == (counts[0] + 1,
                                                                          counts[1] + 1)
    assert K.fused_pe_mlp.cuda_launches == 2
    assert K.fused_pe_mlp_backward.cuda_launches == 4
    _assert_close_rel(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        _assert_close_rel(a, b)
    with pytest.raises(ValueError, match="saved"):
        K.fused_pe_mlp_backward(x, g, win, ws, bs, freqs, skips)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_freqs,widths,skips", [
    (70000, 6, (128,) * 6, (4,)),  # base field, a ragged count
    (262143, 6, (128,) * 6, (4,)),  # base field, a partial last dW slab
    (257, 10, (64, 64, 1), ()),  # visibility field, a tail tile
])
def test_cuda_k4b_is_deterministic(rows, n_freqs, widths, skips):
    """Two K4b calls on the same inputs give bitwise-equal gradients: dW's
    chunks are summed in chunk order, without float atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    freqs = tuple(float(2.0**i) for i in range(n_freqs))
    ws, bs = _cuda_mlp(3 * (2 * n_freqs + 1), widths, skips, seed=rows + 1)
    x = (torch.rand(rows, 3, device="cuda") * 2 - 1) * 0.5
    win = torch.linspace(0.3, 1.0, n_freqs, device="cuda")
    _, acts = K.pe_mlp_forward_saved(x, win, ws, bs, freqs, skips)
    g = torch.randn(rows, widths[-1], device="cuda")
    first = K.fused_pe_mlp_backward(x, g, win, ws, bs, freqs, skips, saved=acts)
    second = K.fused_pe_mlp_backward(x, g, win, ws, bs, freqs, skips, saved=acts)
    torch.cuda.synchronize()
    for a, b in zip([first[0]] + first[1] + first[2], [second[0]] + second[1] + second[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_freqs,widths,skips,rows,want", [
    # (tile rows, tiles, dW blocks per chunk, K4b launches)
    (*K4_PLAN_CASES[0], (128, 2048, 7, 4)),
    (*K4_PLAN_CASES[1], (128, 547, 7, 4)),
    (*K4_PLAN_CASES[2], (128, 3, 3, 4)),
    (10, (128, 8), (), 1024, (128, 8, 2, 4)),
    (6, (128,) * 6, (4,), 262143, (128, 2048, 7, 4)),  # ragged
])
def test_cuda_k4_plan(n_freqs, widths, skips, rows, want):
    """K4f / K4b's launch plan, as csrc/fused_pe_mlp.cu makes it, fits the
    card: the engine's 128-point tiles within sm_90's 227 KB of shared
    memory; dW's chunks whole 32-point slabs that cover the points, about
    eight waves of dW's blocks (128 inputs of a layer each) and at most
    512; the saved floats per point of pe_act_layout, the gradients'
    floats, K4b's scratch at least its buffers (the G image of every
    layer, the embedding, the chunks' slices), and 4 launches for K4b."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the plan is the kernel library's")
    c_x = 3 * (2 * n_freqs + 1)
    in_dims = [c_x] + [w + (c_x if i + 1 in skips else 0) for i, w in enumerate(widths[:-1])]
    skip_mask = sum(1 << i for i in skips)
    plan = K.pe_mlp_plan(K._kernel_lib("fused_pe_mlp"), 3, n_freqs, in_dims, widths, rows, skip_mask)
    tile_rows, tiles, dw_blocks, launches = want
    assert (plan.tile_rows, plan.n_tiles, plan.bwd_launches) == (tile_rows, tiles, launches)
    assert dw_blocks == sum(-(-i // 128) for i in in_dims)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n = max(1, min(-(-rows // 32), -(-8 * n_sm // dw_blocks), 512))
    assert plan.chunk_rows == -(-(-(-rows // n)) // 32) * 32
    assert plan.smem_bytes <= K.SMEM_PER_SM
    assert plan.chunk_rows % 32 == 0 and plan.n_chunks <= 512
    assert (plan.n_chunks - 1) * plan.chunk_rows < rows <= plan.n_chunks * plan.chunk_rows
    n_params = sum(o * (i + 1) for i, o in zip(in_dims, widths))
    assert plan.n_params == n_params and plan.act_floats == sum(widths[:-1])
    wgmma_width = [next(n for n in (8, 16, 32, 64, 128) if n >= o) for o in widths]
    rows_pad = tiles * tile_rows
    assert plan.scratch_floats >= rows_pad * sum(wgmma_width) + rows_pad * -(-c_x // 4) * 4 + \
        plan.n_chunks * n_params
