"""K1 and K2, the fused field heads: the port's plain versions against the
JAX package's Pallas kernel (interpret mode on the CPU, as
tests/test_field_kernel.py runs it) and its jnp oracle.

- the forward (density, rgb, vis, feature) and every gradient of the VJP
  (dx, the appearance rows, each dW / db of every head, d ibeta) at
  tests/test_field_kernel.py's sizes, with and without annealing windows;
- split_nets / merge_net_grads: an exact round trip, and the same blocks as
  JAX's _split_nets;
- FeatureNeRF.pack_field_nets and its FieldCfg against JAX's on the
  flagship fg / skel-quad field (D=5, W=128);
- the launch plan of K1 / K2 at the flagship step's widths.

On the CPU the port's wrappers take their plain versions; the CUDA kernels
are compared with those by the `cuda`-marked test, which needs a card and
runs there without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_field_kernel.py

Tolerance: fp32 with sums in another order. Outputs atol 2e-4 (that file's
own kernel-vs-oracle bound); gradients, which sum over the points, within
2e-4 of each array's largest entry. On the card the kernels' 3xTF32
products with fp32 sums meet the plain version's at 1e-4 (outputs absolute, gradients relative to
each array's largest entry).
"""

import contextlib

import numpy as np
import pytest
import torch

from lab4d_tpu_torch.ops import field_kernel as FK

M, SPP = 2, 32
NF = (5, 6, 5, 3)  # base, colour, vis, feat frequencies (test_field_kernel.py)


def _mlp(rng, dims, skips, in_ch):
    """(in, out) weights and (1, out) biases, as tests/test_field_kernel.py."""
    out, ch = [], in_ch
    for i, w in enumerate(dims):
        if i in skips:
            ch += in_ch
        out += [(rng.standard_normal((ch, w)) * 0.2).astype(np.float32),
                (rng.standard_normal((1, w)) * 0.02).astype(np.float32)]
        ch = w
    return out


def jax_layout_case(seed=0):
    """numpy inputs in the JAX kernel's layout: (in, out) weights."""
    rng = np.random.default_rng(seed)
    W = 32
    nets = dict(
        base=_mlp(rng, [W] * 6, (4,), 33),
        sdf=[(rng.standard_normal((W, 1)) * 0.3).astype(np.float32), np.zeros((1, 1), np.float32)],
        color=_mlp(rng, [W] * 3, (4,), 39),
        rgb1=[(rng.standard_normal((W + 8, 16)) * 0.2).astype(np.float32),
              np.zeros((1, 16), np.float32)],
        rgb2=[(rng.standard_normal((16, 3)) * 0.3).astype(np.float32), np.zeros((1, 3), np.float32)],
        vis=_mlp(rng, [16, 16, 1], (4,), 33),
        feat=_mlp(rng, [W] * 5 + [16], (4,), 21),
    )
    x = (rng.standard_normal((M * SPP, 3)) * 0.4).astype(np.float32)
    appr = (rng.standard_normal((M, 8)) * 0.3).astype(np.float32)
    win_b = np.clip(np.linspace(1.2, -0.1, NF[0]), 0, 1).astype(np.float32)
    win_c = np.clip(np.linspace(1.2, -0.3, NF[1]), 0, 1).astype(np.float32)
    g = [rng.standard_normal((M * SPP, c)).astype(np.float32) for c in FK.OUT_DIMS]
    return x, appr, win_b, win_c, nets, g


def cfg_of():
    return FK.FieldCfg(freqs=tuple(float(f) for f in 2.0 ** np.arange(6)), nf_base=NF[0],
                       nf_color=NF[1], nf_vis=NF[2], nf_feat=NF[3], skips_base=(4,),
                       skips_color=(4,), skips_vis=(4,), skips_feat=(4,))


def to_port(nets):
    """(in, out) -> the (out, in) layout; biases (out,)."""
    return {k: [torch.tensor(a.T.copy()) if i % 2 == 0 else torch.tensor(a.reshape(-1))
                for i, a in enumerate(v)] for k, v in nets.items()}


IBETA = 2.0


@pytest.fixture(scope="module", params=["windows", "full bands"])
def both(request):
    """The JAX kernel (interpret mode), its oracle and the port's plain
    version on the same inputs: forward outputs and VJPs."""
    import jax
    import jax.numpy as jnp

    from lab4d_tpu.ops.field_kernel import FieldCfg as JaxCfg
    from lab4d_tpu.ops.field_kernel import fused_nerf_heads as jax_heads
    from lab4d_tpu.ops.field_kernel import nerf_heads_reference as jax_ref

    x, appr, win_b, win_c, nets, g = jax_layout_case()
    if request.param == "full bands":
        win_b = win_c = None
    cfg = cfg_of()
    jcfg = JaxCfg(*cfg)
    jn = jax.tree.map(jnp.asarray, nets)
    jw = [None if w is None else jnp.asarray(w) for w in (win_b, win_c)]
    ib = jnp.full((1, 1), IBETA)
    out = {}
    for name, fn in (("kernel", jax_heads), ("oracle", jax_ref)):
        def f(x_, appr_, nets_, ib_, fn=fn):
            return fn(x_, None, appr_, jw[0], jw[1], nets_, ib_, jcfg, SPP)
        y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(appr), jn, ib)
        dx, dappr, dnets, dib = vjp(tuple(jnp.asarray(t) for t in g))
        out[name] = ([np.asarray(t) for t in y], np.asarray(dx), np.asarray(dappr),
                     jax.tree.map(np.asarray, dnets), float(np.asarray(dib).reshape(())))
    tw = [None if w is None else torch.tensor(w) for w in (win_b, win_c)]
    args = (torch.tensor(x), torch.tensor(appr), *tw, to_port(nets), torch.tensor([IBETA]), cfg, SPP)
    y = FK.fused_nerf_heads(*args)
    tg = [torch.tensor(t) for t in g]
    dx, dappr, dnets, dib = FK.fused_nerf_heads_backward(args[0], tg, *args[1:])
    out["port"] = ([t.numpy() for t in y], dx.numpy(), dappr.numpy(),
                   {k: [t.numpy() for t in v] for k, v in dnets.items()}, float(dib.reshape(())))
    return out


@pytest.mark.parametrize("want", ["kernel", "oracle"])
@pytest.mark.parametrize("k,name", list(enumerate(["density", "rgb", "vis", "feat"])))
def test_forward_matches_jax(both, want, k, name):
    got = both["port"][0][k]
    ref = both[want][0][k]
    assert got.shape == ref.shape == (M * SPP, FK.OUT_DIMS[k])
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0, err_msg=name)


def _close(got, want, what):
    bound = 2e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


@pytest.mark.parametrize("want", ["kernel", "oracle"])
def test_every_gradient_matches_jax(both, want):
    _, dx, dappr, dnets, dib = both["port"]
    _, jdx, jdappr, jdnets, jdib = both[want]
    _close(dx, jdx, "dx")
    _close(dappr, jdappr, "dappr")
    _close(np.array([dib]), np.array([jdib]), "dibeta")
    n = 0
    for name, arrs in jdnets.items():
        assert len(dnets[name]) == len(arrs), name
        for i, a in enumerate(arrs):
            port = dnets[name][i]
            port = port.T if i % 2 == 0 else port.reshape(1, -1)
            assert port.shape == a.shape, (name, i)
            _close(port, a, f"{name}[{i}]")
            n += 1
    assert n == 42  # every weight and bias of the seven nets
    assert abs(jdib) > 0 and np.abs(jdappr).max() > 0  # the comparison is not vacuous


def test_autograd_backward_is_the_plain_vjp():
    """fused_nerf_heads' autograd on the CPU equals fused_nerf_heads_backward."""
    x, appr, win_b, win_c, nets, g = jax_layout_case(seed=1)
    pn = to_port(nets)
    leaves = [torch.tensor(x).requires_grad_(), torch.tensor(appr).requires_grad_(),
              torch.tensor([IBETA]).requires_grad_()]
    flat, order = FK.flatten_nets(pn)
    flat = [t.requires_grad_() for t in flat]
    y = FK.fused_nerf_heads(leaves[0], leaves[1], torch.tensor(win_b), torch.tensor(win_c),
                            FK.unflatten_nets(flat, order), leaves[2], cfg_of(), SPP)
    tg = [torch.tensor(t) for t in g]
    grads = torch.autograd.grad(y, leaves + flat, tg)
    dx, dappr, dnets, dib = FK.fused_nerf_heads_backward(
        torch.tensor(x), tg, torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
        torch.tensor([IBETA]), cfg_of(), SPP)
    want = [dx, dappr, dib] + FK.flatten_nets(dnets)[0]
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b.reshape(a.shape), rtol=0, atol=0)


def test_split_merge_round_trip_and_jax_blocks():
    import jax.numpy as jnp

    from lab4d_tpu.ops.field_kernel import _split_nets as jax_split

    _, _, _, _, nets, _ = jax_layout_case()
    cfg = cfg_of()
    pn = to_port(nets)
    split = FK.split_nets(pn, cfg, appr_dim=8)
    jsplit = jax_split({k: [jnp.asarray(a) for a in v] for k, v in nets.items()}, cfg, 0, 8)
    for name in FK.NET_ORDER:
        assert len(split[name]) == len(jsplit[name]), name
        for a, b in zip(split[name], jsplit[name]):
            assert a.is_contiguous()
            want = np.asarray(b)
            want = want.T if want.ndim == 2 and want.shape[0] != 1 else want.reshape(-1)
            np.testing.assert_array_equal(a.numpy(), want, err_msg=name)
    # skip layers of base and feat and rgb1 split in three; others stay whole
    assert [len(split[k]) for k in FK.NET_ORDER] == [13, 2, 6, 3, 2, 6, 13]
    merged = FK.merge_net_grads(split, pn, cfg)
    for name in FK.NET_ORDER:
        for a, b in zip(merged[name], pn[name]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def flagship_fields():
    """The flagship fg / skel-quad field of both packages with the same
    params, and the per-pair inputs of a training batch."""
    import jax

    from lab4d_tpu.engine.schedules import compute_sched
    from lab4d_tpu_torch.bridge import params_from_flax
    from lab4d_tpu_torch.engine.model import DVRModel
    from lab4d_tpu_torch.nnutils.embedding import FrameInfo
    from tests.test_model import init_params_with_intrinsics_prior, make_model_and_batch

    jmodel, batch = make_model_and_batch("fg", "skel-quad", M=2, N=4)
    params = init_params_with_intrinsics_prior(jmodel, batch, compute_sched(100))["params"]
    fi = jmodel.frame_info
    pmodel = DVRModel(FrameInfo(fi.frame_offset, fi.frame_offset_raw, fi.frame_mapping),
                      fg_motion="skel-quad", device="cpu")
    pmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return jmodel, params, pmodel


def test_pack_field_nets_matches_jax(flagship_fields):
    import jax.numpy as jnp

    from lab4d_tpu.engine.schedules import compute_sched

    jmodel, params, pmodel = flagship_fields
    M_ = 4
    frame_id = np.array([1, 2, 5, 6], np.int32)
    inst_id = np.zeros(M_, np.int32)
    sched = compute_sched(100)

    def pack(m):
        x2 = jnp.zeros((M_ * 8, 3))
        return m.fields.field_params["fg"].pack_field_nets(
            x2, jnp.asarray(frame_id), jnp.asarray(inst_id), sched, True, M_)

    jnets, jcfg, jappr, jwin_b, jwin_c, jib = jmodel.apply({"params": params}, method=pack)
    field = pmodel.fields.field_params["fg"]
    alpha = float(sched["alpha"])
    nets, cfg, appr, win_b, win_c, ib = field.pack_field_nets(
        torch.tensor(frame_id, dtype=torch.int64), torch.tensor(inst_id, dtype=torch.int64),
        alpha, M_)
    assert tuple(cfg) == tuple(jcfg)
    assert cfg.freqs == tuple(float(2.0**i) for i in range(12))
    assert (cfg.nf_base, cfg.nf_color, cfg.nf_vis, cfg.nf_feat) == (10, 12, 10, 6)
    assert field.field_kernel_ok(torch.zeros(M_, 4, 64, 3))
    for name in FK.NET_ORDER:
        assert len(nets[name]) == len(jnets[name]), name
        for i, (a, b) in enumerate(zip(nets[name], jnets[name])):
            want = np.asarray(b).T if i % 2 == 0 else np.asarray(b).reshape(-1)
            np.testing.assert_allclose(a.detach().numpy(), want, atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name}[{i}]")
    np.testing.assert_allclose(appr.detach().numpy(), np.asarray(jappr), atol=1e-6)
    np.testing.assert_allclose(win_b.numpy(), np.asarray(jwin_b), atol=1e-7)
    np.testing.assert_allclose(win_c.numpy(), np.asarray(jwin_c), atol=1e-7)
    np.testing.assert_allclose(ib.detach().numpy(), np.asarray(jib).reshape(-1), rtol=1e-7)


def test_flagship_launch_plan(flagship_fields):
    """K1 at the flagship step: 64-point tiles, one block per tile within the
    227 KB a block may use; K2: 128 chunks of the points for its split-K
    weight gradients; K1 saves 2,001 floats per point for K2."""
    _, _, pmodel = flagship_fields
    field = pmodel.fields.field_params["fg"]
    nets = field.pack_field_nets(torch.tensor([1, 2]), None, None, 2)[0]
    cfg = field.pack_field_nets(torch.tensor([1, 2]), None, None, 2)[1]
    dims = FK.heads_dims(nets, cfg)
    assert dims == FK.HeadsDims(width=128, rgb_hidden=64, max_cx=75, g_width=128)
    plan = FK.heads_plan(dims, 1024, 262144)
    assert (plan.tile_rows, plan.grid, plan.n_chunks) == (64, 4096, 128)
    assert plan.smem_bytes == FK.heads_smem(dims) <= FK.SMEM_PER_SM
    offs, per_point = FK.act_layout(nets)
    assert per_point == 768 + 384 + 64 + 129 + 656 == 2001
    assert offs[("color", 0)] == 768 and offs["rgb_h"] == 1152 and offs[("feat", 0)] == 1345
    # K1's pre-split weights: hi and lo of every layer, k padded to 32
    pk, pk_total = FK.pack_layout(nets, cfg)
    shapes = [w.shape for n in FK.HEADS for w in nets[n][0::2]] + [(64, 128), (3, 64)]
    assert pk_total == sum(2 * n * -(-k // 32) * 32 for n, k in shapes) == 487936
    assert list(pk.values()) == sorted(pk.values()) and pk[("base", 0)] == 0
    with pytest.raises(ValueError, match="pairs"):
        FK.heads_plan(dims, 1024, 1000)
    with pytest.raises(ValueError, match="tiles"):
        FK.heads_plan(dims, 96, 96 * 4)


def test_wrappers_refuse_other_devices():
    x, appr, win_b, win_c, nets, g = jax_layout_case()
    meta = torch.zeros(M * SPP, 3, device="meta")
    with pytest.raises(NotImplementedError):
        FK.fused_nerf_heads(meta, None, None, None, to_port(nets), None, cfg_of(), SPP)
    with pytest.raises(NotImplementedError):
        FK.fused_nerf_heads_backward(meta, g, None, None, None, to_port(nets), None, cfg_of(), SPP)
    with pytest.raises(ValueError, match="pairs"):
        FK._check_inputs(torch.zeros(M * SPP + 1, 3), torch.tensor(appr), None, None,
                         to_port(nets), torch.ones(1), cfg_of(), SPP)


def flagship_case(seed=1, n_pairs=2, spp=1024):
    """The flagship fg field's head widths (D=5 W=128, 10 / 12 / 10 / 6
    frequencies, appearance codes of 32) with torch.nn.Linear-style random
    weights, on n_pairs pairs of spp points: (x, appr, win_b, win_c) as
    numpy, the nets (torch, (out, in)), cfg, spp and the cotangents."""
    gen = torch.Generator().manual_seed(seed)
    cfg = FK.FieldCfg(tuple(float(2.0**i) for i in range(12)), 10, 12, 10, 6, (4,), (4,), (4,), (4,))

    def mlp(dims, c_x):
        out, ch = [], c_x
        for i, w in enumerate(dims):
            ch += c_x if i == 4 else 0
            out += [(torch.rand(w, ch, generator=gen) * 2 - 1) / ch**0.5,
                    (torch.rand(w, generator=gen) * 2 - 1) / ch**0.5]
            ch = w
        return out

    pn = dict(base=mlp([128] * 6, 63), sdf=mlp([1], 128), color=mlp([128] * 3, 75),
              rgb1=mlp([64], 160), rgb2=mlp([3], 64), vis=mlp([64, 64, 1], 63),
              feat=mlp([128] * 5 + [16], 39))
    x = ((torch.rand(n_pairs * spp, 3, generator=gen) * 2 - 1) * 0.5).numpy()
    appr = torch.randn(n_pairs, 32, generator=gen).numpy()
    win_b = np.linspace(1.0, 0.2, 10).astype(np.float32)
    win_c = np.linspace(1.0, 0.2, 12).astype(np.float32)
    g = [torch.randn(n_pairs * spp, c, generator=gen).numpy() for c in FK.OUT_DIMS]
    return x, appr, win_b, win_c, pn, cfg, spp, g


@pytest.mark.cuda
@pytest.mark.parametrize("flagship", [False, True])
def test_cuda_kernels_match_plain(flagship):
    """K1 and K2 against their plain versions on the card (fp32 FMA vs
    cuBLAS fp32, TF32 off): outputs atol 1e-4, gradients within 1e-4 of
    each array's largest entry (and at least 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, appr, win_b, win_c, nets, g = jax_layout_case()
    cfg, spp = cfg_of(), 64  # K1's tiles are 64 points, within one pair
    pn = to_port(nets)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((M * spp, 3)) * 0.4).astype(np.float32)
    g = [rng.standard_normal((M * spp, c)).astype(np.float32) for c in FK.OUT_DIMS]
    if flagship:  # the flagship widths on 2 pairs of 1024 samples
        x, appr, win_b, win_c, pn, cfg, spp, g = flagship_case()
    dev = "cuda"
    pn = {k: [t.to(dev) for t in v] for k, v in pn.items()}
    args = (torch.tensor(x, device=dev), torch.tensor(appr, device=dev),
            torch.tensor(win_b, device=dev), torch.tensor(win_c, device=dev), pn,
            torch.tensor([IBETA], device=dev), cfg, spp)
    tg = [torch.tensor(t, device=dev) for t in g]
    n1, n2 = FK.fused_nerf_heads.launches, FK.fused_nerf_heads_backward.launches
    with pytest.raises(ValueError, match="saved"):  # K2 runs only from K1's saved outputs
        FK.fused_nerf_heads_backward(args[0], tg, *args[1:])
    got, acts = FK.nerf_heads_forward_saved(*args)
    got_b = FK.fused_nerf_heads_backward(args[0], tg, *args[1:], saved=(acts, got[1]))
    want, want_acts = FK.nerf_heads_forward_saved_reference(*args)
    want_b = FK.nerf_heads_backward_reference(args[0], tg, *args[1:])
    torch.cuda.synchronize()
    assert (FK.fused_nerf_heads.launches, FK.fused_nerf_heads_backward.launches) == (n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    torch.testing.assert_close(acts, want_acts, atol=1e-4, rtol=0)  # every saved layer output
    flat = [got_b[0], got_b[1], got_b[3]] + FK.flatten_nets(got_b[2])[0]
    flat_w = [want_b[0], want_b[1], want_b[3]] + FK.flatten_nets(want_b[2])[0]
    for a, b in zip(flat, flat_w):
        bound = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a.reshape(b.shape) - b).abs().max()) <= bound


# ------------------------------------------------------- 3xTF32 error budget


def _tf32(t):
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b from TF32 operands, fp32 sums: 3 passes hi.hi + hi.lo + lo.hi
    (csrc/heads_mma.cuh), 1 pass hi.hi."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if passes == 3:
        out = out + (_tf32(a - ah) @ bh + ah @ _tf32(b - bh))
    return out


def _tf32_linear(passes):
    """F.linear with every product (forward, dIn, dW) in TF32 arithmetic."""

    class Linear(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b=None):
            ctx.save_for_backward(x, w)
            ctx.has_b = b is not None
            lead = x.shape[:-1]
            y = _mm_tf32(x.reshape(-1, x.shape[-1]), w.T.contiguous(), passes).reshape(*lead, -1)
            return y if b is None else y + b

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
            dx = _mm_tf32(g2, w, passes).reshape(x.shape)
            dw = _mm_tf32(g2.T.contiguous(), x2, passes)
            return dx, dw, (g2.sum(0) if ctx.has_b else None)

    return lambda x, w, b=None: Linear.apply(x, w, b)


def _heads_errors(args, tg, ref_f, ref_b):
    """(forward max abs error, backward max rel error per array) against
    the fp64 results ref_f / ref_b."""
    f = FK.nerf_heads_reference(*args)
    b = FK.nerf_heads_backward_reference(args[0], tg, *args[1:])
    fwd = max(float((a.double() - r).abs().max()) for a, r in zip(f, ref_f))
    got = [b[0], b[1], b[3].reshape(-1)] + FK.flatten_nets(b[2])[0]
    want = [ref_b[0], ref_b[1], ref_b[3].reshape(-1)] + FK.flatten_nets(ref_b[2])[0]
    bwd = max(float((a.double().reshape(r.shape) - r).abs().max()) / max(1.0, float(r.abs().max()))
              for a, r in zip(got, want))
    return fwd, bwd


def test_3xtf32_error_budget(monkeypatch):
    """The kernels' arithmetic, emulated on the CPU: every product of the
    heads' forward and backward at the flagship widths (2,048 points) in
    3xTF32 stays within chip_smoke.KERNEL_TOL (1e-4) of fp64: the forward's
    max abs error, the backward's max error over each gradient array's
    largest entry. 1xTF32 is reported, not asserted."""
    x, appr, win_b, win_c, pn, cfg, spp, g = flagship_case()
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
            torch.tensor([10.0]), cfg, spp)
    tg = [torch.tensor(t) for t in g]
    a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args[:4]) + (
        {k: [t.double() for t in v] for k, v in pn.items()}, args[5].double(), cfg, spp)
    ref_f = FK.nerf_heads_reference(*a64)
    ref_b = FK.nerf_heads_backward_reference(a64[0], [t.double() for t in tg], *a64[1:])
    errs = {}
    for passes in (3, 1):
        with monkeypatch.context() as m:
            m.setattr(torch.nn.functional, "linear", _tf32_linear(passes))
            errs[passes] = _heads_errors(args, tg, ref_f, ref_b)
    print(f"against fp64: 3xTF32 forward {errs[3][0]:.2e}, backward {errs[3][1]:.2e}; "
          f"1xTF32 forward {errs[1][0]:.2e}, backward {errs[1][1]:.2e}")
    assert errs[3][0] <= 1e-4 and errs[3][1] <= 1e-4, errs
    assert errs[1][0] > errs[3][0]  # the emulation does round


# ------------------------------------------------------- the profiler's copies


def _anchor_cases():
    from lab4d_tpu_torch.tools import profile_heads_phases as PH
    from lab4d_tpu_torch.tools import profile_k4b_phases as PK

    cases = [("heads", name, patches) for name, patches in PH.MMA_K1.items()]
    cases += [("k4f", name, patches) for name, patches in PK.K4F_COPIES.items()]
    cases += [("k3", name, patches) for name, patches in PK.K3_COPIES.items()]
    return cases


@pytest.mark.parametrize("tool,copy,patches", _anchor_cases(), ids=lambda v: v if isinstance(v, str) else "")
def test_profiler_anchors_found_once(tool, copy, patches):
    """Every anchor that profile_heads_phases (K1's anatomy copies) and
    profile_k4b_phases (K4f's, K3f's and K3b's) replace occurs exactly once
    in the committed source it patches, so an edit that drops one fails
    here and not on the card."""
    from lab4d_tpu_torch.ops.build import CSRC_DIR
    from lab4d_tpu_torch.tools import profile_heads_phases as PH

    main = {"heads": "nerf_heads.cu", "k4f": "fused_pe_mlp.cu", "k3": "fused_relu_mlp.cu"}[tool]
    for fname, anchor, _ in patches:
        assert (CSRC_DIR / fname).read_text().count(anchor) == 1, (tool, copy, anchor[:60])
    texts = PH.patched_sources(CSRC_DIR, patches, main)
    assert set(texts) >= {main, "heads_mma.cuh"}


# ------------------------------------------------------- the saved outputs


def test_saved_layer_outputs_layout():
    """nerf_heads_forward_saved_reference: the outputs of
    nerf_heads_reference, and in act_layout's blocks the layer outputs that
    make them (the visibility logit, the feature before its normalisation,
    feat + colour = hc)."""
    x, appr, win_b, win_c, nets, _ = jax_layout_case(seed=2)
    pn = to_port(nets)
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
            torch.tensor([IBETA]), cfg_of(), SPP)
    outs, acts = FK.nerf_heads_forward_saved_reference(*args)
    want = FK.nerf_heads_reference(*args)
    for a, b in zip(outs, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    offs, per_point = FK.act_layout(pn)
    P = x.shape[0]
    assert acts.shape == (P * per_point,)

    def block(key, width):
        return acts[offs[key] * P: (offs[key] + width) * P].view(P, width)

    torch.testing.assert_close(block(("vis", 2), 1), outs[2], rtol=0, atol=0)
    f16 = block(("feat", 5), 16)
    torch.testing.assert_close(f16 / f16.norm(dim=-1, keepdim=True), outs[3], rtol=1e-6, atol=1e-6)
    assert (block(("base", 0), 32) >= 0).all() and (block("rgb_h", 16) >= 0).all()


def test_pre_activations_give_the_saved_outputs():
    """nerf_heads_forward_saved_reference(pre_activations=True): the same
    outputs, and in every block the layer's input to its ReLU, which the
    ReLU takes to the saved output (the visibility logit and the feature,
    which have none, as saved)."""
    x, appr, win_b, win_c, nets, _ = jax_layout_case(seed=4)
    pn = to_port(nets)
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
            torch.tensor([IBETA]), cfg_of(), SPP)
    outs, acts = FK.nerf_heads_forward_saved_reference(*args)
    outs_z, z = FK.nerf_heads_forward_saved_reference(*args, pre_activations=True)
    for a, b in zip(outs, outs_z):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    offs, _ = FK.act_layout(pn)
    P = x.shape[0]
    no_relu = {offs[("vis", 2)], offs[("feat", 5)]}
    ends = sorted(offs.values()) + [acts.numel() // P]
    for lo, hi in zip(ends[:-1], ends[1:]):
        a, zz = acts[lo * P: hi * P], z[lo * P: hi * P]
        torch.testing.assert_close(a, zz if lo in no_relu else torch.relu(zz), rtol=0, atol=0)
    assert (z < 0).any()


def test_relu_tie_count():
    """chip_smoke's K1 + K2 gate against autograd: _relu_ties finds no tie
    where the saved outputs are the plain ones, and exactly the (row, unit)
    pairs where a saved output sits on the other side of zero from the
    plain ReLU input, with that input's size."""
    import chip_smoke

    x, appr, win_b, win_c, nets, _ = jax_layout_case(seed=5)
    pn = to_port(nets)
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
            torch.tensor([IBETA]), cfg_of(), SPP)
    _, acts = FK.nerf_heads_forward_saved_reference(*args)
    _, z = FK.nerf_heads_forward_saved_reference(*args, pre_activations=True)
    rows, n, z_max = chip_smoke._relu_ties(FK, args, acts)
    assert (int(rows.sum()), n, z_max) == (0, 0, 0.0)
    P = x.shape[0]
    offs, _ = FK.act_layout(pn)
    flipped = acts.clone()
    i = offs[("base", 2)] * P + 5 * 32  # row 5 of a 32-wide block
    j = int(torch.nonzero(z[i: i + 32] <= 0)[0]) + i  # a unit the plain ReLU shuts
    flipped[j] = 1e-7
    k = offs["rgb_h"] * P + 9 * 16  # row 9 of the 16-wide rgb_h block
    k = int(torch.nonzero(z[k: k + 16] > 0)[0]) + k  # a unit the plain ReLU passes
    flipped[k] = 0.0
    # the vis head's last layer has no ReLU: a sign change there is no tie
    flipped[offs[("vis", 2)] * P] = -z[offs[("vis", 2)] * P]
    rows, n, z_max = chip_smoke._relu_ties(FK, args, flipped)
    assert n == 2 and torch.nonzero(rows).flatten().tolist() == [5, 9]
    assert z_max == max(float(z[j].abs()), float(z[k].abs()))


def test_field_kernel_ok_needs_whole_tiles(flagship_fields):
    """FeatureNeRF.field_kernel_ok routes a field to K1 / K2 on the card only
    for whole 64-point tiles (FK.TILE_ROWS) of samples per pair, which the
    kernels require; on the CPU, whose plain versions take any count, for
    multiples of 8, as the JAX package."""
    from types import SimpleNamespace

    field = flagship_fields[2].fields.field_params["fg"]
    cuda = torch.device("cuda")  # a device name only; nothing runs on it
    assert field.field_kernel_ok(torch.zeros(2, 4, 8, 3))
    assert not field.field_kernel_ok(torch.zeros(2, 3, 6, 3))
    assert field.field_kernel_ok(SimpleNamespace(device=cuda, ndim=4, shape=(2, 16, 64, 3)))
    assert field.field_kernel_ok(SimpleNamespace(device=cuda, ndim=4, shape=(2, 4, 16, 3)))
    assert not field.field_kernel_ok(SimpleNamespace(device=cuda, ndim=4, shape=(2, 4, 8, 3)))
    assert FK.TILE_ROWS == 64


def test_autograd_backward_receives_the_saved_outputs(monkeypatch):
    """_FusedNerfHeads on CPU tensors runs the plain versions of K1 and K2's
    dataflow: its forward saves the layer outputs, its backward gets exactly
    those (and the forward's rgb), and the gradients equal the plain VJP."""
    x, appr, win_b, win_c, nets, g = jax_layout_case(seed=3)
    pn = to_port(nets)
    seen = {}
    fwd, bwd = FK.nerf_heads_forward_saved_reference, FK.nerf_heads_backward_saved_reference

    def fwd_spy(*a):
        seen["fwd"] = fwd(*a)
        return seen["fwd"]

    def bwd_spy(*a):
        seen["bwd"] = a[-2:]
        return bwd(*a)

    monkeypatch.setattr(FK, "nerf_heads_forward_saved_reference", fwd_spy)
    monkeypatch.setattr(FK, "nerf_heads_backward_saved_reference", bwd_spy)
    leaves = [torch.tensor(x).requires_grad_(), torch.tensor(appr).requires_grad_(),
              torch.tensor([IBETA]).requires_grad_()]
    flat, order = FK.flatten_nets(pn)
    flat = [t.clone().requires_grad_() for t in flat]
    cfg = cfg_of()
    y = FK._FusedNerfHeads.apply(leaves[0], leaves[1], torch.tensor(win_b), torch.tensor(win_c),
                                 leaves[2], cfg, SPP, order, True, *flat)
    tg = [torch.tensor(t) for t in g]
    grads = torch.autograd.grad(y, leaves + flat, tg)
    (outs, acts), (got_acts, got_rgb) = seen["fwd"], seen["bwd"]
    assert got_acts.data_ptr() == acts.data_ptr() and torch.equal(got_acts, acts)
    assert torch.equal(got_rgb, outs[1])
    dx, dappr, dnets, dib = FK.nerf_heads_backward_reference(
        torch.tensor(x), tg, torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
        torch.tensor([IBETA]), cfg, SPP)
    for a, b in zip(grads, [dx, dappr, dib] + FK.flatten_nets(dnets)[0]):
        bound = 1e-5 * max(1.0, float(b.abs().max()))
        assert float((a - b.reshape(a.shape)).abs().max()) <= bound


@pytest.mark.parametrize("mode", ["no_grad", "frozen"])
def test_k1_saves_nothing_without_a_gradient(monkeypatch, mode):
    """fused_nerf_heads decides to save K1's layer outputs before apply,
    with mlp_kernel.needs_saved (grad mode on and an input or parameter
    that requires a gradient), as K3f and K4f do: under torch.no_grad()
    with parameters that require gradients, and for a frozen model
    (requires_grad_(False)), _FusedNerfHeads saves nothing and gives the
    saving call's outputs."""
    x, appr, win_b, win_c, nets, _ = jax_layout_case(seed=4)
    pn = to_port(nets)
    flat, order = FK.flatten_nets(pn)
    flat = [t.clone().requires_grad_(mode == "no_grad") for t in flat]
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c),
            torch.tensor([IBETA]), cfg_of(), SPP, order)
    seen = []
    fwd = FK.nerf_heads_forward_saved_reference
    monkeypatch.setattr(FK, "nerf_heads_forward_saved_reference",
                        lambda *a: seen.append(1) or fwd(*a))
    want = FK._FusedNerfHeads.apply(*args, True, *flat)
    assert seen == [1]
    ctx = torch.no_grad() if mode == "no_grad" else contextlib.nullcontext()
    with ctx:
        save = FK.needs_saved(args[0], args[1], args[4], *flat)
        got = FK._FusedNerfHeads.apply(*args, save, *flat)
    assert save is False and seen == [1]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="without saving"):
        torch.autograd.grad(FK._FusedNerfHeads.apply(args[0].requires_grad_(), *args[1:], False,
                                                     *flat)[0].sum(), args[0])
