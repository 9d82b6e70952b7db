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
2e-4 of each array's largest entry. On the card the kernels' fp32 FMA sums
meet the plain version's at 1e-4 (outputs absolute, gradients relative to
each array's largest entry).
"""

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
    """K1 at the flagship step: 32-point tiles, two blocks per SM; K2: 32
    points, one block per SM, within the 227 KB a block may use."""
    _, _, pmodel = flagship_fields
    field = pmodel.fields.field_params["fg"]
    nets = field.pack_field_nets(torch.tensor([1, 2]), None, None, 2)[0]
    cfg = field.pack_field_nets(torch.tensor([1, 2]), None, None, 2)[1]
    dims = FK.heads_dims(nets, cfg)
    assert dims == FK.HeadsDims(width=128, rgb_hidden=64, max_cx=75, g_width=128, h_total=768,
                                stage_ld=196)
    fwd = FK.heads_plan(dims, 1024, 262144, False, 132)
    bwd = FK.heads_plan(dims, 1024, 262144, True, 132)
    assert (fwd.tile_rows, fwd.grid) == (32, 8192) and fwd.smem_bytes <= FK.SMEM_PER_SM // 2
    assert (bwd.tile_rows, bwd.grid) == (32, 132) and bwd.smem_bytes <= FK.SMEM_PER_SM
    with pytest.raises(ValueError, match="pairs"):
        FK.heads_plan(dims, 1024, 1000, False, 132)


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
    cfg, spp = cfg_of(), SPP
    pn = to_port(nets)
    if flagship:  # the flagship widths on 2 pairs of 1024 samples
        gen = torch.Generator().manual_seed(1)
        cfg = FK.FieldCfg(tuple(float(2.0**i) for i in range(12)), 10, 12, 10, 6, (4,), (4,), (4,), (4,))
        spp = 1024

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
        x = ((torch.rand(2 * spp, 3, generator=gen) * 2 - 1) * 0.5).numpy()
        appr = torch.randn(2, 32, generator=gen).numpy()
        win_b = np.linspace(1.0, 0.2, 10).astype(np.float32)
        win_c = np.linspace(1.0, 0.2, 12).astype(np.float32)
        g = [torch.randn(2 * spp, c, generator=gen).numpy() for c in FK.OUT_DIMS]
    dev = "cuda"
    pn = {k: [t.to(dev) for t in v] for k, v in pn.items()}
    args = (torch.tensor(x, device=dev), torch.tensor(appr, device=dev),
            torch.tensor(win_b, device=dev), torch.tensor(win_c, device=dev), pn,
            torch.tensor([IBETA], device=dev), cfg, spp)
    tg = [torch.tensor(t, device=dev) for t in g]
    n1, n2 = FK.fused_nerf_heads.launches, FK.fused_nerf_heads_backward.launches
    got = FK.fused_nerf_heads(*args)
    got_b = FK.fused_nerf_heads_backward(args[0], tg, *args[1:])
    want = FK.nerf_heads_reference(*args)
    want_b = FK.nerf_heads_backward_reference(args[0], tg, *args[1:])
    torch.cuda.synchronize()
    assert (FK.fused_nerf_heads.launches, FK.fused_nerf_heads_backward.launches) == (n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    flat = [got_b[0], got_b[1], got_b[3]] + FK.flatten_nets(got_b[2])[0]
    flat_w = [want_b[0], want_b[1], want_b[3]] + FK.flatten_nets(want_b[2])[0]
    for a, b in zip(flat, flat_w):
        bound = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a.reshape(b.shape) - b).abs().max()) <= bound
