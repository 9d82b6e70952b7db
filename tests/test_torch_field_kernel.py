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
import ctypes

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
    """K1 / K2 at the flagship step: tiles of 128 points (64 per warpgroup,
    each within a pair), one persistent block per SM within the 227 KB a
    block may use, 3 weight slabs in flight; K1 is 20 passes, K2's dIn 21
    (d hc, then each head's layers, x columns before h); K2's dW 21 layers
    in 23 blocks per chunk of rows, 46 chunks (about eight waves on 132
    SMs); K1 saves 2,001 floats per point for K2."""
    _, _, pmodel = flagship_fields
    field = pmodel.fields.field_params["fg"]
    nets, cfg = field.pack_field_nets(torch.tensor([1, 2]), None, None, 2)[:2]
    dims = FK.heads_dims(nets, cfg)
    assert dims == FK.HeadsDims(width=128, rgb_hidden=64, max_cx=75, g_width=128, dw_blocks=23,
                                row_align=64)
    plan = FK.heads_plan(dims, 1024, 262144)
    assert plan == FK.HeadsPlan(tile_rows=128, smem_bytes=228480, grid=132, stages=3, ldx=84, ldh=132,
                                n_chunks=46, chunk_rows=5728)
    assert plan.smem_bytes == FK.heads_smem(84, 132, 3) <= FK.SMEM_PER_SM < FK.heads_smem(84, 132, 4)
    assert FK.heads_plan(dims, 64, 64 * 3).grid == 2  # a ragged half tile
    offs, per_point = FK.act_layout(nets)
    assert per_point == 768 + 384 + 64 + 129 + 656 == 2001
    assert offs[("color", 0)] == 768 and offs["rgb_h"] == 1152 and offs[("feat", 0)] == 1345
    s = FK.heads_shapes(nets, cfg)
    k1, img1 = FK.heads_passes(s, False)
    k2, img2 = FK.heads_passes(s, True)
    assert [FK.EPI[p.epi] for p in k1] == ["hid"] * 5 + ["base", "hid", "hid", "col", "rgb1", "rgb2",
                                                         "hid", "hid", "vis"] + ["hid"] * 5 + ["feat"]
    assert [p.nw for p in k1 if p.n < 128] == [64, 8, 64, 64, 8, 16]
    assert [p.nxs for p in k1 if p.nxs] == [4, 4, 5, 4, 3, 3]  # round16 of 63, 63, 75, 63, 39, 39
    assert [FK.EPI[p.epi] for p in k2].count("dx") == 6 and len(k2) == 21
    assert [(p.head, p.layer) for p in k2 if p.first] == [(0, 5), (1, 2), (2, 2), (3, 5)]
    assert (img1, img2) == (477184, 497664)  # 1.9 and 2.0 MB of split weights
    dws, gstride, blocks = FK.heads_dw(s)
    assert (len(dws), blocks, gstride) == (21, 23, 32 * (8 + 8 + 64 + 6 * 128 + 3 * 128 + 64 + 64 + 8
                                                         + 5 * 128 + 16))
    assert [FK.A_KINDS[d.kind] for d in dws[3:9]] == ["x", "h", "h", "h", "xh", "h"]
    with pytest.raises(ValueError, match="pairs"):
        FK.heads_plan(dims, 1024, 1000)
    with pytest.raises(ValueError, match="tiles"):
        FK.heads_plan(dims, 96, 96 * 4)
    with pytest.raises(ValueError, match="multiples of 4"):
        FK.heads_plan(dims._replace(row_align=2), 1024, 262144)


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


def _cuda_case(case):
    """(args on the card, cotangents) of a cuda test: jax_layout_case's odd
    widths on 2 pairs of 64 points, on 3 pairs of 64 (the last tile half
    empty), or the flagship widths on 2 pairs of 1024 samples."""
    if case == "flagship":
        x, appr, win_b, win_c, pn, cfg, spp, g = flagship_case()
        args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
                torch.tensor([IBETA]), cfg, spp)
        g = [torch.tensor(t) for t in g]
    else:
        args, g = _small_args(seed=2, n_pairs=3 if case == "odd-pairs-64" else 2, spp=64)
    dev = "cuda"
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args[:4]) + (
        {k: [t.to(dev) for t in v] for k, v in args[4].items()}, args[5].to(dev)) + args[6:]
    return args, [t.to(dev) for t in g]


def _grads_within(got, want, tol=1e-4):
    for a, b in zip(_grad_list(got), _grad_list(want)):
        bound = tol * max(1.0, float(b.abs().max()))
        assert float((a.reshape(b.shape) - b).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "odd-pairs-64", "flagship"])
def test_cuda_kernels_match_plain(case):
    """K1 and K2 against their plain versions on the card (cuBLAS fp32,
    TF32 off): outputs and every saved layer output atol 1e-4; K2's
    gradients within 1e-4 of each array's largest entry (and at least
    1e-4) of nerf_heads_backward_saved_reference on the same saved
    outputs, and of autograd through the plain forward outside the rows
    where a ReLU input lies on the other side of zero in the two forwards
    (chip_smoke's gate: every such input within 10x K1's saved-output error
    of zero); K1's split weights bitwise FK.pack_reference; K1 2 CUDA
    launches, K2 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    args, tg = _cuda_case(case)
    n1, n2 = FK.fused_nerf_heads.launches, FK.fused_nerf_heads_backward.launches
    with pytest.raises(ValueError, match="saved"):  # K2 runs only from K1's saved outputs
        FK.fused_nerf_heads_backward(args[0], tg, *args[1:])
    got, acts = FK.nerf_heads_forward_saved(*args)
    assert FK.fused_nerf_heads.cuda_launches == 2
    got_b = FK.fused_nerf_heads_backward(args[0], tg, *args[1:], saved=(acts, got[1]))
    assert FK.fused_nerf_heads_backward.cuda_launches == 4
    want, want_acts = FK.nerf_heads_forward_saved_reference(*args)
    torch.cuda.synchronize()
    assert (FK.fused_nerf_heads.launches, FK.fused_nerf_heads_backward.launches) == (n1 + 1, n2 + 1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    torch.testing.assert_close(acts, want_acts, atol=1e-4, rtol=0)  # every saved layer output
    _grads_within(got_b, FK.nerf_heads_backward_saved_reference(args[0], tg, *args[1:], acts, got[1]))
    tie_rows, n_ties, z_tie = chip_smoke._relu_ties(FK, args, acts)
    assert z_tie <= 10 * float((acts - want_acts).abs().max()), (n_ties, z_tie)
    keep = (~tie_rows).float()[:, None]
    kept = [t * keep for t in tg]
    _grads_within(FK.fused_nerf_heads_backward(args[0], kept, *args[1:], saved=(acts, got[1])),
                  FK.nerf_heads_backward_reference(args[0], kept, *args[1:]))
    x, appr, win_b, win_c, nets, ibeta, cfg, spp = args
    img = FK.heads_passes(FK.heads_shapes(nets, cfg), False)[1]
    wpk = torch.empty(img + (x.shape[0] // spp) * nets["rgb1"][0].shape[0], device="cuda")
    FK._launch_fwd(FK._kernel_lib(), *args, FK._stream(x.device), wpk=wpk)
    want_pk = FK.pack_reference({k: [t.cpu() for t in v] for k, v in nets.items()}, cfg,
                                appr.shape[1], win_b.cpu(), win_c.cpu())
    assert torch.equal(wpk[:img].cpu(), want_pk)


@pytest.mark.cuda
def test_cuda_kernels_repeat_bitwise():
    """K1 and K2 twice on the same inputs at the flagship widths: every
    output, saved layer output and gradient bitwise equal (no float
    atomics; every sum across warps, blocks and chunks in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    args, tg = _cuda_case("flagship")
    runs = []
    for _ in range(2):
        outs, acts = FK.nerf_heads_forward_saved(*args)
        grads = FK.fused_nerf_heads_backward(args[0], tg, *args[1:], saved=(acts, outs[1]))
        runs.append(list(outs) + [acts] + _grad_list(grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd-pairs-64", "flagship"])
def test_cuda_heads_plan(case):
    """The library's own layout (lab4d_nerf_heads_layout) against
    heads_plan: the engine's shared memory per block and its blocks (one
    per SM, at most one per tile), dW's shared memory, K2's scratch floats
    (split weights, G image, workspace slices, per-half and per-pair sums),
    the NhArgs size; a layout it does not take is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the sizes are the kernel library's")
    args, _ = _cuda_case(case)
    x, appr, win_b, win_c, nets, ibeta, cfg, spp = args
    lib = FK._kernel_lib()
    P = x.shape[0]
    plan = FK.heads_plan(FK.heads_dims(nets, cfg), spp, P, FK._n_sm(x.device))
    s = FK.heads_shapes(nets, cfg)
    for bwd in (False, True):
        a = FK._prepare(*args, bwd)[0]
        smem, grid, dw_smem, scratch, size = FK.heads_layout(lib, a, bwd)
        assert (smem, grid, dw_smem, size) == (plan.smem_bytes, plan.grid, FK.DW_SMEM,
                                               ctypes.sizeof(FK._NhArgs))
        assert max(smem, dw_smem) <= FK.SMEM_PER_SM and size + 96 <= 4096  # kernel parameters
        if bwd:
            _, gstride, blocks = FK.heads_dw(s)
            n_slice = FK._grad_offsets(FK.split_nets(nets, cfg, appr.shape[1]), s.rgb_hidden,
                                       appr.shape[1])[1]
            ldl = -(-(3 + 6 * max(h.n_freqs for h in s.heads)) // 4) * 4
            want = (FK.heads_passes(s, True)[1] + -(-P // 128) * 4 * gstride + plan.n_chunks * n_slice
                    + (P // 64) * (s.rgb_hidden + 1) + (P // spp) * s.rgb_hidden + blocks + P * ldl)
            assert scratch == want
        a.stages = 4
        with pytest.raises(RuntimeError):
            FK.heads_layout(lib, a, bwd)


# ------------------------------------------------------- the engine on the CPU


def unpack_pass(pk, p):
    """B (nsl * 16, nw) of a pass from its slabs in the packed weights,
    each [k / 4][n / 8][n % 8][k % 4], hi then lo: hi + lo in fp64 (exact);
    every hi is cut to TF32."""
    f, half = 32 * p.nw, 16 * p.nw
    out = []
    for sl in range(p.nsl):
        hl = [pk[p.img + sl * f + h * half: p.img + sl * f + (h + 1) * half]
              .reshape(4, p.nw // 8, 8, 4).permute(0, 3, 1, 2).reshape(16, p.nw) for h in (0, 1)]
        assert torch.equal(hl[0], FK._tf32_cut(hl[0]))
        out.append(hl[0].double() + hl[1].double())
    return torch.cat(out)


def _ladder(x, cfg, n_freqs, cols):
    """The shared Fourier ladder [x | sin, cos of frequency 0 | ...] of the
    points x, zero-padded to cols columns."""
    P = x.shape[0]
    ang = x[:, None, :] * torch.tensor(cfg.freqs[:n_freqs], dtype=x.dtype)[:, None]
    lad = torch.cat([x, torch.stack([ang.sin(), ang.cos()], 2).reshape(P, 6 * n_freqs)], 1)
    return torch.nn.functional.pad(lad, (0, cols - lad.shape[1]))


def emulate_k1(args, mm=torch.matmul):
    """K1 as the engine computes it, on the CPU: FK.heads_passes in order
    over the shared ladder, the H and F buffers (a pass writes its first n
    columns; stale ones meet zero weights), each pass A . B with B unpacked
    from FK.pack_reference, its epilogue. mm(a, b): the products. Returns
    ((density, rgb, vis, feat), acts) as nerf_heads_forward_saved_reference."""
    x, appr, win_b, win_c, nets, ibeta, cfg, spp = args
    s = FK.heads_shapes(nets, cfg)
    passes, _ = FK.heads_passes(s, False)
    pk = FK.pack_reference(nets, cfg, appr.shape[1], win_b, win_c)
    P, nf = x.shape[0], max(h.n_freqs for h in s.heads)
    X = _ladder(x, cfg, nf, FK._r16(3 + 6 * nf))
    H, Fb = torch.zeros(P, 128), torch.zeros(P, 128)
    snets = FK.split_nets(nets, cfg, appr.shape[1])
    abias = (snets["rgb1"][2] + appr @ snets["rgb1"][1].T).repeat_interleave(spp, 0)
    offs, total = FK.act_layout(nets)
    acts = torch.zeros(P * total)
    ib = ibeta.reshape(())
    out = {}
    for p in passes:
        B = unpack_pass(pk, p).float()
        A = torch.cat([X[:, : 16 * p.nxs], (Fb if p.src else H)[:, : 16 * (p.nsl - p.nxs)]], 1)
        epi, n = FK.EPI[p.epi], p.n
        b = abias if epi == "rgb1" else (snets["rgb2"][1] if epi == "rgb2"
                                         else nets[FK.HEADS[p.head]][2 * p.layer + 1])
        z = mm(A, B)[:, :n] + b
        if epi in ("hid", "base", "col", "rgb1"):
            z = torch.relu(z)
        if epi != "rgb2":
            key = "rgb_h" if epi == "rgb1" else (FK.HEADS[p.head], p.layer)
            acts[offs[key] * P: (offs[key] + n) * P] = z.reshape(-1)
        if epi in ("hid", "rgb1"):
            H = H.clone()
            H[:, :n] = z
        elif epi == "base":
            Fb[:, :n] = z
            sdf = z @ snets["sdf"][0].T + snets["sdf"][1]
            out["density"] = (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() * ib)) * ib
        elif epi == "col":
            Fb[:, :n] = Fb[:, :n] + z
        elif epi == "rgb2":
            out["rgb"] = torch.sigmoid(z)
        elif epi == "vis":
            out["vis"] = z
        else:
            out["feat"] = z / torch.clamp(torch.sqrt((z * z).sum(-1, keepdim=True) + 1e-12), min=1e-6)
    return (out["density"], out["rgb"], out["vis"], out["feat"]), acts


def emulate_k2(args, g, acts, rgb, mm=torch.matmul, mm_dw=torch.matmul):
    """K2 as its launches compute it, on the CPU: the output cotangents,
    FK.heads_passes(bwd) over W^T unpacked from FK.pack_reference (G in H
    and F, dX of the shared ladder over every head), each layer's G for
    dW, dx through the ladder's sin / cos, dW = G^T A of FK.heads_dw (the
    embedding's columns in ladder order, then put back with their window),
    the pairs' appearance gradients. Returns (dx, dappr, dnets, dibeta)
    as nerf_heads_backward_saved_reference."""
    x, appr, win_b, win_c, nets, ibeta, cfg, spp = args
    s = FK.heads_shapes(nets, cfg)
    passes, _ = FK.heads_passes(s, True)
    dws, _, _ = FK.heads_dw(s)
    pk = FK.pack_reference(nets, cfg, appr.shape[1], win_b, win_c, bwd=True)
    snets = FK.split_nets(nets, cfg, appr.shape[1])
    P, W, RH, ib = x.shape[0], s.width, s.rgb_hidden, ibeta.reshape(())
    offs, _ = FK.act_layout(nets)
    gd, grgb, gvis, gfeat = g

    def saved(key, width):
        return acts[offs[key] * P: (offs[key] + width) * P].view(P, width)

    def last(hi):
        return saved((FK.HEADS[hi], s.heads[hi].n_layers - 1), s.heads[hi].out_dims[-1])

    feat, col, f16 = last(0), last(1), last(3)
    sdf = feat @ snets["sdf"][0].T + snets["sdf"][1]
    e = torch.exp(-sdf.abs() * ib)
    gsd = gd * (-0.5 * ib * ib * e)
    dib = (gd * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-sdf.abs() * ib) - 0.5 * ib * sdf * e)).sum()
    g_rgb = grgb * rgb * (1 - rgb)
    g_rgbh = (g_rgb @ snets["rgb2"][0]) * (saved("rgb_h", RH) > 0)
    nrm = torch.clamp(torch.sqrt((f16 * f16).sum(-1, keepdim=True) + 1e-12), min=1e-6)
    g_f16 = (gfeat - f16 / nrm * (f16 / nrm * gfeat).sum(-1, keepdim=True)) / nrm
    G = {0: gsd, 1: g_rgb, 2: g_rgbh}
    nf = max(h.n_freqs for h in s.heads)
    H, Fb, dX = torch.zeros(P, 128), torch.zeros(P, 128), torch.zeros(P, FK._r16(3 + 6 * nf))
    H[:, :RH] = g_rgbh
    for p in passes:
        if p.first and p.head == 2:
            H = H.clone()
            H[:, :1] = gvis
        if p.first and p.head == 3:
            H = H.clone()
            H[:, : s.feat_dim] = g_f16
        src = Fb if p.src else H
        if p.dw >= 0:
            G[p.dw] = src[:, : dws[p.dw].N].clone()
        z = mm(src[:, : 16 * p.nsl], unpack_pass(pk, p).float())[:, : p.n]
        epi = FK.EPI[p.epi]
        if epi == "dhc":
            H, Fb = H.clone(), Fb.clone()
            H[:, :W] = (z + gsd * snets["sdf"][0]) * (feat > 0)
            Fb[:, :W] = z * (col > 0)
        elif epi == "dx":
            dX[:, : p.n] += z
        else:
            h = s.heads[p.head]
            H = H.clone()
            H[:, : p.n] = z * (saved((FK.HEADS[p.head], p.layer - 1), h.out_dims[p.layer - 1]) > 0)
    ang = x[:, None, :] * torch.tensor(cfg.freqs[:nf])[:, None]
    lad = dX[:, 3: 3 + 6 * nf].reshape(P, nf, 2, 3)
    fr = torch.tensor(cfg.freqs[:nf])[:, None]
    dx = dX[:, :3] + ((ang.cos() * lad[:, :, 0] - ang.sin() * lad[:, :, 1]) * fr).sum(1)
    X = _ladder(x, cfg, nf, 3 + 6 * nf)
    dn = {name: [None] * len(arrs) for name, arrs in nets.items()}
    for i, d in enumerate(dws):
        if d.head < 0:
            A = {-1: feat, -2: saved("rgb_h", RH), -3: feat + col}[d.head]
        else:
            h, name = s.heads[d.head], FK.HEADS[d.head]
            cx = h.c_x if h.has_x(d.layer) else 0
            parts = [X[:, :cx]] + ([saved((name, d.layer - 1), h.out_dims[d.layer - 1])] if d.layer else [])
            A = torch.cat(parts, 1)
        dwt, db = mm_dw(A.T.contiguous(), G[i]), G[i].sum(0)
        if d.head == -1:
            dn["sdf"] = [dwt.T, db]
        elif d.head == -2:
            dn["rgb2"] = [dwt.T, db]
        elif d.head == -3:
            dw_hc = dwt.T
        else:
            w = torch.zeros(d.N, d.K)
            if cx:
                cols, freq = FK.ladder_order(h.n_freqs)
                win = {"base": win_b, "color": win_c}.get(name)
                scale = torch.ones(cx) if win is None else torch.cat(
                    [torch.ones(3), win.repeat_interleave(6)])
                w[:, cols] = dwt[:cx].T * scale
            w[:, cx:] = dwt[cx:].T
            dn[name][2 * d.layer], dn[name][2 * d.layer + 1] = w, db
    gpair = g_rgbh.view(-1, spp, RH).sum(1)
    dn["rgb1"] = [torch.cat([dw_hc, gpair.T @ appr], 1), gpair.sum(0)]
    return dx, gpair @ snets["rgb1"][1], dn, dib.reshape(1)


def _small_args(seed=0, n_pairs=2, spp=64):
    """jax_layout_case's widths (odd embeddings, W 32, vis 16) on n_pairs
    pairs of spp points, as fused_nerf_heads' arguments, and cotangents."""
    x, appr, win_b, win_c, nets, _ = jax_layout_case(seed)
    rng = np.random.default_rng(seed + 10)
    x = (rng.standard_normal((n_pairs * spp, 3)) * 0.4).astype(np.float32)
    appr = (rng.standard_normal((n_pairs, 8)) * 0.3).astype(np.float32)
    g = [torch.tensor(rng.standard_normal((n_pairs * spp, c)).astype(np.float32)) for c in FK.OUT_DIMS]
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), to_port(nets),
            torch.tensor([IBETA]), cfg_of(), spp)
    return args, g


def _grad_list(res):
    dx, dappr, dn, dib = res
    return [dx, dappr, dib.reshape(-1)] + [t.reshape(-1) for t in FK.flatten_nets(dn)[0]]


@pytest.mark.parametrize("case", ["small", "flagship"])
def test_engine_emulation_matches_plain(case):
    """The engine's dataflow on the CPU (emulate_k1 / emulate_k2: the pass
    and dW tables, the packed weights, the shared ladder, the buffers and
    every epilogue) against the plain versions: K1's outputs and saved
    layer outputs within 1e-5, K2's gradients within 1e-5 of each array's
    largest entry (fp32, sums in another order). Small: jax_layout_case's
    odd widths; flagship: D5 W128 on 256 points."""
    if case == "small":
        args, g = _small_args()
    else:
        x, appr, win_b, win_c, pn, cfg, spp, gn = flagship_case(n_pairs=2, spp=128)
        args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
                torch.tensor([IBETA]), cfg, spp)
        g = [torch.tensor(t) for t in gn]
    outs, acts = emulate_k1(args)
    want, want_acts = FK.nerf_heads_forward_saved_reference(*args)
    for a, b in zip(outs, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(acts, want_acts, atol=1e-5, rtol=0)
    got = _grad_list(emulate_k2(args, g, want_acts, want[1]))
    ref = _grad_list(FK.nerf_heads_backward_saved_reference(args[0], g, *args[1:], want_acts, want[1]))
    assert len(got) == len(ref) == 45
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


def test_pack_layout_holds_the_weights():
    """FK.pack_reference, unpacked by hand from the documented slab layout
    ([k / 4][n / 8][n % 8][k % 4], hi cut to TF32 then lo, per 16-deep
    slab): K1's base skip layer is [W_x permuted to the shared ladder, times
    the base window; zero to 16 rows | W_h] transposed, zero past its 128
    outputs' wgmma; K2's passes of that layer are W_x (ladder order,
    windowed) and W_h; rgb1 is W_hc^T, rgb2 W_rgb2^T; each pass's slabs
    start where the previous pass's end."""
    x, appr, win_b, win_c, pn, cfg, spp, _ = flagship_case(n_pairs=1, spp=64)
    wb, wc = torch.tensor(win_b), torch.tensor(win_c)
    s = FK.heads_shapes(pn, cfg)
    cols, freq = FK.ladder_order(10)
    assert cols[:9] == [0, 1, 2, 3, 4, 5, 33, 34, 35] and freq[3:9] == [0] * 6
    scale = torch.cat([torch.ones(3), wb.repeat_interleave(6)]).double()
    w4 = pn["base"][8].double()  # (128, 63 + 128): [x | h]
    for bwd in (False, True):
        passes, img = FK.heads_passes(s, bwd)
        pk = FK.pack_reference(pn, cfg, 32, wb, wc, bwd)
        assert pk.numel() == img and passes[0].img == 0
        assert all(b.img == a.img + a.nsl * 32 * a.nw for a, b in zip(passes, passes[1:]))
        for p in passes:
            if (p.head, p.layer) != (0, 4) and FK.EPI[p.epi] not in ("rgb1", "rgb2"):
                continue
            B = unpack_pass(pk, p)
            if FK.EPI[p.epi] == "rgb1":
                assert torch.equal(B[:128, :64], pn["rgb1"][0][:, :128].T.double())
            elif FK.EPI[p.epi] == "rgb2":
                assert torch.equal(B[:64, :3], pn["rgb2"][0].T.double()) and not B[:, 3:].any()
            elif FK.EPI[p.epi] == "dx":
                torch.testing.assert_close(B[:128, :63], (w4[:, cols] * scale).float().double(),
                                           rtol=0, atol=0)
            elif FK.EPI[p.epi] == "dh":
                assert torch.equal(B[:128, :128], w4[:, 63:])
            else:
                assert (p.nxs, p.nsl, p.nw) == (4, 12, 128)
                torch.testing.assert_close(B[:63, :128], (w4[:, cols] * scale).float().double().T,
                                           rtol=0, atol=0)
                assert not B[63:64].any()
                assert torch.equal(B[64:192, :128], w4[:, 63:].T)


# ------------------------------------------------------- 3xTF32 error budget


def test_3xtf32_error_budget():
    """The engine's arithmetic, emulated on the CPU at the flagship widths
    (512 points): every product of K1 and K2 in wgmma's order
    (tests/test_torch_mlp_kernel.py:_mm_wgmma_3xtf32: per 16-deep weight
    slab, and per 32-row G slab of dW, lo.hi + hi.lo + hi.hi accumulated in
    the tensor core from zero, each step cut toward zero, then added in
    fp32) stays within chip_smoke.KERNEL_TOL (1e-4) of fp64: the forward's
    max abs error, the backward's max error over each gradient array's
    largest entry. 1xTF32 is reported, not asserted."""
    from tests.test_torch_mlp_kernel import _mm_wgmma_3xtf32, _tf32

    x, appr, win_b, win_c, pn, cfg, spp, g = flagship_case(n_pairs=2, spp=256)
    args = (torch.tensor(x), torch.tensor(appr), torch.tensor(win_b), torch.tensor(win_c), pn,
            torch.tensor([10.0]), cfg, spp)
    tg = [torch.tensor(t) for t in g]
    a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args[:4]) + (
        {k: [t.double() for t in v] for k, v in pn.items()}, args[5].double(), cfg, spp)
    ref_f = FK.nerf_heads_reference(*a64)
    ref_b = _grad_list(FK.nerf_heads_backward_reference(a64[0], [t.double() for t in tg], *a64[1:]))
    errs = {}
    for name, mm, mm_dw in (("3xTF32", _mm_wgmma_3xtf32(16), _mm_wgmma_3xtf32(32)),
                            ("1xTF32", lambda a, b: _tf32(a.contiguous()) @ _tf32(b.contiguous()), None)):
        outs, acts = emulate_k1(args, mm)
        fwd = max(float((a.double() - r).abs().max()) for a, r in zip(outs, ref_f))
        got = _grad_list(emulate_k2(args, tg, acts, outs[1], mm, mm_dw or mm))
        bwd = max(float((a.double() - r).abs().max()) / max(1.0, float(r.abs().max()))
                  for a, r in zip(got, ref_b))
        errs[name] = (fwd, bwd)
    print(f"against fp64: 3xTF32 forward {errs['3xTF32'][0]:.2e}, backward {errs['3xTF32'][1]:.2e}; "
          f"1xTF32 forward {errs['1xTF32'][0]:.2e}, backward {errs['1xTF32'][1]:.2e}")
    assert errs["3xTF32"][0] <= 1e-4 and errs["3xTF32"][1] <= 1e-4, errs
    assert errs["1xTF32"][0] > errs["3xTF32"][0]  # the emulation does round


# ------------------------------------------------------- the profiler's copies


def _anchor_cases():
    from lab4d_tpu_torch.tools import profile_heads_phases as PH
    from lab4d_tpu_torch.tools import profile_k4b_phases as PK

    cases = [("heads", name, patches) for name, patches in {**PH.K1_COPIES, **PH.K2_COPIES}.items()]
    cases += [("k4f", name, patches) for name, patches in PK.K4F_COPIES.items()]
    cases += [("k4b", name, patches) for name, patches in PK.K4B_COPIES.items()]
    cases += [("k3", name, patches) for name, patches in PK.K3_COPIES.items()]
    return cases


@pytest.mark.parametrize("tool,copy,patches", _anchor_cases(), ids=lambda v: v if isinstance(v, str) else "")
def test_profiler_anchors_found_once(tool, copy, patches):
    """Every anchor that profile_heads_phases (K1's anatomy copies) and
    profile_k4b_phases (K4f's, K4b's, K3f's and K3b's) replace occurs exactly once
    in the committed source it patches, so an edit that drops one fails
    here and not on the card."""
    from lab4d_tpu_torch.ops.build import CSRC_DIR
    from lab4d_tpu_torch.tools import profile_heads_phases as PH

    main = {"heads": "nerf_heads.cu", "k4f": "fused_pe_mlp.cu", "k4b": "fused_pe_mlp.cu",
            "k3": "fused_relu_mlp.cu"}[tool]
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
