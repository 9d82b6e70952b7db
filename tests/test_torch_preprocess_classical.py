"""The port's dense programs of the preprocessing pipeline against the
JAX package's, on the CPU, on the same seeded numpy inputs:

- the pyramidal Lucas-Kanade flow and its cycle-occlusion channel
  (backends/flow_classical.py vs preprocess/backends/flow_jax.py) at the
  flow stage's 288^2 and the frame filter's 160^2: mean endpoint error
  <= 1e-2 px (the 2x2 solve divides by a determinant over 5 levels x 4
  iterations, so fp32 rounding grows: compared by endpoint error, not
  element by element);
- the filter bank (a downscale from a 256^2 crop and an upscale from 64^2);
- one TSDF integration of 3 frames into a 32^3 grid, within 1e-5, outside
  the voxels whose projection lies within 1e-4 px of a rounding boundary
  of the nearest-pixel lookup (counted);
- the canonical rotation fit (libs/registration.py): both phases'
  stopping iterations (JAX's counted through its jitted step), equal
  rotations within 0.05 deg where the fit is smooth, and where it is not
  (see test_rotation_fit_full_length) the loss it reaches;
- rot6d_to_matrix, the port's PCA against scikit-learn's, the frame
  reader / JPEG writer, the raw-scene writer, the frame filter, the config
  writer, and the numpy copies (Procrustes / PnP registration, prompt
  selection).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lab4d_tpu_torch.preprocess.libs.registration import fit_loss, rotation_gap_deg  # noqa: E402
from lab4d_tpu_torch.tools.synthetic_scene import rotation_fit_inputs  # noqa: E402
from tests.synthetic_raw import make_raw_scene as jax_make_raw_scene  # noqa: E402

EPE_TOL = 1e-2  # px, mean endpoint error of the LK flow
TSDF_TOL = 1e-5
ROT_TOL_DEG = 0.05
FEAT_TOL = 1e-5  # of the filter bank's largest response
PCA_COS = 0.9999
# the chaotic full-length fit's final loss: twice the spread of JAX's own final
# loss over 1-ulp nudges of one input element (0.03899-0.04101, 5%, 8 runs)
FIT_LOSS_RTOL = 0.10


def _textured_pair(res, shift=(6, -3)):
    import cv2

    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur(rng.random((res + 112, res + 112)).astype(np.float32), (0, 0), 4)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    dy, dx = shift
    img0 = (tex[50:50 + res, 50:50 + res, None].repeat(3, 2) * 255).astype(np.uint8)
    img1 = (tex[50 - dy:50 - dy + res, 50 - dx:50 - dx + res, None].repeat(3, 2) * 255
            ).astype(np.uint8)
    return img0, img1


def _scene_pair(res):
    from lab4d_tpu_torch.tools.synthetic_scene import raw_orbit, render_raw_frame

    K, rts = raw_orbit(8, res, 0.3)
    return tuple((render_raw_frame(rts[i], K, res)[0] * 255).astype(np.uint8) for i in (0, 1))


@pytest.mark.parametrize("res", [288, 160])
@pytest.mark.parametrize("pair", ["texture-shift", "raw-scene"])
def test_lk_flow_matches_jax(pair, res):
    from preprocess.backends import flow_jax

    from lab4d_tpu_torch.preprocess.backends import flow_classical

    img0, img1 = _textured_pair(res) if pair == "texture-shift" else _scene_pair(res)
    fw_j, bw_j = flow_jax.compute_pair_flow(img0, img1, res=res)
    fw_t, bw_t = flow_classical.compute_pair_flow(img0, img1, res=res, device="cpu")
    for got, want in ((fw_t, fw_j), (bw_t, bw_j)):
        assert got.shape == want.shape == (res, res, 3)
        epe = np.linalg.norm(got[..., :2] - want[..., :2], axis=-1)
        assert epe.mean() <= EPE_TOL, (pair, res, epe.mean(), epe.max())
        # occlusion: the cycle error / res - 0.05; its sign flips only
        # where it lies within the flows' endpoint error of zero
        occ_err = np.abs(got[..., 2] - want[..., 2])
        assert np.median(occ_err) <= EPE_TOL / res
        flips = (got[..., 2] > 0) != (want[..., 2] > 0)
        assert np.all(np.abs(want[..., 2][flips]) <= occ_err[flips] + 1e-6)
        assert flips.mean() <= 1e-2


def test_lk_flow_batch_equals_pairs():
    from lab4d_tpu_torch.preprocess.backends import flow_classical

    (a0, a1), (b0, b1) = _textured_pair(96), _scene_pair(96)
    fw, bw = flow_classical.compute_flows([a0, b0], [a1, b1], res=96, device="cpu")
    for i, (x0, x1) in enumerate(((a0, a1), (b0, b1))):
        f1, b1_ = flow_classical.compute_pair_flow(x0, x1, res=96, device="cpu")
        np.testing.assert_allclose(fw[i], f1, atol=1e-4)
        np.testing.assert_allclose(bw[i], b1_, atol=1e-4)


@pytest.mark.parametrize("crop", [256, 64])
def test_filterbank_matches_jax(crop):
    from preprocess.backends.feat_backends import filterbank_features as jax_fb

    from lab4d_tpu_torch.preprocess.backends.feat_backends import filterbank_features

    rgb = _scene_pair(crop)[0].astype(np.float32) / 255.0
    want = np.asarray(jax_fb(jnp.asarray(rgb)))
    with torch.no_grad():
        got = filterbank_features(torch.from_numpy(rgb).permute(2, 0, 1)[None])
    got = got[0].permute(1, 2, 0).numpy()
    assert got.shape == want.shape == (112, 112, 20)
    assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()


def _tsdf_inputs(n_frames=3, res=48, grid=32):
    from lab4d_tpu_torch.tools.synthetic_scene import raw_orbit, render_raw_frame

    K, rts = raw_orbit(n_frames, res, 0.3)
    depths = np.stack([render_raw_frame(rts[i], K, res)[2] for i in range(n_frames)])
    depths = np.where(depths < 5.0, depths, 0.0).astype(np.float32)  # the fg sphere only
    ax = np.linspace(-0.8, 0.8, grid)
    vox = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    return depths, np.tile(K.astype(np.float32), (n_frames, 1)), rts.astype(np.float32), vox


def test_tsdf_integration_matches_jax():
    from preprocess.scripts import tsdf_fusion as jax_tsdf

    from lab4d_tpu_torch.preprocess.scripts.tsdf_fusion import integrate

    depths, Ks, s2c, vox = _tsdf_inputs()
    trunc = np.float32(5 * 1.6 / 31)
    frames = {"depth": jnp.asarray(depths), "K": jnp.asarray(Ks), "scene2cam": jnp.asarray(s2c),
              "trunc": jnp.full((len(depths),), trunc)}
    v = vox.shape[0]
    tj, wj = jax_tsdf._integrate_scan(jnp.ones(v, jnp.float32), jnp.zeros(v, jnp.float32),
                                      jnp.asarray(vox), frames)
    tt, wt = integrate(torch.ones(v), torch.zeros(v), torch.from_numpy(vox),
                       torch.from_numpy(depths), torch.from_numpy(Ks), torch.from_numpy(s2c),
                       float(trunc))
    # a projection within rounding of a pixel boundary may pick either pixel
    p = vox.astype(np.float64) @ np.swapaxes(s2c[:, :3, :3], -1, -2).astype(np.float64)
    p = p + s2c[:, None, :3, 3]
    uv = Ks[:, None, :2] * p[..., :2] / np.maximum(p[..., 2:], 1e-6) + Ks[:, None, 2:]
    tie = (np.abs(uv - np.floor(uv) - 0.5) < 1e-4).any(-1).any(0)
    ok = ~tie
    assert tie.sum() <= 1e-2 * v, tie.sum()  # ~2e-4 of 6 coordinates each
    assert (np.asarray(wj) > 0).sum() > 1000  # the sphere's shell is observed
    np.testing.assert_array_equal(wt.numpy()[ok], np.asarray(wj)[ok])
    assert np.abs(tt.numpy()[ok] - np.asarray(tj)[ok]).max() <= TSDF_TOL


class _CountingJax:
    """Stands for `jax` inside preprocess/libs/registration.py: counts the
    calls of the jitted step, and the count at each phase's optax init."""

    def __init__(self):
        self.calls, self.inits = 0, []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def run(*args):
            self.calls += 1
            return jitted(*args)

        return run


def _jax_fit(chain, ann, max_iters, monkeypatch):
    """JAX's rotations and each phase's stopping iteration."""
    import optax

    from preprocess.libs import registration as jax_reg

    counter = _CountingJax()

    class _Optax:
        def __getattr__(self, name):
            return getattr(optax, name)

        def adam(self, lr):
            opt = optax.adam(lr)

            def init(params):
                counter.inits.append(counter.calls)
                return opt.init(params)

            return optax.GradientTransformation(init, opt.update)

    monkeypatch.setattr(jax_reg, "jax", counter)
    monkeypatch.setattr(jax_reg, "optax", _Optax())
    rots = jax_reg.optimize_canonical_rotations(chain, ann, max_iters=max_iters)
    bounds = counter.inits + [counter.calls]
    # a phase that breaks at iteration i made i + 1 steps
    stops = [b - a - 1 if b - a < max_iters else max_iters
             for a, b in zip(bounds[:-1], bounds[1:])]
    return rots, stops


@pytest.mark.parametrize("kind,max_iters", [("consistent", 2000), ("inconsistent", 20)])
def test_rotation_fit_matches_jax(kind, max_iters, monkeypatch):
    from lab4d_tpu_torch.preprocess.libs.registration import fit_canonical_rotations

    chain, ann = rotation_fit_inputs(kind)
    want, jax_stops = _jax_fit(chain, ann, max_iters, monkeypatch)
    got, stops = fit_canonical_rotations(chain, ann, max_iters=max_iters, device="cpu")
    print(f"{kind}: stopping iterations port {stops}, JAX {jax_stops}")
    assert stops == jax_stops
    assert rotation_gap_deg(got, want).max() <= ROT_TOL_DEG, rotation_gap_deg(got, want)


def test_rotation_fit_full_length(monkeypatch):
    """The inconsistent input never gets below phase 2's tolerance: both
    fits run 2000 iterations. Past ~30 of them residual angles reach the
    loss's floor (arccos clipped at 1 - 1e-4, 0.81 deg) and hop across it:
    the gradient jumps between 0 and ~1/sin(0.81 deg) on rounding, and
    Adam's normalised steps (~lr = 0.01 per quaternion element) turn that
    into steps of about a degree. The end point is then chaotic: JAX
    against itself with one input element moved by one ulp differs by
    degrees too. So the full fit is held to the loss it reaches and to
    JAX's own spread, not to 0.05 deg."""
    from lab4d_tpu_torch.preprocess.libs.registration import fit_canonical_rotations

    chain, ann = rotation_fit_inputs("inconsistent")
    want, jax_stops = _jax_fit(chain, ann, 2000, monkeypatch)
    nudged = chain.copy()
    nudged[3, 0, 0] = np.nextafter(nudged[3, 0, 0], np.float32(2))
    want_nudged, _ = _jax_fit(nudged, ann, 2000, monkeypatch)
    got, stops = fit_canonical_rotations(chain, ann, device="cpu")
    spread = rotation_gap_deg(want_nudged, want).max()
    gap = rotation_gap_deg(got, want).max()
    print(f"stops port {stops} JAX {jax_stops}; port vs JAX {gap:.3f} deg, "
          f"JAX vs JAX(1 ulp) {spread:.3f} deg")
    assert stops == jax_stops == [0, 2000]
    assert spread > ROT_TOL_DEG  # the chaos is the fit's own
    assert gap <= 4 * spread
    lj, lt = fit_loss(want, chain, ann), fit_loss(got, chain, ann)
    lj_nudged = fit_loss(want_nudged, chain, ann)
    print(f"final loss port {lt:.5f} JAX {lj:.5f} JAX(1 ulp) {lj_nudged:.5f}")
    assert abs(lt - lj) <= FIT_LOSS_RTOL * lj, (lt, lj)


def test_rot6d_to_matrix_matches_jax():
    from preprocess.backends.viewpoint_net import rot6d_to_matrix as jax_rot6d

    from lab4d_tpu_torch.preprocess.backends.viewpoint_net import rot6d_to_matrix

    x = np.random.default_rng(0).standard_normal((64, 6)).astype(np.float32)
    x[0, 3:] = 2.5 * x[0, :3]  # parallel columns: the Gram-Schmidt floor
    want = np.asarray(jax_rot6d(jnp.asarray(x)))
    got = rot6d_to_matrix(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("n", [20000, 150])  # covariance_eigh, full SVD
def test_pca_matches_sklearn(n):
    from sklearn.decomposition import PCA

    from lab4d_tpu_torch.preprocess.backends.feat_backends import pca_fit

    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 24)) * np.linspace(3, 0.1, 24) + rng.random(24)
         ) @ np.linalg.qr(rng.standard_normal((24, 24)))[0]
    x = x.astype(np.float32)
    pca = PCA(n_components=16).fit(x)
    mean, comps = pca_fit(x, 16)
    want = pca.transform(x)
    got = x @ comps.T - mean.reshape(1, -1) @ comps.T
    assert comps.shape == pca.components_.shape and comps.dtype == pca.components_.dtype
    # the same signs: each component's largest-magnitude entry positive
    assert (np.sign(comps) == np.sign(pca.components_))[np.abs(pca.components_) > 1e-3].all()
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= PCA_COS, cos.min()


def test_extract_frames_matches_jax(tmp_path):
    import imageio
    from preprocess.scripts.extract_frames import extract_frames as jax_extract

    from lab4d_tpu_torch.preprocess.scripts.extract_frames import extract_frames

    rng = np.random.default_rng(0)
    frames = [np.zeros((40, 48, 3), np.uint8)] * 2 + [
        (rng.random((40, 48, 3)) * 255).astype(np.uint8) for _ in range(4)]
    imageio.mimsave(tmp_path / "v.gif", frames)
    n_j = jax_extract(str(tmp_path / "v.gif"), str(tmp_path / "jax"))
    n_t = extract_frames(str(tmp_path / "v.gif"), str(tmp_path / "port"))
    assert n_j == n_t == 4  # the two leading black frames skipped
    for i in range(4):
        assert (tmp_path / f"port/{i:05d}.jpg").read_bytes() == \
            (tmp_path / f"jax/{i:05d}.jpg").read_bytes()


def test_raw_video_round_trip(tmp_path):
    import cv2
    from PIL import Image

    from lab4d_tpu_torch.preprocess.scripts.extract_frames import extract_frames, read_frames
    from lab4d_tpu_torch.tools.synthetic_scene import (raw_orbit, render_raw_frame,
                                                       write_raw_video)

    path = write_raw_video(str(tmp_path), "vid", num_frames=4, res=128, lead_black=2)
    decoded = list(read_frames(path))
    assert len(decoded) == 6 and not decoded[0].any() and not decoded[1].any()
    assert extract_frames(path, str(tmp_path / "out")) == 4
    K, rts = raw_orbit(4, 128, 0.12)
    for i in range(4):
        Image.fromarray(decoded[i + 2]).save(tmp_path / "want.jpg", "JPEG")
        assert (tmp_path / f"out/{i:05d}.jpg").read_bytes() == (tmp_path / "want.jpg").read_bytes()
        want = render_raw_frame(rts[i], K, 128)[0] * 255
        err = np.abs(decoded[i + 2].astype(np.float32) - want).mean()
        assert err < 6.0, err  # MJPEG's own compression of the textured orbit


def test_raw_scene_writer_matches_jax(tmp_path):
    from lab4d_tpu_torch.tools.synthetic_scene import make_raw_scene

    kw = dict(seqname="w-0000", num_frames=9, res=32, orbit_span=0.5)
    want = jax_make_raw_scene(str(tmp_path / "jax"), **kw)
    got = make_raw_scene(str(tmp_path / "port"), **kw)
    for key in ("K", "rts", "rgbs", "masks", "depths"):
        np.testing.assert_array_equal(got[key], want[key])
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                       if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                        if p.is_file())
    assert jax_files == port_files and len(jax_files) > 9 * 4
    for rel in jax_files:  # JPEGs byte for byte, npys too
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_frame_filter_and_config_match_jax(tmp_path):
    from preprocess.scripts.frame_filter import frame_filter as jax_filter
    from preprocess.scripts.write_config import write_config as jax_config

    from lab4d_tpu_torch.preprocess.scripts.frame_filter import frame_filter
    from lab4d_tpu_torch.preprocess.scripts.write_config import write_config

    roots = {}
    for who in ("jax", "port"):
        root = str(tmp_path / who)
        jax_make_raw_scene(root, seqname="ff-0000", num_frames=12, res=64, orbit_span=0.25,
                           write_masks=False, write_depth=False, write_flow=False)
        roots[who] = root
    kept_j = jax_filter("ff-0000", f"{roots['jax']}/processed")
    kept_t = frame_filter("ff-0000", f"{roots['port']}/processed", device="cpu")
    assert kept_t == kept_j and 8 <= len(kept_t) < 12, (kept_t, kept_j)
    assert jax_config("ff", roots["jax"]) == write_config("ff", roots["port"]) == 1
    cfg = [open(f"{roots[w]}/configs/ff.config").read().replace(roots[w], "ROOT")
           for w in ("jax", "port")]
    assert cfg[0] == cfg[1]


def test_register_pair_and_prompt_select_match_jax():
    from preprocess.backends.prompt_select import select_by_prompt as jax_select
    from preprocess.libs.geometry import register_pair as jax_register

    from lab4d_tpu_torch.preprocess.backends.prompt_select import select_by_prompt
    from lab4d_tpu_torch.preprocess.libs.geometry import register_pair
    from lab4d_tpu_torch.tools.synthetic_scene import project_points, raw_orbit, render_raw_frame

    K, rts = raw_orbit(8, 48, 0.3)
    f0, f1 = (render_raw_frame(rts[i], K, 48) for i in (0, 1))
    xs, ys = np.meshgrid(np.arange(48), np.arange(48), indexing="xy")
    flow = project_points(f0[3], rts[1], K) - np.stack([xs, ys], -1)
    Kmat = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1]])
    valid = np.ones((48, 48), bool)
    for method in ("procrustes", "pnp"):
        want = jax_register(f0[2], f1[2], flow, Kmat, Kmat, valid, method)
        got = register_pair(f0[2], f1[2], flow, Kmat, Kmat, valid, method)
        np.testing.assert_array_equal(got, want)
    frames = [(f0[0] * 255).astype(np.uint8), (f1[0] * 255).astype(np.uint8)]
    masks = [f0[1].astype(np.int8), f1[1].astype(np.int8)]
    for prompt in ("", "cat", "large red ball on the left"):
        want, wi = jax_select(frames, masks, prompt)
        got, gi = select_by_prompt(frames, masks, prompt)
        assert gi == wi
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
