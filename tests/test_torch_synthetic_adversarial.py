"""The port's synthetic scenes for the trainers and the adversarial
validation against the JAX package's, on the CPU:

- tools/synthetic_adversarial.py against tests/synthetic_adversarial.py:
  render_frame at several phases, and with an explicit camera (`cam_rt`)
  against the JAX renderer with its cam_pose replaced, as
  scripts/train_viewpoint.py does; make_adversarial_dataset (16 frames at
  64^2) artifact by artifact, the JPEGs and meshes byte for byte;
- tools/synthetic_scene.py render_raw_frame with `tex_freqs` and
  `fg_radius` against tests/synthetic_raw.py render_frame with its
  texture and fg radius replaced as the JAX trainers replace them, bit
  for bit.
"""

import os

import numpy as np
import pytest

from lab4d_tpu_torch.tools import synthetic_adversarial as port_sa
from lab4d_tpu_torch.tools import synthetic_scene as port_sr


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("t", [0.0, 0.13, 0.5, 0.91])
def test_render_frame(t):
    import tests.synthetic_adversarial as sa

    K = (70.0, 66.0, 32.0, 32.0)
    _same(port_sa.render_frame(t, K, 64), sa.render_frame(t, K, 64))


def test_render_frame_explicit_camera(monkeypatch):
    import tests.synthetic_adversarial as sa

    rt = np.eye(4)
    rt[:3, :3] = port_sr._rodrigues(np.array([0.3, -1.1, 0.4]))
    rt[2, 3] = 2.9
    monkeypatch.setattr(sa, "cam_pose", lambda _t, dist=2.6: rt)
    K = (80.0, 75.0, 32.0, 32.0)
    _same(port_sa.render_frame(0.37, K, 64, cam_rt=rt), sa.render_frame(0.37, K, 64))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def test_make_adversarial_dataset(tmp_path):
    import tests.synthetic_adversarial as sa

    sa.make_adversarial_dataset(str(tmp_path / "jax"), num_frames=16, res=64, feat_res=16)
    port_sa.make_adversarial_dataset(str(tmp_path / "port"), num_frames=16, res=64, feat_res=16)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".jpg") for k in got) == 32
    for rel, path in want.items():
        if rel.endswith(".npy"):
            a, b = np.load(path), np.load(got[rel])
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            np.testing.assert_array_equal(b, a, err_msg=rel)
        elif rel.endswith(".config"):  # img_path names the root
            text = open(path).read().replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            assert open(got[rel]).read() == text
        else:  # jpg, obj: byte for byte
            assert open(got[rel], "rb").read() == open(path, "rb").read(), rel


@pytest.mark.parametrize("freqs,scale", [(None, 1.0), ((2.5, 7.0, 11.9), 1.0),
                                         ((3.3, 4.4, 5.5), 0.55), (None, 1.6)])
def test_render_raw_frame_texture_and_radius(monkeypatch, freqs, scale):
    import tests.synthetic_raw as sr

    f = None if freqs is None else np.array(freqs)
    orig_tex = sr._texture

    def tex(p, freqs=None):
        return orig_tex(p, freqs=tuple(f if freqs is None else freqs))

    if f is not None:
        monkeypatch.setattr(sr, "_texture", tex)
    monkeypatch.setattr(sr, "FG_RADIUS", sr.FG_RADIUS * scale)
    rt = port_sr.orbit_pose(0.2, dist=3.3)
    np.testing.assert_array_equal(rt, sr.orbit_pose(0.2, dist=3.3))
    K = (60.0, 70.0, 24.0, 24.0)
    _same(port_sr.render_raw_frame(rt, K, 48, tex_freqs=f, fg_radius=0.5 * scale),
          sr.render_frame(rt, K, 48))
