"""The port's visualization and profiling utilities against the JAX
package's: utils/raster.py (render_mesh, look_at, turntable_frames),
utils/vis.py's draw_cams, minmax_normalize, image_to_mesh and
img2color (depth through the embedded plasma table, no matplotlib), all
equal exactly on the same numpy inputs; and utils/profile.py, whose spans
(`span`, `record_function`) appear by name in a CPU torch.profiler trace
and whose cuda_profile writes a Chrome trace.
"""

import json

import numpy as np
import pytest
import torch

from lab4d_tpu.meshlib import uv_sphere as jax_sphere
from lab4d_tpu.utils import raster as jax_raster
from lab4d_tpu.utils import vis as jax_vis
from lab4d_tpu_torch.meshlib import uv_sphere
from lab4d_tpu_torch.utils import profile, raster, vis


def _meshes_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.vertices), np.asarray(want.vertices))
    np.testing.assert_array_equal(np.asarray(got.faces), np.asarray(want.faces))
    if want.vertex_colors is None:
        assert got.vertex_colors is None
    else:
        np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)


@pytest.mark.parametrize("eye", [(0.0, 0.5, -2.0), (1.5, -0.3, 1.0)])
def test_look_at_matches_jax(eye):
    np.testing.assert_array_equal(raster.look_at(eye, (0.1, 0.0, 0.0)),
                                  jax_raster.look_at(eye, (0.1, 0.0, 0.0)))


@pytest.mark.parametrize("colors", [None, "faces", "vertices"])
def test_render_mesh_matches_jax(colors):
    mesh = uv_sphere(radius=0.5, count=[8, 8])
    verts, faces = np.asarray(mesh.vertices, np.float64), np.asarray(mesh.faces)
    rng = np.random.default_rng(0)
    col = {None: None, "faces": rng.random((len(faces), 3)),
           "vertices": rng.random((len(verts), 3))}[colors]
    w2c = raster.look_at((0.3, 0.4, -2.0))
    K = np.array([48.0, 48.0, 24.0, 24.0])
    got = raster.render_mesh(verts, faces, w2c, K, res=48, colors=col)
    want = jax_raster.render_mesh(verts, faces, w2c, K, res=48, colors=col)
    assert got.shape == (48, 48, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got < 1).any()  # the sphere is in view


def test_turntable_matches_jax():
    got = raster.turntable_frames(uv_sphere(radius=0.5, count=[6, 6]), num_frames=3, res=24)
    want = jax_raster.turntable_frames(jax_sphere(radius=0.5, count=[6, 6]), num_frames=3, res=24)
    np.testing.assert_array_equal(got, want)


def test_draw_cams_matches_jax():
    rng = np.random.default_rng(1)
    rts = np.tile(np.eye(4), (3, 1, 1))
    rts[:, :3, 3] = rng.standard_normal((3, 3))
    _meshes_equal(vis.draw_cams(rts, scale=0.2), jax_vis.draw_cams(rts, scale=0.2))
    _meshes_equal(vis.draw_cams(rts[:, :3]), jax_vis.draw_cams(rts[:, :3]))


def test_minmax_normalize_matches_jax():
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(vis.minmax_normalize(x), jax_vis.minmax_normalize(x))
    np.testing.assert_array_equal(vis.minmax_normalize(np.ones(3)), jax_vis.minmax_normalize(np.ones(3)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_depth_colors_match_jax(dtype):
    rng = np.random.default_rng(4)
    depth = (rng.random((2, 33, 31)) * 4).astype(dtype)
    depth[0, :5] = 0.0  # background
    for tag, img in (("depth", depth[0]), ("depth", depth[1][..., None]), ("mask", depth[0] / 4)):
        np.testing.assert_array_equal(vis.img2color(tag, img), jax_vis.img2color(tag, img))
    x = np.array([0.0, 1.0, 1 - 1e-12, -0.5, 1.5, np.nan, 0.5, 255 / 256], dtype)
    import matplotlib.cm as cm

    np.testing.assert_array_equal(vis.plasma(x), cm.plasma(x)[..., :3])


@pytest.mark.parametrize("with_mask", [False, True])
def test_image_to_mesh_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    rgb = rng.random((9, 11, 3))
    depth = 1.0 + 0.05 * rng.random((9, 11))
    depth[4:, 6:] += 0.5  # a discontinuity whose edges are dropped
    mask = rng.random((9, 11)) > 0.2 if with_mask else None
    K = (10.0, 10.0, 5.0, 4.0)
    got = vis.image_to_mesh(rgb, depth, K, mask=mask)
    _meshes_equal(got, jax_vis.image_to_mesh(rgb, depth, K, mask=mask))
    assert 0 < len(got.faces) < 2 * 8 * 10


@profile.record_function("lab4d_span_fn")
def _spanned(x):
    return x * 2


def test_spans_appear_in_a_cpu_trace():
    """Under a profiler, `span` and `record_function` open ranges of their names."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _spanned(torch.ones(3))
        with profile.span("lab4d_span_block"):
            torch.ones(3) - 1
    names = {e.key for e in prof.key_averages()}
    assert {"lab4d_span_fn", "lab4d_span_block"} <= names


def test_cuda_profile_writes_a_chrome_trace(tmp_path):
    with profile.cuda_profile(str(tmp_path), "t"):
        _spanned(torch.ones(4))
    trace = json.loads((tmp_path / "trace_t.json").read_text())
    assert any(e.get("name") == "lab4d_span_fn" for e in trace["traceEvents"])
    with profile.cuda_profile(str(tmp_path), "off", enabled=False):
        pass
    assert not (tmp_path / "trace_off.json").exists()
