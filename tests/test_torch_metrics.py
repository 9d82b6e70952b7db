"""The port's mesh metrics (lab4d_tpu_torch/utils/metrics.py) against the
JAX package's (lab4d_tpu/utils/metrics.py) on the CPU: area-weighted
surface samples, the symmetric Chamfer distance and the F-score, for the
same meshes and seed, equal bit for bit (the same numpy arithmetic); and
compare_psnr's canonical-mesh Chamfer against the GT sphere as
scripts/compare_reference_psnr.py's compare_meshes measures it.
"""

import numpy as np
import pytest

from lab4d_tpu import meshlib as jmesh
from lab4d_tpu.utils import metrics as jmetrics
from lab4d_tpu_torch import meshlib as pmesh
from lab4d_tpu_torch.utils import metrics as pmetrics


def _pair(pkg, radius=0.5, count=(32, 32), shift=(0.0, 0.0, 0.0), scale=(1.0, 1.0, 1.0)):
    """A GT sphere and a shifted, stretched sphere of the package's meshlib."""
    gt = pkg.uv_sphere(radius=0.5, count=[32, 32])
    other = pkg.uv_sphere(radius=radius, count=list(count))
    verts = np.asarray(other.vertices, np.float32) * np.float32(scale) + np.float32(shift)
    return gt, pkg.Mesh(verts, np.asarray(other.faces))


CASES = {"near": dict(radius=0.48, count=(24, 20), shift=(0.01, 0.0, -0.02)),
         "stretched": dict(radius=0.5, count=(16, 16), scale=(1.3, 0.8, 1.0)),
         "same": dict()}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 3])
def test_surface_samples_match_jax(case, seed):
    _, theirs = _pair(jmesh, **CASES[case])
    _, ours = _pair(pmesh, **CASES[case])
    want = jmetrics.sample_mesh_points(theirs, 2000, seed=seed)
    np.testing.assert_array_equal(pmetrics.sample_mesh_points(ours, 2000, seed=seed), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chamfer_and_fscore_match_jax(case):
    jgt, jother = _pair(jmesh, **CASES[case])
    pgt, pother = _pair(pmesh, **CASES[case])
    want = jmetrics.chamfer_distance(jother, jgt, n=1500)
    assert pmetrics.chamfer_distance(pother, pgt, n=1500) == want
    assert (want < 1e-6) == (case == "same")
    for thr in (0.02, 0.05):
        assert (pmetrics.fscore(pother, pgt, threshold=thr, n=1500)
                == jmetrics.fscore(jother, jgt, threshold=thr, n=1500))


def test_empty_and_faceless_meshes_match_jax():
    verts = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    faceless_j = jmesh.Mesh(verts, np.zeros((0, 3), np.int64))
    faceless_p = pmesh.Mesh(verts, np.zeros((0, 3), np.int64))
    np.testing.assert_array_equal(pmetrics.sample_mesh_points(faceless_p, 100),
                                  jmetrics.sample_mesh_points(faceless_j, 100))
    gt_j, gt_p = jmesh.uv_sphere(0.5, [8, 8]), pmesh.uv_sphere(0.5, [8, 8])
    assert (pmetrics.chamfer_distance(faceless_p, gt_p, n=1500)
            == jmetrics.chamfer_distance(faceless_j, gt_j, n=1500))
    empty_p = pmesh.Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    assert np.isnan(pmetrics.chamfer_distance(empty_p, gt_p))
    assert np.isnan(pmetrics.fscore(empty_p, gt_p))
