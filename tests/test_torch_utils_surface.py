"""The public helpers of the JAX package's utils/ and nnutils/ that no path
of either package calls (the dual-quaternion algebra, the SO(3) / SE(3)
maps, the dense grid and chunked evaluation, two camera trajectories, two
losses, ScaleLayer), each held against its JAX function on the same numpy
inputs: unit quaternions, SE(3) matrices and points from
np.random.default_rng(0) at batch shapes (7,) and (3, 5), fp32. Every case
is within atol 1e-6 unless its row states another bound. Then an `ast`
walk: every public top-level name of lab4d_tpu/ and preprocess/ has a
counterpart of the same name in lab4d_tpu_torch/, apart from the names
listed in DELIBERATE with their reasons.
"""

import ast
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(7,), (3, 5)]


def unit_quat(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def se3(rng, shape):
    from scipy.spatial.transform import Rotation

    q = unit_quat(rng, shape).reshape(-1, 4).astype(np.float64)
    mat = np.tile(np.eye(4), (len(q), 1, 1))
    mat[:, :3, :3] = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
    mat[:, :3, 3] = rng.normal(size=(len(q), 3))
    return mat.reshape(shape + (4, 4)).astype(np.float32)


def dual_quat(rng, shape):
    """A unit dual quaternion (q, 0.5 (0, t) q)."""
    q = unit_quat(rng, shape)
    t = rng.normal(size=shape + (3,)).astype(np.float32)
    tq = np.concatenate([np.zeros(shape + (1,), np.float32), t], -1)
    w1, x1, y1, z1 = np.moveaxis(tq, -1, 0)
    w2, x2, y2, z2 = np.moveaxis(q, -1, 0)
    d = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2],
                 -1)
    return q, (0.5 * d).astype(np.float32)


def points(rng, shape, dim=3):
    return rng.normal(size=shape + (dim,)).astype(np.float32)


def _row_fn(lib):
    """A row-wise nonlinear function of (n, 3) rows -> (n, 2) in numpy,
    jnp or torch."""
    def fn(x):
        return lib.stack([lib.sin(x[:, 0]) * x[:, 1], x[:, 2] ** 2 - x[:, 0]], -1)
    return fn


def _blend_inputs(rng, shape):
    """Weights (..., N=4, K=3) and bases ((..., K, T=2, 4) x 2)."""
    w = rng.uniform(size=shape + (4, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return w, dual_quat(rng, shape + (3, 2))


# name[/variant] -> (module, inputs(rng, shape) -> positional args)
CASES = {
    "standardize_quaternion": ("quat", lambda r, s: (unit_quat(r, s),)),
    "quaternion_translation_mul": ("quat", lambda r, s: (
        (unit_quat(r, s), points(r, s)), (unit_quat(r, s), points(r, s)))),
    "se3_to_dual_quaternion": ("quat", lambda r, s: (se3(r, s),)),
    "dual_quaternion_apply": ("quat", lambda r, s: (dual_quat(r, s), points(r, s))),
    "dual_quaternion_norm": ("quat", lambda r, s: (dual_quat(r, s),)),
    "dual_quaternion_d_conjugate": ("quat", lambda r, s: (dual_quat(r, s),)),
    "dual_quaternion_3rd_conjugate": ("quat", lambda r, s: (dual_quat(r, s),)),
    "dual_quaternion_linear_blend": ("quat", _blend_inputs),
    "hat_map": ("geom", lambda r, s: (points(r, s),)),
    "so3_to_exp_map": ("geom", lambda r, s: (points(r, s),)),
    "se3_mat2rt": ("geom", lambda r, s: (se3(r, s),)),
    "se3_vec2mat": ("geom", lambda r, s: (np.concatenate([points(r, s), unit_quat(r, s)], -1),)),
    "se3_vec2mat/6": ("geom", lambda r, s: (np.concatenate([points(r, s), points(r, s)], -1),)),
    "se3_mat2vec": ("geom", lambda r, s: (se3(r, s),)),
    "se3_mat2vec/6": ("geom", lambda r, s: (se3(r, s), 6)),
    "entropy_loss": ("loss", lambda r, s: (
        r.dirichlet(np.ones(5), size=s).astype(np.float32),)),
    "masked_mean": ("loss", lambda r, s: (points(r, s), r.uniform(size=s + (3,)) < 0.5)),
}
# se3_mat2vec(outdim=6) goes through arccos(w), whose slope 1 / sqrt(1 - w^2)
# scales w's fp32 rounding: a relative bound of 1e-5 on the axis-angle
RTOL = {"se3_mat2vec/6": 1e-5}


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return np.asarray(x.detach().numpy() if hasattr(x, "detach") else x, np.float64)


def _to(lib_array, args):
    if isinstance(args, tuple):
        return tuple(_to(lib_array, a) for a in args)
    if isinstance(args, np.ndarray):
        return lib_array(args)
    return args


def _assert_close(got, want, rtol=0.0, atol=1e-6):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w, rtol, atol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", sorted(CASES))
def test_helper_matches_jax(case, shape):
    import importlib

    import jax.numpy as jnp
    import torch

    name = case.split("/")[0]
    module, make = CASES[case]
    jmod = importlib.import_module(f"lab4d_tpu.utils.{module}")
    pmod = importlib.import_module(f"lab4d_tpu_torch.utils.{module}")
    args = make(np.random.default_rng(0), shape)
    want = getattr(jmod, name)(*_to(jnp.asarray, args))
    got = getattr(pmod, name)(*_to(torch.from_numpy, args))
    _assert_close(got, want, rtol=RTOL.get(case, 0.0), atol=1e-6)


def test_so3_to_exp_map_is_a_rotation_near_zero():
    """Below eps the angle is clamped, as in JAX: the map stays finite and
    agrees with JAX's at angles from 0 to 1e-5."""
    import jax.numpy as jnp
    import torch

    from lab4d_tpu.utils.geom import so3_to_exp_map as jax_exp
    from lab4d_tpu_torch.utils.geom import so3_to_exp_map

    so3 = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    so3 *= np.array([0.0, 1e-9, 1e-7, 1e-6, 3e-6, 1e-5], np.float32)[:, None]
    got = so3_to_exp_map(torch.from_numpy(so3))
    assert torch.isfinite(got).all()
    _assert_close(got, jax_exp(jnp.asarray(so3)))


@pytest.mark.parametrize("grid_size", [2, 9])
def test_sample_grid_matches_jax(grid_size):
    import jax.numpy as jnp
    import torch

    from lab4d_tpu.utils.geom import sample_grid as jax_grid
    from lab4d_tpu_torch.utils.geom import sample_grid

    rng = np.random.default_rng(0)
    lo = rng.normal(size=3).astype(np.float32)
    aabb = np.stack([lo, lo + rng.uniform(0.5, 2.0, size=3).astype(np.float32)])
    got = sample_grid(torch.from_numpy(aabb), grid_size)
    assert got.shape == (grid_size ** 3, 3) and got.dtype == torch.float32
    _assert_close(got, jax_grid(jnp.asarray(aabb), grid_size))


@pytest.mark.parametrize("chunk_size", [4, 7, 30, 64])
def test_eval_func_chunk_matches_jax(chunk_size):
    """The chunks in order, the last one short, concatenated: the same rows
    as JAX's at every chunk size (a chunk larger than the data is one call)."""
    import jax.numpy as jnp
    import torch

    from lab4d_tpu.utils.geom import eval_func_chunk as jax_chunk
    from lab4d_tpu_torch.utils.geom import eval_func_chunk

    data = points(np.random.default_rng(0), (30,))
    calls = []

    def fn(x):
        calls.append(len(x))
        return _row_fn(torch)(x)

    got = eval_func_chunk(fn, torch.from_numpy(data), chunk_size)
    assert calls == [min(chunk_size, 30 - i) for i in range(0, 30, chunk_size)]
    _assert_close(got, jax_chunk(_row_fn(jnp), jnp.asarray(data), chunk_size))


@pytest.mark.parametrize("kwargs", [{}, {"axis": (1, 0, 0), "distance": 2.0, "angle": 35.0}])
def test_get_fixed_cam_matches_jax(kwargs):
    from lab4d_tpu.utils.cam_traj import get_fixed_cam as jax_fixed
    from lab4d_tpu_torch.utils.cam_traj import get_fixed_cam

    got, want = get_fixed_cam(5, **kwargs), jax_fixed(5, **kwargs)
    assert got.shape == (5, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kwargs", [{}, {"max_angle": 20.0, "cycles": 3}])
def test_get_orbit_camera_matches_jax(kwargs):
    from lab4d_tpu.utils.cam_traj import get_orbit_camera as jax_orbit
    from lab4d_tpu_torch.utils.cam_traj import get_orbit_camera

    got, want = get_orbit_camera(12, **kwargs), jax_orbit(12, **kwargs)
    assert got.shape == (12, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_masked_mean_of_an_empty_mask_is_zero():
    import jax.numpy as jnp
    import torch

    from lab4d_tpu.utils.loss import masked_mean as jax_mean
    from lab4d_tpu_torch.utils.loss import masked_mean

    v = points(np.random.default_rng(0), (4,))
    mask = np.zeros_like(v, bool)
    got = masked_mean(torch.from_numpy(v), torch.from_numpy(mask))
    assert float(got) == float(jax_mean(jnp.asarray(v), jnp.asarray(mask))) == 0.0


@pytest.mark.parametrize("scale", [None, 0.5])
def test_scale_layer_matches_flax(scale):
    """ScaleLayer at its default (0.1) and at 0.5: the same products as the
    flax module, and no parameter (flax's init has none either), so the
    weight bridge needs nothing for it."""
    import jax
    import jax.numpy as jnp
    import torch

    from lab4d_tpu.nnutils.base import ScaleLayer as FlaxScale
    from lab4d_tpu_torch.nnutils.base import ScaleLayer

    x = points(np.random.default_rng(0), (3, 5), dim=8)
    kw = {} if scale is None else {"scale": scale}
    jmod, pmod = FlaxScale(**kw), ScaleLayer(**kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert not jax.tree_util.tree_leaves(variables)
    assert not list(pmod.parameters()) and not pmod.state_dict()
    _assert_close(pmod(torch.from_numpy(x)), jmod.apply(variables, jnp.asarray(x)), atol=0)


# Public names of the JAX package with no namesake in the port, and why.
DELIBERATE = {
    # ROADMAP's "Do not port" list: the TPU mesh, a TPU gather layout, the
    # TPU profiler
    "batch_pspec", "batch_sharding", "init_opt_state", "make_mesh", "param_pspecs",
    "param_shardings", "replicated", "shard_batch", "permutation_gather", "tpu_profile",
    # absl flags and their entry points: flagfile.py and the argparse CLIs
    # (tests/test_torch_cli_flags.py, tests/test_torch_flagfile.py)
    "get_config", "save_config", "TrainModelConfig", "TrainOptConfig", "RenderFlags",
    "ExportMeshFlags", "ReanimateFlags", "main_fn",
    # optax, jnp, flax and Pallas-layout plumbing whose results the port
    # computes by other means
    "ClipState", "interp_wt_jnp", "torch_linear_init", "fourier_embed_blocks",
    # spans are placed by hand; nothing called them
    "annotate", "record_class", "decorate_module",
}
# counterparts under other names (tested by the preprocessing tests)
RENAMED = {"load_params": "load_model", "frame_features_net": "frames_features_net",
           "optimize_canonical_rotations": "fit_canonical_rotations"}
# modules of the JAX package with no module of the same path in the port
DELIBERATE_MODULES = {
    "lab4d_tpu/config.py": "flagfile.py and the argparse CLIs",
    "lab4d_tpu/parallel/mesh_utils.py": "do not port",
    "preprocess/backends/flow_jax.py": "preprocess/backends/flow_classical.py",
}


def _py_files(root):
    for dirpath, _, files in os.walk(os.path.join(REPO, root)):
        if "__pycache__" not in dirpath:
            yield from (os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py"))


def _top_level_names(path, public=True):
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign) and not public:
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")} if public else names


def test_every_public_name_has_a_port_counterpart():
    port = set()
    for path in _py_files("lab4d_tpu_torch"):
        port |= _top_level_names(path, public=False)
    missing = set()
    for root in ("lab4d_tpu", "preprocess"):
        for path in _py_files(root):
            missing |= _top_level_names(path) - port
    want = DELIBERATE | set(RENAMED)
    assert missing == want, sorted(missing ^ want)
    assert set(RENAMED.values()) <= port


def test_every_module_has_a_port_counterpart():
    """Every module of the JAX package, the stage scripts of preprocess/
    among them, has a module of the same path in the port."""
    missing = set()
    for root in ("lab4d_tpu", "preprocess"):
        for path in _py_files(root):
            rel = os.path.relpath(path, REPO)
            port = os.path.join(REPO, "lab4d_tpu_torch",
                                rel.split("/", 1)[1] if rel.startswith("lab4d_tpu/") else rel)
            if not os.path.exists(port):
                missing.add(rel)
    assert missing == set(DELIBERATE_MODULES), sorted(missing ^ set(DELIBERATE_MODULES))
