"""The port's random streams, which are the JAX package's: the model's
init at flax's PRNGKey(0), the prior fit's draws and the training step's
draws, all derived on the host from `jax.random` keys through
utils/jax_random.py and utils/flax_rng.py.

- `init_params_like_jax(model, key)`: every random leaf of the DVRModel
  drawn as `DVRModel.init({"params": key, ...})` draws it. A leaf's key
  is its flax scope's (bridge.torch_to_flax_path) make_rng("params") at
  the leaf's place in the scope's creation order: a BaseMLP creates
  linear_1, bias_1, ..., linear_final, bias_final, a dense layer kernel
  then bias, an embedding its table alone. Constant leaves (log-scales,
  zero tables, the identity quaternions) keep the module's own values,
  which are flax's.
- `training_draws(model, step, num_rays)`: every draw of training step
  `step` (DVRModel.step_draws moves them to the device, `to_device`);
  `prior_fit_eikonal(step, cate, n)`: the geometry fit's eikonal points.
- `FIXTURE_SPEC` / `compare_fixture`: the entries of
  tests/data/jax_streams.npz, JAX's values, which chip_smoke.py
  [streams] holds this module against on the card's host.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from lab4d_tpu_torch import bridge
from lab4d_tpu_torch.utils import flax_rng
from lab4d_tpu_torch.utils import jax_random as jr

_MLP_LEAF = re.compile(r"^(linear|bias)_(\d+|final)$")


def _leaf_init(path: Tuple[str, ...], tree: Dict) -> Tuple[str, int, int]:
    """(kind, count, fan_in) of the flax leaf at `path`: kind "uniform"
    (torch_linear_init), "embed" or "const"; count: its place in its
    scope's creation order."""
    *scope, leaf = path
    siblings = tree
    for p in scope:
        siblings = siblings[p]
    m = _MLP_LEAF.match(leaf)
    if m:
        kind, idx = m.groups()
        depth = sum(1 for k in siblings if re.match(r"^linear_\d+$", k))
        layer = depth + 1 if idx == "final" else int(idx)
        fan_in = siblings[f"linear_{idx}"].shape[0]
        return "uniform", 2 * layer - (kind == "linear"), fan_in
    if leaf in ("kernel", "bias") and "kernel" in siblings:
        return "uniform", 1 if leaf == "kernel" else 2, siblings["kernel"].shape[0]
    if leaf == "embedding":
        return "embed", 1, 0
    return "const", 0, 0


def init_params_like_jax(model: torch.nn.Module, key) -> torch.nn.Module:
    """Draw `model`'s random leaves as flax's init from the params root
    `key` (a jax_random key) draws them, in place; returns the model."""
    state = {n: p.detach().cpu() for n, p in model.named_parameters()}
    tree = bridge.params_to_flax(state)
    drawn = {}
    for path, value in bridge._flatten(tree):
        kind, count, fan_in = _leaf_init(path, tree)
        if kind == "const":
            continue
        k = flax_rng.make_rng(key, path[:-1], count)
        bridge._set_path(drawn, path, flax_rng.torch_linear_uniform(k, value.shape, fan_in)
                         if kind == "uniform" else flax_rng.embed_normal(k, value.shape))
    with torch.no_grad():
        params = dict(model.named_parameters())
        for name, t in bridge.params_from_flax(drawn).items():
            params[name].copy_(t)
    return model


# ------------------------------------------------------------------- draws
#
# The training step's key is fold_in(PRNGKey(42), step), split into the
# "aux" and "swap" roots (lab4d_tpu/engine/trainer.py). Every aux draw of
# the step is made in a field's scope ("fields", "field_params_<cate>"),
# counted there in the order the JAX model calls them: the eikonal rays
# and the global-match candidates in the query, then the visibility-decay,
# soft-deformation and gauss-skin points of the regularizers (each where
# the field has it). The prior fit's step s draws its eikonal rays from
# fold_in(PRNGKey(7), s) in the same scope.

STEP_SEED, PRIOR_FIT_SEED = 42, 7
EIKONAL_RATIO = 16  # NeRF.compute_eikonal's sample_ratio
SAMPLES_PER_RAY = 64  # NeRF.query_field's training samples per ray
MATCH_CANDIDATES = 1024  # FeatureNeRF.global_match's num_candidates
VIS_POINTS, SOFT_POINTS, GAUSS_POINTS = 512, 1024, 2048


def step_keys(step: int):
    """The (aux, swap) root keys of training step `step`."""
    aux, swap = jr.split(jr.fold_in(jr.PRNGKey(STEP_SEED), step))
    return aux, swap


def field_scope(cate: str) -> Tuple[str, ...]:
    return ("fields", f"field_params_{cate}")


def field_aux_terms(field, with_match: bool = True) -> Tuple[str, ...]:
    """The make_rng("aux") calls of one training step in a field's scope,
    in order."""
    from lab4d_tpu_torch.nnutils.feature import FeatureNeRF
    from lab4d_tpu_torch.nnutils.warping import ComposedWarp

    terms = ["eikonal"]
    if with_match and isinstance(field, FeatureNeRF):
        terms.append("match")
    terms.append("vis")
    if isinstance(getattr(field, "warp", None), ComposedWarp):
        terms.append("soft")
    if getattr(field, "has_skinning", False):
        terms.append("gauss")
    return tuple(terms)


def eikonal_rays(key, num_rays: int) -> np.ndarray:
    """The eikonal term's rays: choice(key, num_rays, num_rays // 16,
    replace=False), at least one."""
    return jr.choice(key, num_rays, max(1, num_rays // EIKONAL_RATIO))


def field_step_draws(terms, aux_root, scope: Tuple[str, ...], num_rays: int, num_inst: int = 1,
                     frame_info=None) -> Dict[str, np.ndarray]:
    """One field's aux draws of a training step (terms: field_aux_terms)
    on a (global) batch of num_rays rays, under the step's aux root key,
    at the field's flax scope; num_inst: its instance count, frame_info
    its FrameInfo (the soft deformation's frames and videos)."""
    out = {}
    for count, term in enumerate(terms, start=1):
        key = flax_rng.make_rng(aux_root, scope, count)
        if term == "eikonal":
            out["eikonal_idx"] = eikonal_rays(key, num_rays)
        elif term == "match":
            total = num_rays * SAMPLES_PER_RAY
            out["match_idx"] = jr.randint(key, (min(MATCH_CANDIDATES, total),), 0, total)
        elif term == "vis":
            r1, r2 = jr.split(key)
            out["vis_u"] = jr.uniform(r1, (VIS_POINTS, 3))
            out["vis_inst"] = jr.randint(r2, (VIS_POINTS,), 0, num_inst)
        elif term == "soft":
            r1, r2, r3 = jr.split(key, 3)
            out["soft_u"] = jr.uniform(r1, (SOFT_POINTS, 3))
            out["soft_frame"] = jr.randint(r2, (SOFT_POINTS,), 0, frame_info.num_frames_raw)
            out["soft_inst"] = jr.randint(r3, (SOFT_POINTS,), 0, frame_info.num_vids)
        else:
            out["gauss_u"] = jr.uniform(key, (GAUSS_POINTS, 3))
    return out


def training_draws(model, step: int, num_rays: int, with_match: bool = True) -> Dict:
    """Every draw of training step `step` on a global batch of num_rays
    rays, on the host: {cate: {name: array}}, and "swap_key" (the swap
    root, from which each instance-code swap derives its draw at its own
    scope; embedding.SwapDraws)."""
    aux, swap = step_keys(step)
    out = {}
    for cate in model.fields.categories:
        field = model.fields.field_params[cate]
        out[cate] = field_step_draws(field_aux_terms(field, with_match), aux, field_scope(cate),
                                     num_rays, field.num_inst, field.frame_info)
    out["swap_key"] = swap
    return out


def prior_fit_eikonal(step: int, cate: str, num_points: int) -> np.ndarray:
    """The eikonal rays of prior-fit step `step` over num_points points
    (one ray each)."""
    aux = jr.fold_in(jr.PRNGKey(PRIOR_FIT_SEED), step)
    return eikonal_rays(flax_rng.make_rng(aux, field_scope(cate), 1), num_points)


def to_device(draws: Dict, device) -> Dict:
    """The numpy arrays of `draws` ({cate: {name: array}}, other entries
    kept as they are) on `device` in one host-to-device copy: the int
    arrays as int64, the float arrays as float32, packed into one byte
    buffer."""
    items = [(c, k, np.asarray(v)) for c, d in draws.items() if isinstance(d, dict)
             for k, v in d.items() if isinstance(v, np.ndarray)]
    ints = [(c, k, v.astype(np.int64)) for c, k, v in items if v.dtype.kind in "iu"]
    floats = [(c, k, v.astype(np.float32)) for c, k, v in items if v.dtype.kind == "f"]
    parts = [v for _, _, v in ints + floats]
    if not parts:
        return draws
    buf = torch.from_numpy(np.concatenate([p.reshape(-1).view(np.uint8) for p in parts]))
    buf = buf.to(device, non_blocking=False)
    out = {c: (dict(d) if isinstance(d, dict) else d) for c, d in draws.items()}
    offset = 0
    for (c, k, v), dtype in [(x, torch.int64) for x in ints] + [(x, torch.float32) for x in floats]:
        out[c][k] = buf[offset:offset + v.nbytes].view(dtype).reshape(v.shape)
        offset += v.nbytes
    return out


# ----------------------------------------------------------------- fixture
#
# tests/data/jax_streams.npz holds what JAX gives for FIXTURE_SPEC (written
# by `python -m tests.jax_streams_fixture` on a host with JAX); chip_smoke.py
# [streams] holds this module's replica against it on the card's host.

FLAGSHIP_RAYS = 4096  # a flagship step: 4,096 rays of 64 samples
_FG = ("fields", "field_params_fg")
FIXTURE_SPEC = (
    # scope keys: (name, "key", root, path, count)
    ("key_params_basefield", "key", "params", _FG + ("basefield", "backbone"), 1),
    ("key_params_inst_code", "key", "params", _FG + ("basefield", "inst_embedding", "mapping"), 1),
    ("key_params_sdf_bias", "key", "params", _FG + ("sdf_head",), 2),
    *((f"key_step0_aux_fg_{n}", "key", "aux0", _FG, n) for n in range(1, 5)),
    ("key_fit0_aux_fg", "key", "fit0", _FG, 1),
    # the flagship fg / skel-quad model's first training step and prior-fit step
    ("step0_fg", "step", "aux0", _FG, FLAGSHIP_RAYS),  # eikonal, match, vis, gauss
    ("fit0_fg_eikonal", "fit", "fit0", _FG, 256),
    # the first 16 values of one leaf per initializer kind: (name, kind,
    # root, path, count, shape, fan_in)
    ("leaf_uniform", "uniform", "params", _FG + ("basefield", "backbone"), 1, (95, 128), 95),
    ("leaf_embed", "embed", "params", _FG + ("basefield", "inst_embedding", "mapping"), 1,
     (1, 32), 32),
    ("leaf_lecun", "lecun", "params", ("Conv_0",), 1, (3, 3, 3, 32), 27),
    # the category model's first swap at its base MLP's code: 8 rows of 8 codes
    ("swap0_basefield", "swap", "swap0", _FG + ("basefield", "inst_embedding"), 1, (8,), 8),
)


FLAGSHIP_TERMS = ("eikonal", "match", "vis", "gauss")  # field_aux_terms of the fg field


def fixture_roots():
    aux, swap = step_keys(0)
    return {"params": jr.PRNGKey(0), "aux0": aux, "swap0": swap,
            "fit0": jr.fold_in(jr.PRNGKey(PRIOR_FIT_SEED), 0)}


def fixture_values(spec=FIXTURE_SPEC) -> Dict[str, np.ndarray]:
    """This module's values of each fixture entry (flat names: a step's
    draws as "<name>/<draw>")."""
    roots = fixture_roots()
    out = {}
    for name, kind, root, path, count, *rest in spec:
        root = roots[root]
        if kind == "key":
            out[name] = flax_rng.make_rng(root, path, count)
        elif kind == "step":
            draws = field_step_draws(FLAGSHIP_TERMS, root, path, count)
            out.update({f"{name}/{k}": v for k, v in draws.items()})
        elif kind == "fit":
            out[name] = eikonal_rays(flax_rng.make_rng(root, path, 1), count)
        elif kind == "swap":
            (rows,), num_inst = rest
            r_id, r_mask = jr.split(flax_rng.make_rng(root, path, count))
            out[name + "/rand_id"] = jr.randint(r_id, (rows,), 0, num_inst)
            out[name + "/u"] = jr.uniform(r_mask, (rows,))
        else:
            shape, fan_in = rest
            key = flax_rng.make_rng(root, path, count)
            leaf = (flax_rng.torch_linear_uniform(key, shape, fan_in) if kind == "uniform" else
                    flax_rng.embed_normal(key, shape) if kind == "embed" else
                    flax_rng.lecun_normal(key, shape))
            out[name] = leaf.reshape(-1)[:16]
    return out


NORMAL_ENTRIES = ("leaf_embed", "leaf_lecun")  # erfinv-drawn: held to 2 ulp


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max()) if a.size else 0


def compare_fixture(fixture) -> list:
    """This module's values against a fixture of JAX's (a mapping of
    arrays, e.g. np.load of tests/data/jax_streams.npz, whose "spec" is the
    FIXTURE_SPEC it was written for): [(name, ulps or mismatches, allowed)]
    per array; keys, ints and uniform floats must be equal, the normal
    draws (NORMAL_ENTRIES) within 2 ulp."""
    import json

    spec = json.loads(str(fixture["spec"]))
    if spec != json.loads(json.dumps(FIXTURE_SPEC)):
        raise ValueError("the fixture was written for another FIXTURE_SPEC")
    rows = []
    for name, got in fixture_values().items():
        want = np.asarray(fixture[name])
        if want.shape != got.shape:
            raise ValueError(f"{name}: shape {got.shape}, the fixture's {want.shape}")
        if want.dtype.kind == "f":
            rows.append((name, _ulps(want, got), 2 if name in NORMAL_ENTRIES else 0))
        else:
            rows.append((name, int(np.sum(want.astype(np.int64) != got.astype(np.int64))), 0))
    return rows
