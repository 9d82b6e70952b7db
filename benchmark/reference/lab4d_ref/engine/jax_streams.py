"""The training step's random draws, which are the JAX package's, derived
on the host from `jax.random` keys through utils/jax_random.py and
utils/flax_rng.py: `training_draws(model, step, num_rays)` makes every
draw of training step `step`, `to_device` moves them to the device in one
copy (DVRModel.step_draws).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.lab4d_ref.utils import flax_rng
from benchmark.reference.lab4d_ref.utils import jax_random as jr

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

STEP_SEED = 42
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
    from benchmark.reference.lab4d_ref.nnutils.feature import FeatureNeRF
    from benchmark.reference.lab4d_ref.nnutils.warping import ComposedWarp

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
