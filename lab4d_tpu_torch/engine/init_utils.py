"""Init-time prior fitting: camera / intrinsics fits and the SDF geometry
distillation. Port of lab4d_tpu/engine/init_utils.py.

Both run plain Adam (no weight decay) over the model's parameters; a loss
reaches only its own submodule, and parameters without a gradient are not
touched, as the JAX package's zero gradients leave them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from lab4d_tpu_torch.engine import jax_streams
from lab4d_tpu_torch.utils.loss import align_vectors


def fit_until_converged(loss_fn: Callable, params, tol: float, lr: float = 1e-3,
                        max_iters: int = 5000, log_name: str = "fit"):
    """Minimize loss_fn() with Adam until loss < tol or max_iters updates.

    The stop rule is the JAX package's while_loop condition: each update
    is taken from the loss of the parameters before it, and the loop ends
    once that loss is below tol. Returns (final loss, updates taken)."""
    params = list(params)
    opt = torch.optim.Adam(params, lr=lr)
    with torch.no_grad():
        loss = float(loss_fn())
    iters = 0
    while loss > tol and iters < max_iters:
        opt.zero_grad(set_to_none=True)
        value = loss_fn()
        value.backward()
        opt.step()
        loss = float(value.detach())
        iters += 1
    print(f"[init] {log_name}: loss={loss:.6f} after {iters} iters", flush=True)
    return loss, iters


def field_init_terms(field, pts, inst_id, eikonal_idx):
    """SDF, visibility logit and per-point eikonal (at the points
    eikonal_idx) of one field."""
    sdf = field.forward(pts, inst_id=inst_id, get_density=False)
    vis = field.vis_mlp(pts, inst_id=inst_id)
    eik = field.compute_eikonal(pts[:, None, None], inst_id=inst_id, idx=eikonal_idx)
    return sdf, vis, eik


def fit_geometry(model, pools: Dict[str, Dict[str, torch.Tensor]], num_steps: int = 500,
                 lr: float = 1e-3):
    """SDF distillation from the proxy geometry.

    pools: per category {"pts": (S, n, 3), "sdf_gt": (S, n, 1),
    "inst_id": (S, n)} sampled on the host, S >= num_steps. Step s takes
    its eikonal points as the JAX package's fit does, from
    fold_in(PRNGKey(7), s) (jax_streams.prior_fit_eikonal), all drawn
    before the loop and moved in one copy. Returns the first and last
    losses."""
    opt = torch.optim.Adam(list(model.parameters()), lr=lr)
    eikonal = jax_streams.to_device(
        {cate: {"idx": np.stack([jax_streams.prior_fit_eikonal(s, cate, pool["pts"].shape[1])
                                 for s in range(num_steps)])}
         for cate, pool in pools.items()}, next(iter(pools.values()))["pts"].device)
    losses = []
    for step in range(num_steps):
        total = 0.0
        for cate, pool in pools.items():
            field = model.fields.field_params[cate]
            sdf, vis, eik = field_init_terms(field, pool["pts"][step], pool["inst_id"][step],
                                             eikonal[cate]["idx"][step])
            sdf_gt = pool["sdf_gt"][step]
            scale = align_vectors(sdf, sdf_gt).detach()
            sdf_loss = torch.mean((sdf * scale - sdf_gt) ** 2)
            vis_loss = -F.logsigmoid(vis).mean() * 0.01
            mask = (eik > 0).float()
            eik_loss = torch.sum(eik * mask) / torch.clamp(torch.sum(mask), min=1.0) * 1e-4
            total = total + sdf_loss + vis_loss + eik_loss
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        losses.append(total.detach())
    first, last = float(losses[0]), float(losses[-1])
    print(f"[init] geometry: loss {first:.4f} -> {last:.4f}", flush=True)
    return first, last
