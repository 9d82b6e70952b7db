"""The reference's training steps: the loss of each step, the gradient the
optimizer is handed and the parameters after the steps, in fp32.

The update is the program's trainer's as its flags state it: the loss terms
summed in sorted order; a parameter no term reaches gets a zero gradient;
skip-not-clip (every gradient zeroed unless their global norm is below 5);
AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4, decoupled) in two
groups, the explicit parameters at 10x the learning rate of a linear
one-cycle schedule. AdamW is written out here, not taken from torch.optim.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.lab4d_ref import bridge
from benchmark.reference.lab4d_ref.engine.schedules import compute_sched

EXPLICIT_PARAM_NAMES = ("logibeta", "logsigma", "logscale", "log_gauss", "base_quat",
                        "base_logfocal", "base_ppoint", "shift")
GRAD_NORM_MAX = 5.0
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def lr_scale(name: str) -> float:
    """10 for the explicit parameters (by their param-tree path), else 1."""
    path, _ = bridge.torch_to_flax_path(name)
    explicit = path[-1] in EXPLICIT_PARAM_NAMES or (
        len(path) > 1 and path[-2] in EXPLICIT_PARAM_NAMES)
    return 10.0 if explicit else 1.0


def onecycle_linear(step, total_steps, peak, pct_start, div_factor=25.0, final_div_factor=1.0):
    warm = max(int(pct_start * total_steps), 1)
    init = peak / div_factor
    final = init / final_div_factor
    if step < warm:
        return init + (peak - init) * min(step, warm) / warm
    t = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
    return peak + (final - peak) * t


def run_steps(model, batches: List[Dict], geo, schedule: dict) -> Dict:
    """Train `model` in place on `batches` (device batches without "geo"),
    steps 0, 1, ...; returns {"losses": [total per step], "terms": [{name:
    value} per step], "grad0": {name: the first step's gradient as AdamW gets
    it}, "params": {name: value after the last step}}.

    schedule: {"total_steps", "peak", "pct_start"} of the learning rate."""
    named = dict(model.named_parameters())
    scale = {n: lr_scale(n) for n in named}
    m = {n: torch.zeros_like(p) for n, p in named.items()}
    v = {n: torch.zeros_like(p) for n, p in named.items()}
    out = {"losses": [], "terms": [], "grad0": None, "params": None}
    for step, batch in enumerate(batches):
        batch = dict(batch, geo=geo)
        loss_dict = model(batch, compute_sched(step), step=step)
        total = sum(loss_dict[k] for k in sorted(loss_dict))
        for p in named.values():
            p.grad = None
        total.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in named.items()}
        gnorm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        if not bool(gnorm < GRAD_NORM_MAX):
            grads = {n: torch.zeros_like(g) for n, g in grads.items()}
        lr = onecycle_linear(step, schedule["total_steps"], schedule["peak"],
                             schedule["pct_start"])
        t = step + 1
        bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
        with torch.no_grad():
            for n, p in named.items():
                g, lr_n = grads[n], lr * scale[n]
                p.mul_(1 - lr_n * WEIGHT_DECAY)
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = v[n].sqrt() / np.sqrt(bc2) + EPS
                p.addcdiv_(m[n], denom, value=-lr_n / bc1)
        if step == 0:
            out["grad0"] = {n: g.detach().clone() for n, g in grads.items()}
        out["losses"].append(float(total.detach()))
        out["terms"].append({k: float(v_.detach()) for k, v_ in loss_dict.items()})
        out["gnorm"] = out.get("gnorm", []) + [float(gnorm)]
        model.zero_grad(set_to_none=True)
    out["params"] = {n: p.detach().clone() for n, p in named.items()}
    return out
