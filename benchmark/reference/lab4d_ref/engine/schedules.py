"""Training-progress schedules. Port of lab4d_tpu/engine/schedules.py.

`compute_sched(step)` returns plain floats (computed in float32, as the
JAX package computes its traced scalars) for the loss-weight ramps and the
positional-encoding annealing of one optimization step.
"""

from __future__ import annotations

import numpy as np


def interp_wt(x, y, x2, kind: str = "linear") -> float:
    """Map x2 from [x0, x1] to [y0, y1] (linearly or in log space), clipped
    to the y range."""
    x0, x1 = x
    y0, y1 = y
    t = (np.float32(x2) - np.float32(x0)) / np.float32(x1 - x0)
    if kind == "linear":
        y2 = np.float32(y0) + t * np.float32(y1 - y0)
    elif kind == "log":
        ly0, ly1 = np.log10(np.float32(y0)), np.log10(np.float32(y1))
        y2 = np.float32(10.0) ** (ly0 + t * (ly1 - ly0))
    else:
        raise ValueError(kind)
    return float(np.clip(np.float32(y2), min(y0, y1), max(y0, y1)))


def compute_sched(step) -> dict:
    """Schedule values at an optimization step."""
    return {
        # positional-encoding annealing: 0.6 -> 1.0 over 4k steps
        "alpha": interp_wt((0, 4000), (0.6, 1.0), step),
        # instance-code swap probability: 1.0 -> 0.2 over 2k steps
        "beta_prob": interp_wt((0, 2000), (1.0, 0.2), step),
        # loss-weight ramps (factors multiplying the static flag weights)
        "reg_cam_prior_factor": interp_wt((0, 800), (1.0, 0.0), step),
        "reg_eikonal_factor": interp_wt((0, 4000), (1.0, 100.0), step, "log"),
        "reg_skel_prior_factor": interp_wt((0, 4000), (1.0, 0.0), step),
        "reg_gauss_mask_factor": interp_wt((0, 4000), (1.0, 0.0), step),
    }
