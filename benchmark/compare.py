"""The numbers that decide `correct`, each a gap between what the program
produced in the timed path and what the plain reference works out.

Training (by the worst leaf: the gap between the program's norm of a leaf
and the reference's, against the larger of the reference's norm of that
leaf and of the median leaf; leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change):
- loss: the largest relative gap of a step's total loss;
- grad: the first step's gradient as AdamW gets it;
- change: the parameters' change over the steps;
- grad_median, change_median: the median leaf's gap of the same (steady
  where one leaf's gap swings from seed to seed: a leaf whose gradient is
  a sum that cancels, or whose elements Adam steps by their gradient's
  sign).

Frames (each sampled frame, each channel, the worst of them):
- frame_p99: the 99th percentile of the absolute gap over the frame's
  pixels and the channel's components, against the channel's RMS;
- frame_mean: the mean absolute gap against the channel's mean magnitude.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

ROUNDOFF_LEAF = 1e-3  # a leaf under this share of the median leaf's gradient is round-off


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep=None):
    """{leaf: gap} by the norm-gap rule."""
    ng, nw = _norms(got), _norms(want)
    names = [k for k in want if keep is None or k in keep]
    med = float(np.median([nw[k] for k in names])) if names else 0.0
    return {k: abs(ng[k] - nw[k]) / max(nw[k], med, 1e-30) for k in names}


def moving_leaves(grad0: Dict[str, torch.Tensor]):
    """The leaves whose reference gradient is not round-off."""
    n = _norms(grad0)
    med = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= ROUNDOFF_LEAF * med}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog / ref: {"losses": [...], "grad0": {leaf}, "change": {leaf}}."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not np.all(np.isfinite(prog["losses"])):
        losses = [float("inf")]
    keep = moving_leaves(ref["grad0"])
    ggaps = leaf_gaps(prog["grad0"], ref["grad0"])
    cgaps = leaf_gaps(prog["change"], ref["change"], keep)
    grad_leaf, change_leaf = max(ggaps, key=ggaps.get), max(cgaps, key=cgaps.get)
    return {"loss": max(losses), "grad": ggaps[grad_leaf], "change": cgaps[change_leaf],
            "grad_median": float(np.median(list(ggaps.values()))),
            "change_median": float(np.median(list(cgaps.values()))),
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf}


def frame_numbers(got: List[Dict[str, np.ndarray]], want: List[Dict[str, np.ndarray]]):
    """The worst over frames and channels of frame_p99 and frame_mean."""
    p99, mean, where = 0.0, 0.0, {}
    for g, w in zip(got, want):
        if set(g) != set(w):
            return {"frame_p99": float("inf"), "frame_mean": float("inf")}
        for ch in w:
            a, b = np.asarray(g[ch], np.float64), np.asarray(w[ch], np.float64)
            if a.shape != b.shape or not np.isfinite(a).all():
                return {"frame_p99": float("inf"), "frame_mean": float("inf")}
            d = np.abs(a - b)
            rms = np.sqrt(np.mean(b * b))
            q = float(np.quantile(d, 0.99)) / max(rms, 1e-12)
            m = float(d.mean()) / max(float(np.abs(b).mean()), 1e-12)
            where[ch] = max(where.get(ch, 0.0), q)
            p99, mean = max(p99, q), max(mean, m)
    return {"frame_p99": p99, "frame_mean": mean, "_by_channel": where}
