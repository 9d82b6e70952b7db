"""Canonical (fg viewpoint) registration as a fit on the device (port of
preprocess/libs/registration.py).

Optimizes one quaternion per frame so that (a) annotated/predicted
canonical rotations are respected (unary term) and (b) adjacent relative
rotations match the Procrustes chain from camera registration (pairwise
term). Phase 1 fits pairwise-only (propagates the chain), phase 2 adds
the unary term. Each phase is an Adam loop (optax.adam's update and
defaults: b1 0.9, b2 0.999, eps 1e-8) that stops once the loss is below
the phase's tolerance, checked every 100 iterations.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.utils.quat import matrix_to_quaternion, quaternion_to_matrix

PHASES = ((0.0, 0.015), (1.0, 0.030))  # (unary weight, stopping tolerance)
B1, B2, EPS = 0.9, 0.999, 1e-8


def rot_angle(mat: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 3, 3) rotation matrices."""
    cos = (mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0 + 1e-4, 1.0 - 1e-4))


def fit_loss(rots: np.ndarray, cams_chain: np.ndarray, annotations: Dict[int, np.ndarray]):
    """Phase 2's loss (unary + pairwise) of (N,3,3) rotations, in float64:
    how well a fit's end point satisfies its inputs."""
    def angle(m):
        c = (np.trace(m, axis1=-2, axis2=-1) - 1.0) / 2.0
        return np.arccos(np.clip(c, -1.0 + 1e-4, 1.0 - 1e-4))

    R = np.asarray(rots, np.float64)
    chain = np.asarray(cams_chain, np.float64)[:, :3, :3]
    rel_gt = chain[1:] @ np.swapaxes(chain[:-1], -1, -2)
    pairwise = angle(R[1:] @ np.swapaxes(R[:-1], -1, -2) @ np.swapaxes(rel_gt, -1, -2)).mean()
    keys = sorted(annotations)
    annot = np.stack([np.asarray(annotations[k], np.float64)[:3, :3] for k in keys])
    return float(angle(R[keys] @ np.swapaxes(annot, -1, -2)).mean() + pairwise)


def rotation_gap_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle in degrees between (N,3,3) rotations, from |a - b|_F =
    2 sqrt(2) sin(t / 2) in float64 (linear in the angle near zero, where
    the trace's arccos loses precision)."""
    d = np.linalg.norm((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                       .reshape(len(a), -1), axis=-1)
    return np.degrees(2 * np.arcsin(np.minimum(d / (2 * np.sqrt(2)), 1.0)))


def _losses(quats, rel_gt, annot_idx, annot_rot):
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    R = quaternion_to_matrix(q)  # (N,3,3)
    rel = R[1:] @ R[:-1].transpose(-1, -2)
    pairwise = rot_angle(rel @ rel_gt.transpose(-1, -2)).mean()
    unary = rot_angle(R[annot_idx] @ annot_rot.transpose(-1, -2)).mean()
    return unary, pairwise


def _phase(quats, rel_gt, annot_idx, annot_rot, unary_wt, tol, lr, max_iters):
    """One phase: Adam from fresh moments until the loss, read every 100
    iterations, is below tol. On the card one iteration (loss, gradient,
    update) is a CUDA graph replayed: a few hundred small launches each
    otherwise, for tensors of a few hundred floats. Returns the quaternions
    and the iteration it stopped at (max_iters when it ran to the end)."""
    q = quats.detach().clone().requires_grad_(True)
    mu, nu = torch.zeros_like(q), torch.zeros_like(q)
    t = torch.zeros((), device=q.device)
    loss_out = torch.zeros((), device=q.device)

    def step():
        unary, pairwise = _losses(q, rel_gt, annot_idx, annot_rot)
        loss = unary_wt * unary + pairwise
        (grad,) = torch.autograd.grad(loss, q)
        with torch.no_grad():
            t.add_(1.0)
            mu.mul_(B1).add_((1 - B1) * grad)
            nu.mul_(B2).add_((1 - B2) * grad * grad)
            mu_hat = mu / (1 - torch.pow(B1, t))
            nu_hat = nu / (1 - torch.pow(B2, t))
            q.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)))
            loss_out.copy_(loss)

    run = step
    if q.device.type == "cuda":
        state = [x.detach().clone() for x in (q, mu, nu, t)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for x, x0 in zip((q, mu, nu, t), state):
                x.copy_(x0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        run = graph.replay
    for i in range(max_iters):
        run()
        if i % 100 == 0 and float(loss_out) < tol:
            return q.detach(), i
    return q.detach(), max_iters


def fit_canonical_rotations(
    cams_chain: np.ndarray,
    annotations: Dict[int, np.ndarray],
    lr: float = 1e-2,
    max_iters: int = 2000,
    device=None,
) -> Tuple[np.ndarray, List[int]]:
    """cams_chain: (N,4,4) scene2cam chain; annotations: frame -> 4x4 (or
    3x3) canonical rotations. Returns the (N,3,3) optimized rotations and
    the iteration each phase stopped at (max_iters when it ran to the
    end); the JAX package's optimize_canonical_rotations returns the
    rotations alone."""
    dev = resolve_device(device)
    n = len(cams_chain)
    rel_gt = torch.tensor(
        cams_chain[1:, :3, :3] @ np.swapaxes(cams_chain[:-1, :3, :3], -1, -2),
        dtype=torch.float32, device=dev,
    )
    if annotations:
        keys = sorted(annotations)
        annot_idx = np.asarray(keys, np.int64)
        annot_rot = np.stack([np.asarray(annotations[k])[:3, :3] for k in keys]).astype(np.float32)
    else:  # gauge-fix frame 0 to identity; pairwise term does the rest
        annot_idx = np.zeros((1,), np.int64)
        annot_rot = np.eye(3, dtype=np.float32)[None]

    # init: propagate the first annotation through the chain
    k0 = int(annot_idx[0])
    R0 = annot_rot[0]
    chain = cams_chain[:, :3, :3]
    init = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        init[i] = chain[i] @ np.linalg.inv(chain[k0]) @ R0
    quats = matrix_to_quaternion(torch.from_numpy(init).to(dev))
    annot_idx = torch.from_numpy(annot_idx).to(dev)
    annot_rot = torch.from_numpy(annot_rot).to(dev)

    stops = []
    for unary_wt, tol in PHASES:
        quats, stop = _phase(quats, rel_gt, annot_idx, annot_rot, unary_wt, tol, lr, max_iters)
        stops.append(stop)

    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    return quaternion_to_matrix(q).cpu().numpy(), stops

