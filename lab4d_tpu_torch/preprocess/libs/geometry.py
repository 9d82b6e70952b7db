"""Two-frame rigid registration from depth + flow correspondences
(reference: preprocess/libs/geometry.py:53-133).

Per adjacent frame pair: unproject frame-0 depth to a camera-space point
cloud, pull frame-1 depth along the flow to get the corresponding cloud,
and solve the SE(3) aligning them.  The solver is Kabsch/Procrustes with
IRLS (Tukey-style reweighting) instead of the reference's RANSAC loop —
deterministic and vectorized.  PnP (cv2) is available as an alternative.
"""

from __future__ import annotations

import cv2
import numpy as np

from lab4d_tpu_torch.preprocess.libs.io import backward_warp_image


def kabsch(pts0: np.ndarray, pts1: np.ndarray, weights=None):
    """Weighted closed-form R, t with R @ pts0 + t ~= pts1."""
    if pts0.shape[0] < 10:
        return np.eye(3), np.zeros(3)
    if weights is None:
        weights = np.ones(pts0.shape[0])
    w = weights / (weights.sum() + 1e-12)
    c0 = (pts0 * w[:, None]).sum(0)
    c1 = (pts1 * w[:, None]).sum(0)
    H = (pts0 - c0).T @ ((pts1 - c1) * w[:, None])
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    t = c1 - R @ c0
    return R, t


def kabsch_robust(pts0: np.ndarray, pts1: np.ndarray, num_iters: int = 5):
    """IRLS Kabsch: reweight by residual against a scale-adaptive sigma."""
    R, t = kabsch(pts0, pts1)
    for _ in range(num_iters):
        resid = np.linalg.norm(pts1 - (pts0 @ R.T + t), axis=-1)
        sigma = max(np.median(resid) * 1.4826, 1e-6)
        wts = 1.0 / (1.0 + (resid / (2.0 * sigma)) ** 2)
        R, t = kabsch(pts0, pts1, wts)
    return R, t


def unproject(depth: np.ndarray, Kmat: np.ndarray, xy=None) -> np.ndarray:
    """Depth map -> (H*W, 3) camera-space points."""
    h, w = depth.shape
    if xy is None:
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        xy = np.stack([xx, yy], -1).astype(np.float64)
    hom = np.concatenate([xy, np.ones_like(xy[..., :1])], -1).reshape(-1, 3)
    rays = hom @ np.linalg.inv(Kmat).T
    return rays * depth.reshape(-1, 1)


def register_pair(
    depth0: np.ndarray,
    depth1: np.ndarray,
    flow: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    valid: np.ndarray,
    method: str = "procrustes",
) -> np.ndarray:
    """SE(3) cam0 -> cam1 from depths + flow (crop frame).

    flow: (H, W, >=2) displacement frame0 -> frame1 in pixels.
    valid: (H, W) or flat bool mask of usable pixels.
    """
    h, w = depth0.shape
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    xy0 = np.stack([xx, yy], -1).astype(np.float64)
    xy1 = xy0 + flow[..., :2]

    pts0 = unproject(depth0, K0, xy0)
    depth1_w = backward_warp_image(depth1, flow[..., :2]).reshape(-1)
    hom1 = np.concatenate([xy1, np.ones_like(xy1[..., :1])], -1).reshape(-1, 3)
    pts1 = (hom1 @ np.linalg.inv(K1).T) * depth1_w[:, None]

    valid = valid.reshape(-1) & (depth1_w > 0) & (depth0.reshape(-1) > 0)
    p0, p1 = pts0[valid], pts1[valid]

    se3 = np.eye(4)
    if method == "procrustes":
        R, t = kabsch_robust(p0, p1)
    elif method == "pnp":
        uv1 = xy1.reshape(-1, 2)[valid]
        ok, rvec, tvec, _ = cv2.solvePnPRansac(
            p0[:, None].astype(np.float64),
            uv1[:, None].astype(np.float64),
            K1.astype(np.float64),
            None,
            flags=cv2.SOLVEPNP_ITERATIVE,
        )
        if not ok:
            return se3
        R, t = cv2.Rodrigues(rvec)[0], tvec[:, 0]
    else:
        raise ValueError(method)
    se3[:3, :3], se3[:3, 3] = R, t
    return se3
