"""Image metrics of the per-round eval (masked PSNR, SSIM and depth error)
and mesh metrics (surface samples, Chamfer distance, F-score). The port's
own copy of lab4d_tpu/utils/metrics.py (numpy; SSIM uses cv2)."""

from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, target: np.ndarray, mask=None, max_val=1.0) -> float:
    """Peak signal-to-noise ratio; optional (H, W) or (..., 1) mask."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    err = (pred - target) ** 2
    if mask is not None:
        mask = np.asarray(mask, bool)
        if mask.ndim == err.ndim - 1:
            mask = mask[..., None]
        mask = np.broadcast_to(mask, err.shape)
        if not mask.any():
            return float("nan")
        mse = err[mask].mean()
    else:
        mse = err.mean()
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def ssim(pred: np.ndarray, target: np.ndarray, max_val=1.0, sigma=1.5) -> float:
    """Mean SSIM with a Gaussian window (grayscale of the mean channel)."""
    import cv2

    def gray(x):
        x = np.asarray(x, np.float64)
        return x.mean(-1) if x.ndim == 3 else x

    x, y = gray(pred), gray(target)
    C1, C2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2

    def blur(a):
        return cv2.GaussianBlur(a, (0, 0), sigma)

    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    num = (2 * mx * my + C1) * (2 * sxy + C2)
    den = (mx**2 + my**2 + C1) * (sxx + syy + C2)
    return float((num / den).mean())


def depth_error(pred, target, mask=None, align_scale: bool = True):
    """Mean |depth error| after optional median-scale alignment."""
    pred = np.asarray(pred, np.float64).reshape(-1)
    target = np.asarray(target, np.float64).reshape(-1)
    valid = target > 0
    if mask is not None:
        valid &= np.asarray(mask, bool).reshape(-1)
    if not valid.any():
        return float("nan")
    p, t = pred[valid], target[valid]
    if align_scale and np.median(p) > 0:
        p = p * (np.median(t) / np.median(p))
    return float(np.abs(p - t).mean())


def _pairwise_min_dist(a: np.ndarray, b: np.ndarray, chunk=2048) -> np.ndarray:
    """For each point in a, distance to the nearest point in b."""
    out = np.empty(len(a))
    for i in range(0, len(a), chunk):
        d = np.linalg.norm(a[i:i + chunk, None] - b[None], axis=-1)
        out[i:i + chunk] = d.min(1)
    return out


def sample_mesh_points(mesh, n: int = 10000, seed: int = 0) -> np.ndarray:
    """Area-weighted surface samples from a meshlib Mesh."""
    rng = np.random.default_rng(seed)
    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    if len(f) == 0:
        return v[rng.integers(0, max(len(v), 1), n)] if len(v) else np.zeros((0, 3))
    tri = v[f]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    probs = area / max(area.sum(), 1e-12)
    idx = rng.choice(len(f), n, p=probs)
    r1, r2 = rng.random((2, n))
    s = np.sqrt(r1)
    w = np.stack([1 - s, s * (1 - r2), s * r2], -1)
    return (tri[idx] * w[..., None]).sum(1)


def chamfer_distance(mesh_a, mesh_b, n: int = 5000) -> float:
    """Symmetric Chamfer distance (mean of both directed means) between
    n surface samples of each mesh."""
    pa = sample_mesh_points(mesh_a, n)
    pb = sample_mesh_points(mesh_b, n)
    if len(pa) == 0 or len(pb) == 0:
        return float("nan")
    return float(0.5 * _pairwise_min_dist(pa, pb).mean() + 0.5 * _pairwise_min_dist(pb, pa).mean())


def fscore(mesh_a, mesh_b, threshold: float = 0.02, n: int = 5000) -> float:
    """F-score at a distance threshold: the harmonic mean of the shares of
    each mesh's samples within `threshold` of the other mesh's."""
    pa = sample_mesh_points(mesh_a, n)
    pb = sample_mesh_points(mesh_b, n)
    if len(pa) == 0 or len(pb) == 0:
        return float("nan")
    precision = (_pairwise_min_dist(pa, pb) < threshold).mean()
    recall = (_pairwise_min_dist(pb, pa) < threshold).mean()
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))
