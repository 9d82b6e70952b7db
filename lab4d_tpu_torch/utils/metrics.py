"""Image metrics of the per-round eval: masked PSNR, SSIM and depth error.
The port's own copy of lab4d_tpu/utils/metrics.py (numpy; SSIM uses cv2)."""

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
