"""Host-side numpy helpers: PCA for feature visualization, bilinear
sampling. The port's copy of
lab4d_tpu/utils/numpy_utils.py."""

from __future__ import annotations

import numpy as np


def pca_numpy(raw_data: np.ndarray, n_components: int):
    """Closed-form PCA factory; returns a function applying the projection.

    Used to visualize 16-d DINO features as RGB.
    """
    mean = raw_data.mean(axis=0)
    centered = raw_data - mean
    cov = np.cov(centered.T)
    eigval, eigvec = np.linalg.eigh(cov)
    order = np.argsort(eigval)[::-1]
    eigval = eigval[order]
    eigvec = eigvec[:, order]
    top = eigvec[:, :n_components]

    def apply_pca_fn(data: np.ndarray, normalize: bool = False) -> np.ndarray:
        shape = data.shape
        flat = data.reshape(-1, shape[-1])
        proj = (flat - mean) @ top
        if normalize:
            proj = proj / np.sqrt(np.maximum(eigval[:n_components], 1e-12))
            proj = np.clip(proj, -2, 2)
            proj = (proj + 2) / 4
        return proj.reshape(shape[:-1] + (n_components,))

    return apply_pca_fn


def bilinear_interp(feat: np.ndarray, xy_loc: np.ndarray) -> np.ndarray:
    """Bilinear sample a (H, W, C) feature map at float (N, 2) xy locations."""
    dtype = feat.dtype
    H, W = feat.shape[:2]
    ul = np.floor(xy_loc).astype(int)
    fx = (xy_loc[:, 0] - ul[:, 0])[:, None]
    fy = (xy_loc[:, 1] - ul[:, 1])[:, None]
    x0 = np.clip(ul[:, 0], 0, W - 2)
    y0 = np.clip(ul[:, 1], 0, H - 2)
    q11 = feat[y0, x0]
    q12 = feat[y0, x0 + 1]
    q21 = feat[y0 + 1, x0]
    q22 = feat[y0 + 1, x0 + 1]
    out = (
        q11 * (1 - fx) * (1 - fy)
        + q21 * (1 - fx) * fy
        + q12 * fx * (1 - fy)
        + q22 * fx * fy
    )
    return out.astype(dtype)
