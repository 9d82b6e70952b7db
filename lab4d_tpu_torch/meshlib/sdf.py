"""Signed distance to a triangle mesh (numpy).

Replaces pysdf in the reference geometry-init path (nerf.py:217-230):
the SDF supervises a 500-step distillation, so a point-sampled
pseudo-normal approximation is sufficient. Distance = nearest of a dense
surface sampling; sign = side of the associated face normal.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from lab4d_tpu_torch.meshlib import Mesh


class MeshSDF:
    """Approximate signed distance function from a surface point cloud."""

    def __init__(self, mesh: Mesh, n_samples: int = 100_000, seed: int = 0):
        n = min(n_samples, max(10 * len(mesh.faces), 10_000))
        self.points, self.normals = mesh.sample_surface(n, seed=seed)
        # include vertices for sharp features
        if len(mesh.vertices) > 0 and len(mesh.faces) > 0:
            vn = np.zeros_like(mesh.vertices)
            tri = mesh.vertices[mesh.faces]
            fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            for k in range(3):
                np.add.at(vn, mesh.faces[:, k], fn)
            vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
            self.points = np.concatenate([self.points, mesh.vertices])
            self.normals = np.concatenate([self.normals, vn])
        self.tree = cKDTree(self.points)

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        """Signed distance, negative inside; (N, 3) -> (N, 1)."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 3)
        dist, idx = self.tree.query(pts, k=1)
        diff = pts - self.points[idx]
        sign = np.sign(np.sum(diff * self.normals[idx], axis=-1))
        sign = np.where(sign == 0, 1.0, sign)
        return (sign * dist)[:, None].astype(np.float32)
