"""Minimal mesh library (numpy): proxy geometry and OBJ import/export.
The port's copy of lab4d_tpu/meshlib.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Mesh:
    """Triangle mesh with optional per-vertex colors."""

    def __init__(self, vertices=None, faces=None, vertex_colors=None):
        self.vertices = (
            np.zeros((0, 3), dtype=np.float64)
            if vertices is None
            else np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        )
        self.faces = (
            np.zeros((0, 3), dtype=np.int64)
            if faces is None
            else np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        )
        self.vertex_colors = (
            None if vertex_colors is None else np.asarray(vertex_colors)
        )

    def __repr__(self):
        return f"Mesh(V={len(self.vertices)}, F={len(self.faces)})"

    @property
    def is_empty(self) -> bool:
        return len(self.vertices) == 0

    @property
    def bounds(self) -> Optional[np.ndarray]:
        """(2, 3) [min; max] bounds or None if empty."""
        if self.is_empty:
            return None
        return np.stack([self.vertices.min(0), self.vertices.max(0)], 0)

    def corners(self) -> np.ndarray:
        """(8, 3) corners of the bounding box."""
        b = self.bounds
        idx = np.array(
            [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        )
        return np.stack([b[idx[:, d], d] for d in range(3)], axis=-1)

    def copy(self) -> "Mesh":
        return Mesh(
            self.vertices.copy(),
            self.faces.copy(),
            None if self.vertex_colors is None else self.vertex_colors.copy(),
        )

    def apply_transform(self, mat4: np.ndarray) -> "Mesh":
        v = self.vertices @ mat4[:3, :3].T + mat4[:3, 3]
        self.vertices = v
        return self

    def apply_scale(self, s) -> "Mesh":
        self.vertices = self.vertices * s
        return self

    # ------------------------------------------------------------------- IO

    def export(self, path: str):
        if path.endswith(".obj"):
            save_obj(self, path)
        else:
            raise ValueError(f"unsupported mesh format: {path}")

    # ------------------------------------------------------- topology utils

    def split_connected(self) -> List["Mesh"]:
        """Split into connected components (vertex-adjacency over faces)."""
        if self.is_empty or len(self.faces) == 0:
            return [self]
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        nv = len(self.vertices)
        e = np.concatenate(
            [self.faces[:, [0, 1]], self.faces[:, [1, 2]], self.faces[:, [2, 0]]]
        )
        adj = coo_matrix(
            (np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(nv, nv)
        )
        n_comp, labels = connected_components(adj, directed=False)
        if n_comp <= 1:
            return [self]
        out = []
        for c in range(n_comp):
            vmask = labels == c
            if not vmask.any():
                continue
            vmap = -np.ones(nv, dtype=np.int64)
            vmap[vmask] = np.arange(vmask.sum())
            fmask = vmask[self.faces].all(axis=1)
            faces = vmap[self.faces[fmask]]
            out.append(Mesh(self.vertices[vmask], faces))
        return out

    def largest_connected(self) -> "Mesh":
        comps = self.split_connected()
        return max(comps, key=lambda m: len(m.vertices))

    def sample_surface(self, n: int, seed: int = 0):
        """Uniform surface samples; returns (points (n,3), face normals (n,3))."""
        v, f = self.vertices, self.faces
        tri = v[f]  # (F, 3, 3)
        cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        area = 0.5 * np.linalg.norm(cross, axis=-1)
        normals = cross / np.maximum(np.linalg.norm(cross, axis=-1, keepdims=True), 1e-12)
        rng = np.random.default_rng(seed)
        probs = area / max(area.sum(), 1e-12)
        fid = rng.choice(len(f), size=n, p=probs)
        u, w = rng.random(n), rng.random(n)
        flip = u + w > 1
        u[flip], w[flip] = 1 - u[flip], 1 - w[flip]
        pts = (
            tri[fid, 0]
            + u[:, None] * (tri[fid, 1] - tri[fid, 0])
            + w[:, None] * (tri[fid, 2] - tri[fid, 0])
        )
        return pts, normals[fid]


def save_obj(mesh: Mesh, path: str):
    """One `v` line per vertex (with its colour in [0, 1] where the mesh
    has them), one `f` line per face (1-based). Each block is formatted by
    one %-operation over the whole array: export writes a mesh of a few
    hundred thousand faces per frame."""
    verts = np.asarray(mesh.vertices, dtype=np.float64).reshape(-1, 3)
    if mesh.vertex_colors is not None:
        vc = np.asarray(mesh.vertex_colors, dtype=np.float64)
        if vc.max() > 1.0:
            vc = vc / 255.0
        verts = np.concatenate([verts, vc[:, :3]], axis=1)
        vfmt = "v %.6f %.6f %.6f %.4f %.4f %.4f\n"
    else:
        vfmt = "v %.6f %.6f %.6f\n"
    faces = np.asarray(mesh.faces, dtype=np.int64).reshape(-1, 3) + 1
    text = (vfmt * len(verts)) % tuple(verts.ravel().tolist()) + \
        ("f %d %d %d\n" * len(faces)) % tuple(faces.ravel().tolist())
    with open(path, "w") as fp:
        fp.write(text if text else "\n")


def load_obj(path: str) -> Mesh:
    verts, faces = [], []
    with open(path) as fp:
        for line in fp:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(np.asarray(verts), np.asarray(faces) if faces else None)


def uv_sphere(radius: float = 1.0, count=(16, 16)) -> Mesh:
    """Latitude-longitude sphere."""
    n_lat, n_lon = max(count[0], 3), max(count[1], 3)
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    grid_lat, grid_lon = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(grid_lat) * np.cos(grid_lon)
    y = np.sin(grid_lat) * np.sin(grid_lon)
    z = np.cos(grid_lat)
    verts = np.stack([x, y, z], -1).reshape(-1, 3) * radius

    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            faces.append([a, b, c])
            faces.append([b, d, c])
    return Mesh(verts, np.asarray(faces))


def concatenate(meshes: List[Mesh]) -> Mesh:
    """One mesh of every non-empty mesh; vertex colours are kept where any
    mesh has them (grey for those without)."""
    meshes = [m for m in meshes if not m.is_empty]
    if not meshes:
        return Mesh()
    verts, faces, colors = [], [], []
    off = 0
    has_color = any(m.vertex_colors is not None for m in meshes)
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        if has_color:
            c = (
                m.vertex_colors
                if m.vertex_colors is not None
                else np.full((len(m.vertices), 3), 192.0)
            )
            colors.append(np.asarray(c, dtype=np.float64).reshape(len(m.vertices), -1)[:, :3])
        off += len(m.vertices)
    return Mesh(
        np.concatenate(verts),
        np.concatenate(faces),
        np.concatenate(colors) if has_color else None,
    )
