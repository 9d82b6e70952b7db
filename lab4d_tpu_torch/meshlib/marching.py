"""Isosurface extraction via vectorized marching tetrahedra (numpy).

Replaces skimage.measure.marching_cubes in the reference pipeline
(geom_utils.py:442-503). Marching tetrahedra avoids the 256-case cube
tables while producing watertight surfaces; each grid cell is split into
6 tetrahedra and each tet contributes 0-2 triangles depending on the
sign pattern of the (masked) SDF at its corners.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lab4d_tpu_torch.meshlib import Mesh

# 6-tet decomposition of the unit cube (corner indices into the 8 cube
# corners, ordered so all tets share the main diagonal 0-7)
_CUBE_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ]
)

# cube corner offsets (z fastest to match grid.reshape(gx, gy, gz))
_CORNER_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [0, 1, 1],
        [1, 0, 0],
        [1, 0, 1],
        [1, 1, 0],
        [1, 1, 1],
    ]
)

# tet edges (pairs of local tet-corner ids)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])

# triangle emission per 4-bit inside-pattern: list of (edge triples)
# edges index into _TET_EDGES. Built from the standard marching-tets cases.
_TET_TRIS = {
    0b0001: [(0, 1, 2)],
    0b1110: [(0, 2, 1)],
    0b0010: [(0, 4, 3)],
    0b1101: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1011: [(1, 5, 3)],
    0b1000: [(2, 5, 4)],
    0b0111: [(2, 4, 5)],
    0b0011: [(1, 4, 3), (1, 2, 4)],
    0b1100: [(1, 3, 4), (1, 4, 2)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1010: [(0, 5, 3), (0, 2, 5)],
    0b0110: [(0, 4, 5), (0, 5, 1)],
    0b1001: [(0, 5, 4), (0, 1, 5)],
}


def marching_tets(
    sdf_grid: np.ndarray,
    level: float = 0.0,
    mask: Optional[np.ndarray] = None,
    spacing=(1.0, 1.0, 1.0),
) -> Mesh:
    """Extract the `level` isosurface of a dense (X, Y, Z) SDF grid.

    Args:
        sdf_grid: (X, Y, Z) scalar field
        mask: optional (X, Y, Z) bool; cells touching masked-out (False)
            voxels are skipped (parity with skimage's `mask` argument)
    Returns:
        Mesh with vertices in index coordinates scaled by `spacing`
    """
    g = np.asarray(sdf_grid, dtype=np.float64) - level
    X, Y, Z = g.shape
    if min(X, Y, Z) < 2:
        return Mesh()

    # gather the 8 corner values of every cell: (Cx, Cy, Cz, 8)
    corners = np.empty((X - 1, Y - 1, Z - 1, 8), dtype=np.float64)
    cpos = np.empty((X - 1, Y - 1, Z - 1, 8, 3), dtype=np.float64)
    base = np.stack(
        np.meshgrid(
            np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
        ),
        axis=-1,
    )
    for ci, (dx, dy, dz) in enumerate(_CORNER_OFFSETS):
        corners[..., ci] = g[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
        cpos[..., ci, :] = base + np.array([dx, dy, dz])

    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        cell_ok = np.ones((X - 1, Y - 1, Z - 1), dtype=bool)
        for dx, dy, dz in _CORNER_OFFSETS:
            cell_ok &= m[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz]
    else:
        cell_ok = np.ones((X - 1, Y - 1, Z - 1), dtype=bool)

    # active cells: sign change among corners
    inside = corners < 0
    n_in = inside.sum(-1)
    active = cell_ok & (n_in > 0) & (n_in < 8)
    if not active.any():
        return Mesh()

    vals = corners[active]  # (C, 8)
    pos = cpos[active]  # (C, 8, 3)

    tris = []
    for tet in _CUBE_TETS:
        tv = vals[:, tet]  # (C, 4)
        tp = pos[:, tet]  # (C, 4, 3)
        pattern = (
            (tv[:, 0] < 0).astype(np.int32)
            | ((tv[:, 1] < 0) << 1)
            | ((tv[:, 2] < 0) << 2)
            | ((tv[:, 3] < 0) << 3)
        )
        # interpolated crossing point on each of the 6 tet edges
        e0 = tv[:, _TET_EDGES[:, 0]]
        e1 = tv[:, _TET_EDGES[:, 1]]
        denom = e0 - e1
        t = np.where(np.abs(denom) > 1e-12, e0 / np.where(denom == 0, 1, denom), 0.5)
        t = np.clip(t, 0.0, 1.0)[..., None]  # (C, 6, 1)
        p0 = tp[:, _TET_EDGES[:, 0]]
        p1 = tp[:, _TET_EDGES[:, 1]]
        edge_pts = p0 + t * (p1 - p0)  # (C, 6, 3)

        for pat, tri_list in _TET_TRIS.items():
            sel = pattern == pat
            if not sel.any():
                continue
            for (ea, eb, ec) in tri_list:
                tris.append(
                    np.stack(
                        [edge_pts[sel, ea], edge_pts[sel, eb], edge_pts[sel, ec]],
                        axis=1,
                    )
                )

    if not tris:
        return Mesh()
    tri_pts = np.concatenate(tris, axis=0)  # (T, 3, 3)
    tri_pts = tri_pts * np.asarray(spacing)

    # weld duplicate vertices
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat / (np.asarray(spacing).min() * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=len(uniq))[:, None]
    verts = verts / counts
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return Mesh(verts, faces[ok])


def marching_cubes(
    sdf_func,
    aabb: np.ndarray,
    visibility_func=None,
    grid_size: int = 64,
    level: float = 0.0,
    chunk_size: int = 64**3,
    apply_connected_component: bool = False,
) -> Mesh:
    """Extract a mesh from an SDF callable over an aabb.

    Parity: geom_utils.py:442-503 (same signature semantics; callables map
    (N,3) numpy points to (N,) or (N,1) values).
    """
    aabb = np.asarray(aabb, dtype=np.float64)
    axes = [np.linspace(aabb[0][i], aabb[1][i], grid_size) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    grid = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)

    vals = []
    for i in range(0, len(grid), chunk_size):
        vals.append(np.asarray(sdf_func(grid[i : i + chunk_size])).reshape(-1))
    sdf = np.concatenate(vals).reshape(grid_size, grid_size, grid_size)

    if visibility_func is not None:
        vis = []
        for i in range(0, len(grid), chunk_size):
            vis.append(
                np.asarray(visibility_func(grid[i : i + chunk_size])).reshape(-1)
            )
        vis = np.concatenate(vis).reshape(grid_size, grid_size, grid_size) > 0
    else:
        vis = None

    spacing = (aabb[1] - aabb[0]) / (grid_size - 1)
    mesh = marching_tets(sdf, level=level, mask=vis, spacing=spacing)
    if mesh.is_empty:
        print("marching cubes: empty surface")
        return mesh
    mesh.vertices = mesh.vertices + aabb[0]

    # orient faces outward (along the SDF gradient) using grid gradients
    if len(mesh.faces) > 0:
        gxs, gys, gzs = np.gradient(sdf, *[s if s > 0 else 1.0 for s in spacing])
        centroids = mesh.vertices[mesh.faces].mean(axis=1)
        idx = np.clip(
            np.round((centroids - aabb[0]) / spacing).astype(np.int64),
            0,
            grid_size - 1,
        )
        grad = np.stack(
            [gxs[idx[:, 0], idx[:, 1], idx[:, 2]],
             gys[idx[:, 0], idx[:, 1], idx[:, 2]],
             gzs[idx[:, 0], idx[:, 1], idx[:, 2]]],
            axis=-1,
        )
        tri = mesh.vertices[mesh.faces]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        flip = np.sum(fn * grad, axis=-1) < 0
        mesh.faces[flip] = mesh.faces[flip][:, ::-1]
    if apply_connected_component:
        mesh = mesh.largest_connected()
    return mesh
