"""Minimal dependency-free mesh rasterizer for offline visualization
(turntables of proxy meshes, bones, camera frusta). The port's copy of
lab4d_tpu/utils/raster.py.

Replaces the reference's pyrender offscreen renderer
(reference: scripts/render_intermediate.py) with a numpy splat
rasterizer: each face is sampled at a barycentric grid scaled to its
screen footprint, samples are z-buffered with np.minimum.at, and flat
Lambert shading is applied per face.  Intended for small proxy meshes
(<100k faces) where a full scanline rasterizer is overkill.
"""

from __future__ import annotations

import numpy as np


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """World-to-camera SE(3), OpenCV convention (+z forward)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], 0)
    rt = np.eye(4)
    rt[:3, :3] = R
    rt[:3, 3] = -R @ eye
    return rt


def _raster_bin(tri2d, z, shade, bbox_lo, grid_n, R):
    """Rasterize one bin of faces over per-face grid_n x grid_n pixel grids.

    tri2d: (F, 3, 2) screen-space verts; z: (F, 3) camera depth;
    shade: (F, 3) color; bbox_lo: (F, 2) int bbox origin.
    Returns flat (pix, depth, color) arrays of covered samples.
    """
    F = len(tri2d)
    gg = np.arange(grid_n)
    gx, gy = np.meshgrid(gg, gg, indexing="xy")
    px = bbox_lo[:, None, None, 0] + gx[None]  # (F, g, g)
    py = bbox_lo[:, None, None, 1] + gy[None]
    p = np.stack([px, py], -1).astype(np.float64) + 0.5

    a, b, c = tri2d[:, 0], tri2d[:, 1], tri2d[:, 2]

    def edge(p0, p1, q):
        return (q[..., 0] - p0[:, None, None, 0]) * (p1 - p0)[:, None, None, 1] - (
            q[..., 1] - p0[:, None, None, 1]
        ) * (p1 - p0)[:, None, None, 0]

    # signed areas for barycentrics
    w0 = edge(b, c, p)
    w1 = edge(c, a, p)
    w2 = edge(a, b, p)
    tot = w0 + w1 + w2
    inside = (np.sign(tot)[..., None] * np.stack([w0, w1, w2], -1) >= 0).all(-1)
    inside &= np.abs(tot) > 1e-12
    bary = np.stack([w0, w1, w2], -1) / np.where(
        np.abs(tot)[..., None] < 1e-12, 1.0, tot[..., None]
    )
    depth = (bary * z[:, None, None, :]).sum(-1)
    ok = inside & (px >= 0) & (px < R) & (py >= 0) & (py < R) & (depth > 1e-6)
    pix = (py * R + px)[ok]
    col = np.broadcast_to(shade[:, None, None, :], px.shape + (3,))[ok]
    return pix, depth[ok], col


def render_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    w2c: np.ndarray,
    K: np.ndarray,
    res: int = 512,
    colors=None,
    bg_color=(1.0, 1.0, 1.0),
    light_dir=(0.4, 0.6, 0.7),
    supersample: int = 2,
) -> np.ndarray:
    """Flat-shaded render; returns (res, res, 3) float in [0, 1].

    K: [fx, fy, cx, cy] for the *output* resolution.
    colors: per-face or per-vertex rgb (optional; default light gray).
    """
    ss = supersample
    R = res * ss
    fx, fy, cx, cy = [k * ss for k in np.asarray(K, np.float64)]

    v_cam = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    tri = v_cam[faces]  # (F, 3, 3)

    # face normals + shading in camera space
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)
    lam = 0.35 + 0.65 * np.abs(norm @ light)

    if colors is None:
        base = np.full((len(faces), 3), 0.75)
    else:
        colors = np.asarray(colors, np.float64)
        base = colors[faces].mean(1) if len(colors) == len(vertices) else colors
    shade = np.clip(base * lam[:, None], 0.0, 1.0)

    # project to screen space, cull behind-camera faces
    z3 = tri[..., 2]
    front = (z3 > 1e-6).all(-1)
    tri, z3, shade = tri[front], z3[front], shade[front]
    tri2d = np.stack(
        [
            fx * tri[..., 0] / np.maximum(tri[..., 2], 1e-6) + cx,
            fy * tri[..., 1] / np.maximum(tri[..., 2], 1e-6) + cy,
        ],
        -1,
    )

    # bin faces by screen bbox size, rasterize each bin densely
    bb_lo = np.floor(tri2d.min(1)).astype(np.int64)
    bb_hi = np.ceil(tri2d.max(1)).astype(np.int64)
    extent = (bb_hi - bb_lo).max(-1) + 1
    onscreen = (bb_hi >= 0).all(-1) & (bb_lo < R).all(-1)

    all_pix, all_depth, all_col = [], [], []
    for grid_n in (4, 8, 16, 32, 64, 128):
        sel = onscreen & (extent <= grid_n) & (
            extent > (grid_n // 2 if grid_n > 4 else 0)
        )
        if not sel.any():
            continue
        pix, depth, col = _raster_bin(
            tri2d[sel], z3[sel], shade[sel], bb_lo[sel], grid_n, R
        )
        all_pix.append(pix)
        all_depth.append(depth)
        all_col.append(col)

    img = np.tile(np.asarray(bg_color, np.float64), (R * R, 1))
    if all_pix:
        pix = np.concatenate(all_pix)
        depth = np.concatenate(all_depth)
        col = np.concatenate(all_col)
        zbuf = np.full(R * R, np.inf)
        np.minimum.at(zbuf, pix, depth)
        win = depth <= zbuf[pix] * (1 + 1e-9)
        img[pix[win]] = col[win]
    img = img.reshape(R, R, 3)
    # box-filter the supersampled buffer (also fills isolated pinholes)
    img = img.reshape(res, ss, res, ss, 3).mean((1, 3))
    return img.astype(np.float32)


def turntable_frames(
    mesh,
    num_frames: int = 18,
    res: int = 512,
    elev_deg: float = 15.0,
    dist_factor: float = 2.5,
    colors=None,
):
    """Orbit the mesh; yields (num_frames, res, res, 3) uint8."""
    verts = np.asarray(mesh.vertices, np.float64)
    center = (verts.max(0) + verts.min(0)) / 2
    radius = float(np.linalg.norm(verts - center, axis=-1).max())
    dist = max(radius * dist_factor, 1e-3)
    K = np.array([res, res, res / 2, res / 2], np.float64)
    frames = []
    for i in range(num_frames):
        ang = 2 * np.pi * i / num_frames
        el = np.radians(elev_deg)
        eye = center + dist * np.array(
            [np.cos(el) * np.sin(ang), np.sin(el), -np.cos(el) * np.cos(ang)]
        )
        img = render_mesh(
            verts, np.asarray(mesh.faces), look_at(eye, center), K, res,
            colors=colors,
        )
        frames.append((img * 255).astype(np.uint8))
    return np.stack(frames)
