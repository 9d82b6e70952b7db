"""Visualization helpers: tag-aware colorization, image grids, bone and
camera meshes, rgb-d meshes. The port's copy of lab4d_tpu/utils/vis.py
(bone colours without matplotlib)."""

from __future__ import annotations

import numpy as np

from lab4d_tpu_torch.meshlib import Mesh, concatenate, uv_sphere

# matplotlib's gist_rainbow (its segment data, sampled into 256 entries as
# matplotlib does), so that bone colours need no matplotlib
_GIST_RAINBOW = (
    (0.0, (1.0, 0.0, 0.16)), (0.03, (1.0, 0.0, 0.0)), (0.215, (1.0, 1.0, 0.0)),
    (0.4, (0.0, 1.0, 0.0)), (0.586, (0.0, 1.0, 1.0)), (0.77, (0.0, 0.0, 1.0)),
    (0.954, (1.0, 0.0, 1.0)), (1.0, (1.0, 0.0, 0.75)),
)


def flow_to_color(flow: np.ndarray, max_mag=None) -> np.ndarray:
    """HSV flow wheel: hue = direction, saturation = magnitude."""
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u**2 + v**2)
    ang = np.arctan2(v, u)  # [-pi, pi]
    if max_mag is None:
        max_mag = max(np.percentile(mag, 99), 1e-6)
    h = (ang + np.pi) / (2 * np.pi)
    s = np.clip(mag / max_mag, 0, 1)
    hsv = np.stack([h, s, np.ones_like(h)], axis=-1)
    # vectorized hsv->rgb
    i = np.floor(hsv[..., 0] * 6).astype(int) % 6
    f = hsv[..., 0] * 6 - np.floor(hsv[..., 0] * 6)
    p = hsv[..., 2] * (1 - hsv[..., 1])
    q = hsv[..., 2] * (1 - f * hsv[..., 1])
    t = hsv[..., 2] * (1 - (1 - f) * hsv[..., 1])
    vv = hsv[..., 2]
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([vv, t, p], -1), np.stack([q, vv, p], -1),
            np.stack([p, vv, t], -1), np.stack([p, q, vv], -1),
            np.stack([t, p, vv], -1), np.stack([vv, p, q], -1),
        ],
    )
    return rgb


def depth_to_color(depth: np.ndarray) -> np.ndarray:
    """Plasma colormap over normalized inverse depth."""
    import matplotlib.cm as cm

    d = depth[..., 0] if depth.ndim == 3 else depth
    valid = d > 0
    if valid.any():
        lo, hi = np.percentile(d[valid], [2, 98])
        d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    return cm.plasma(d)[..., :3]


def img2color(tag: str, img: np.ndarray, pca_fn=None) -> np.ndarray:
    """Map a rendered buffer to an RGB image by tag (vis_utils.py:19-49)."""
    img = np.asarray(img, dtype=np.float32)
    if "depth" in tag:
        return depth_to_color(img)
    if "flow" in tag:
        return flow_to_color(img[..., :2])
    if "feature" in tag:
        if pca_fn is not None:
            return np.clip(pca_fn(img, normalize=True), 0, 1)
        return np.clip(img[..., :3] * 0.5 + 0.5, 0, 1)
    if "normal" in tag:
        return np.clip(img * 0.5 + 0.5, 0, 1)
    if "xyz" in tag:
        rng = img.max() - img.min()
        return (img - img.min()) / max(rng, 1e-6)
    if img.shape[-1] == 1:
        return np.clip(np.repeat(img, 3, axis=-1), 0, 1)
    return np.clip(img[..., :3], 0, 1)


def make_image_grid(imgs: np.ndarray) -> np.ndarray:
    """(M, H, W, C) -> tiled grid image (~square layout)."""
    M = imgs.shape[0]
    cols = int(np.ceil(np.sqrt(M)))
    rows = int(np.ceil(M / cols))
    H, W, C = imgs.shape[1:]
    grid = np.zeros((rows * H, cols * W, C), imgs.dtype)
    for i in range(M):
        r, c = divmod(i, cols)
        grid[r * H : (r + 1) * H, c * W : (c + 1) * W] = imgs[i]
    return grid


def get_colormap(num: int, repeat: int = 1) -> np.ndarray:
    """Distinct colors (0-255) for bone visualization: matplotlib's
    gist_rainbow at num evenly spaced points."""
    xs = np.array([x for x, _ in _GIST_RAINBOW])
    rgb = np.array([c for _, c in _GIST_RAINBOW])
    lut = np.stack([np.interp(np.linspace(0, 1, 256), xs, rgb[:, i]) for i in range(3)], -1)
    idx = np.clip((np.linspace(0, 1, max(num, 1)) * 256).astype(int), 0, 255)
    return np.repeat(lut[idx] * 255, repeat, axis=0)


def draw_skeleton_bones(centers: np.ndarray, edges=None, radius=5e-3) -> Mesh:
    """Small spheres at bone centers (+ simple edge struts)."""
    meshes = []
    cmap = get_colormap(len(centers))
    for k, c in enumerate(centers):
        s = uv_sphere(radius=radius, count=[4, 4])
        s.vertices = s.vertices + c
        s.vertex_colors = np.tile(cmap[k], (len(s.vertices), 1))
        meshes.append(s)
    if edges is not None:
        for child, parent in edges.items():
            if parent <= 0:
                continue
            meshes.append(_strut(centers[parent - 1], centers[child - 1], radius * 0.3))
    return concatenate(meshes)


def _strut(a, b, r) -> Mesh:
    """Triangular prism between two points."""
    d = b - a
    n = np.linalg.norm(d)
    if n < 1e-9:
        return Mesh()
    d = d / n
    u = np.cross(d, [0, 0, 1.0])
    if np.linalg.norm(u) < 1e-6:
        u = np.cross(d, [0, 1.0, 0])
    u = u / np.linalg.norm(u)
    w = np.cross(d, u)
    offs = [u * r, (-0.5 * u + 0.866 * w) * r, (-0.5 * u - 0.866 * w) * r]
    verts = [a + o for o in offs] + [b + o for o in offs]
    faces = [
        [0, 1, 2], [3, 5, 4],
        [0, 3, 1], [1, 3, 4], [1, 4, 2], [2, 4, 5], [2, 5, 0], [0, 5, 3],
    ]
    return Mesh(np.asarray(verts), np.asarray(faces))


def draw_cams(rtmats: np.ndarray, scale: float = 0.1) -> Mesh:
    """Camera frusta meshes from (M, 4, 4) object-to-camera transforms
    (vis_utils.py:68+). Frusta are drawn at the camera centers in object
    space (cam-to-object inverse applied)."""
    meshes = []
    # simple pyramid pointing +z
    pts = np.array(
        [[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
        dtype=np.float64,
    ) * scale * 0.5
    faces = np.array(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 3, 2], [1, 4, 3]]
    )
    for rt in rtmats:
        rt = np.asarray(rt)
        cam2obj = np.linalg.inv(
            np.vstack([rt[:3], [[0, 0, 0, 1]]]) if rt.shape[0] == 3 else rt
        )
        m = Mesh(pts.copy(), faces.copy())
        m.apply_transform(cam2obj)
        meshes.append(m)
    return concatenate(meshes)


def minmax_normalize(x: np.ndarray) -> np.ndarray:
    """Scale to [0, 1] (vis_utils.py parity)."""
    lo, hi = np.min(x), np.max(x)
    return (x - lo) / max(hi - lo, 1e-12)


def image_to_mesh(rgb: np.ndarray, depth: np.ndarray, K, mask=None,
                  max_depth_jump: float = 0.1) -> Mesh:
    """Unproject an rgb-d image into a colored triangle mesh
    (vis_utils.py image_to_mesh parity): grid triangulation with edges
    dropped across depth discontinuities."""
    h, w = depth.shape[:2]
    fx, fy, cx, cy = K
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    z = depth.reshape(h, w)
    pts = np.stack(
        [(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1
    ).reshape(-1, 3)
    colors = rgb.reshape(-1, rgb.shape[-1])[:, :3]

    idx = np.arange(h * w).reshape(h, w)
    a, b, c, d = (
        idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(),
        idx[1:, :-1].ravel(), idx[1:, 1:].ravel(),
    )
    faces = np.concatenate(
        [np.stack([a, c, b], -1), np.stack([b, c, d], -1)], 0
    )
    zf = z.reshape(-1)
    ok = np.ones(len(faces), bool)
    for i in range(3):
        for j in range(i + 1, 3):
            ok &= np.abs(zf[faces[:, i]] - zf[faces[:, j]]) < max_depth_jump
        ok &= zf[faces[:, i]] > 0
    if mask is not None:
        mf = mask.reshape(-1) > 0
        for i in range(3):
            ok &= mf[faces[:, i]]
    return Mesh(pts, faces[ok], vertex_colors=colors)
