"""The synthetic orbit scene of the benchmark, drawn from the seed.

A lambertian sphere orbited by the camera: rgb, mask, depth, flow and
features analytically consistent, written in the database/processed/**
layout that the program's dataloader reads. Every seed gives the same
sizes (frames, resolution, feature resolution); the seed moves the orbit's
start, the sphere's radius and the light. A copy of the program's
`tools/synthetic_scene.py` writer, with those draws added and the meshes
written by `write_obj` below.
"""

from __future__ import annotations

import os

import numpy as np

DELTAS = (1, 2, 4, 8)
CAM_DIST = 3.0


def scene_params(seed: int, num_frames: int, res: int) -> dict:
    """The scene's sizes and its draws from the seed."""
    rng = np.random.default_rng(seed)
    light = np.array([0.5, 0.7, 0.5]) + rng.uniform(-0.2, 0.2, 3)
    return {
        "num_frames": num_frames,
        "res": res,
        "phase": float(rng.uniform(0.0, 1.0)),
        "radius": float(rng.uniform(0.45, 0.55)),
        "light": light,
        "K": np.array([1.2 * res, 1.2 * res, res / 2, res / 2], np.float64),
    }


def lookat_pose(t: float, dist: float = CAM_DIST) -> np.ndarray:
    """Object-to-camera SE(3) of a camera orbiting the origin."""
    ang = 2 * np.pi * t
    rt = np.eye(4)
    rt[:3, :3] = [[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0], [np.sin(ang), 0, np.cos(ang)]]
    rt[2, 3] = dist
    return rt


def orbit(params: dict) -> np.ndarray:
    """(frames, 4, 4) object-to-camera poses."""
    n = params["num_frames"]
    return np.stack([lookat_pose(params["phase"] + i / n) for i in range(n)])


def render_sphere_frame(rt, K, res, radius, light):
    """Ray-trace the sphere: rgb, mask, depth (camera z), points, normals."""
    xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    fx, fy, cx, cy = K
    d = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, dtype=np.float64)], -1)
    R, tvec = rt[:3, :3], rt[:3, 3]
    cam_origin = -R.T @ tvec
    dirs = d @ R
    b = 2 * dirs @ cam_origin
    a = np.sum(dirs * dirs, -1)
    c = cam_origin @ cam_origin - radius**2
    disc = b**2 - 4 * a * c
    hit = disc > 0
    s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    pts = cam_origin + s[..., None] * dirs
    normal = pts / radius
    lam = np.clip(normal @ light, 0, 1)
    rgb = 0.3 + 0.5 * lam[..., None] * (0.5 + 0.5 * np.abs(normal))
    rgb = np.where(hit[..., None], rgb, 0.0)
    depth = np.where(hit, s * d[..., 2], 0.0)
    return rgb.astype(np.float32), hit, depth.astype(np.float32), pts, normal


def uv_sphere(radius: float, count=(12, 12)):
    """Vertices and faces of a latitude-longitude sphere."""
    n_lat, n_lon = max(count[0], 3), max(count[1], 3)
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    grid_lat, grid_lon = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([np.sin(grid_lat) * np.cos(grid_lon), np.sin(grid_lat) * np.sin(grid_lon),
                      np.cos(grid_lat)], -1).reshape(-1, 3) * radius
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces)


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        f.writelines(f"v {x:.8f} {y:.8f} {z:.8f}\n" for x, y, z in verts)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)


def write_scene(root: str, seqname: str, params: dict, feat_res: int = 16) -> str:
    """Write one video of the scene under root (the database root); returns it."""
    num_frames, res, radius, light, K = (params[k] for k in
                                         ("num_frames", "res", "radius", "light", "K"))
    vidname = f"{seqname}-0000"
    proc = f"{root}/processed"
    subs = (["JPEGImages", "Annotations", "Depth", "Features", "Cameras"]
            + [f"FlowFW_{d}" for d in DELTAS] + [f"FlowBW_{d}" for d in DELTAS])
    dirs = {sub: f"{proc}/{sub}/Full-Resolution/{vidname}" for sub in subs}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    os.makedirs(f"{root}/configs", exist_ok=True)
    rts = orbit(params)
    frames = [render_sphere_frame(rts[i], K, res, radius, light) for i in range(num_frames)]
    rgbs, masks, depths, pts = ([f[j] for f in frames] for j in range(4))

    def project(p, rt):
        p = p @ rt[:3, :3].T + rt[:3, 3]
        fx, fy, cx, cy = K
        z = np.maximum(p[..., 2], 1e-6)
        return np.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)

    xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    base_xy = np.stack([xs, ys], -1).astype(np.float32)
    prefix = f"crop-{res}"
    for d in DELTAS:
        fw, bw = [], []
        for i in range(0, num_frames - d, d):
            fw.append(np.concatenate([project(pts[i], rts[i + d]) - base_xy,
                                      masks[i][..., None]], -1).astype(np.float32))
            bw.append(np.concatenate([project(pts[i + d], rts[i]) - base_xy,
                                      masks[i + d][..., None]], -1).astype(np.float32))
        if fw:
            np.save(f"{dirs[f'FlowFW_{d}']}/{prefix}.npy", np.stack(fw))
            np.save(f"{dirs[f'FlowBW_{d}']}/{prefix}.npy", np.stack(bw))

    from PIL import Image

    for i in range(num_frames):
        Image.fromarray((np.clip(rgbs[i], 0, 1) * 255).astype(np.uint8)).save(
            f"{dirs['JPEGImages']}/{i:05d}.jpg")
    np.save(f"{dirs['JPEGImages']}/{prefix}.npy", np.stack(rgbs).astype(np.float16))
    np.save(f"{dirs['Annotations']}/{prefix}.npy",
            np.stack([np.stack([m, np.ones_like(m)], -1) for m in masks]).astype(bool))
    np.save(f"{dirs['Annotations']}/{prefix}-crop2raw.npy",
            np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (num_frames, 1)))
    np.save(f"{dirs['Annotations']}/{prefix}-is_detected.npy", np.ones(num_frames, np.float32))
    np.save(f"{dirs['Depth']}/{prefix}.npy", np.stack(depths).astype(np.float16))
    feats = []
    for i in range(num_frames):
        _, hit, _, p, normal = render_sphere_frame(rts[i], K * feat_res / res, feat_res, radius,
                                                   light)
        f = np.concatenate([normal, p / radius, np.ones_like(normal[..., :1])], -1)
        f = np.tile(f, (1, 1, 3))[..., :16]
        f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-6)
        feats.append(np.where(hit[..., None], f, 0.0))
    np.save(f"{dirs['Features']}/{prefix}-dinov2-01.npy", np.stack(feats).astype(np.float16))
    np.save(f"{dirs['Cameras']}/00.npy", rts.astype(np.float32))
    np.save(f"{dirs['Cameras']}/01-canonical.npy", rts.astype(np.float32))
    verts, faces = uv_sphere(radius)
    for name in ("mesh-00-centered.obj", "mesh-01-centered.obj"):
        write_obj(f"{dirs['Cameras']}/{name}", verts, faces)
    with open(f"{root}/configs/{seqname}.config", "w") as f:
        f.write("\n".join(["[data]", "init_frame = 0", "end_frame = -1", "",
                           f"[data_0]", f"img_path = {dirs['JPEGImages']}",
                           f"ks = {K[0]} {K[1]} {K[2]} {K[3]}", f"shape = {res} {res}", ""]))
    return root
