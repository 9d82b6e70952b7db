"""Synthetic preprocessed-dataset generator of the port: the same scene,
arrays and config as tests/synthetic.py, written without the JAX package
(frames through PIL, meshes through lab4d_tpu_torch.meshlib).

    python -m lab4d_tpu_torch.tools.synthetic_scene <root> [seqname] [num_vids] [scale_step]

It also writes the preprocessing pipeline's input: make_raw_scene, the
counterpart of tests/synthetic_raw.py (JPEGs through PIL, byte for byte
what imageio writes), and write_raw_video, the same orbit as a raw video
under database/raw/<vidname>/ (an MJPEG AVI through OpenCV).

Writes the exact database/processed/** layout that the dataloader (and the
reference preprocessing pipeline) uses, so training / rendering / export
can be exercised end-to-end without real videos:

  database/configs/<seq>.config
  database/processed/JPEGImages/Full-Resolution/<vid>/{%05d.jpg, crop-R.npy}
  .../JPEGImagesRaw/<vid>/%05d.jpg
  .../Annotations/<vid>/{crop-R.npy, crop-R-crop2raw.npy, crop-R-is_detected.npy}
  .../FlowFW_{1,2,4,8}, FlowBW_{1,2,4,8}/<vid>/crop-R.npy
  .../Depth/<vid>/crop-R.npy
  .../Features/<vid>/crop-R-dinov2-01.npy
  .../Cameras/<vid>/{00.npy, 01-canonical.npy, mesh-00-centered.obj,
                     mesh-01-centered.obj}

The scene is a lambertian sphere orbited by the camera; rgb/mask/depth/
flow are analytically consistent, so optimization losses are meaningful.
With scale_step > 0 each video of a multi-video scene (a category) has a
sphere of its own size, radius * (1 + scale_step * vid), for the
per-video instance codes to fit; at 0 (the default) every video has the
same sphere, as tests/synthetic.py writes it.
"""

from __future__ import annotations

import os

import numpy as np


def _lookat_pose(t: float, dist: float = 3.0):
    """Object-to-camera SE(3) for a camera orbiting the origin."""
    ang = 2 * np.pi * t
    # camera at (dist*sin, 0, -dist*cos) looking at origin along +z
    R_y = np.array(
        [
            [np.cos(ang), 0, -np.sin(ang)],
            [0, 1, 0],
            [np.sin(ang), 0, np.cos(ang)],
        ]
    )
    rt = np.eye(4)
    rt[:3, :3] = R_y
    rt[2, 3] = dist
    return rt


def render_sphere_frame(rt, K, res, radius=0.5):
    """Ray-trace a sphere: rgb, mask, depth (camera z)."""
    xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    fx, fy, cx, cy = K
    d = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, dtype=np.float64)], -1
    )
    # camera center in object space
    R = rt[:3, :3]
    tvec = rt[:3, 3]
    cam_origin = -R.T @ tvec
    dirs = d @ R  # rotate ray dirs into object space: R^T @ d
    # solve |o + s*dir|^2 = r^2
    b = 2 * dirs @ cam_origin
    a = np.sum(dirs * dirs, -1)
    c = cam_origin @ cam_origin - radius**2
    disc = b**2 - 4 * a * c
    hit = disc > 0
    s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    pts = cam_origin + s[..., None] * dirs  # object-space surface points
    normal = pts / radius
    # simple shading + position-based color
    light = np.array([0.5, 0.7, 0.5])
    lam = np.clip(normal @ light, 0, 1)
    rgb = 0.3 + 0.5 * lam[..., None] * (0.5 + 0.5 * np.abs(normal))
    rgb = np.where(hit[..., None], rgb, 0.0)
    depth = np.where(hit, s * d[..., 2], 0.0)  # z-depth
    return rgb.astype(np.float32), hit, depth.astype(np.float32), pts, normal


def make_synthetic_dataset(
    root: str,
    seqname: str = "synthetic",
    num_vids: int = 1,
    num_frames: int = 16,
    res: int = 64,
    feat_res: int = 16,
    radius: float = 0.5,
    scale_step: float = 0.0,
):
    """Generate the dataset; returns the database root path. Video vid's
    sphere has radius * (1 + scale_step * vid)."""
    radii = [radius * (1 + scale_step * vid) for vid in range(num_vids)]
    os.makedirs(f"{root}/configs", exist_ok=True)
    proc = f"{root}/processed"
    deltas = [1, 2, 4, 8]
    # init_frame/end_frame defaults make the config loadable by the
    # reference's parser too (lab4d/dataloader/data_utils.py:196-204
    # reads them with no fallback) — used by scripts/compare_reference_psnr.py
    cfg_lines = ["[data]", "init_frame = 0", "end_frame = -1", ""]

    for vid in range(num_vids):
        vidname = f"{seqname}-{vid:04d}"
        radius = radii[vid]
        dirs = {}
        for sub in (
            ["JPEGImages", "JPEGImagesRaw", "Annotations", "Depth", "Features",
             "Cameras"]
            + [f"FlowFW_{d}" for d in deltas]
            + [f"FlowBW_{d}" for d in deltas]
        ):
            dirs[sub] = f"{proc}/{sub}/Full-Resolution/{vidname}"
            os.makedirs(dirs[sub], exist_ok=True)

        K = np.array([1.2 * res, 1.2 * res, res / 2, res / 2], np.float64)
        rts = np.stack(
            [
                _lookat_pose((i + 3 * vid) / num_frames)
                for i in range(num_frames)
            ]
        )

        rgbs, masks, depths, uvs = [], [], [], []
        for i in range(num_frames):
            rgb, hit, depth, pts, _ = render_sphere_frame(rts[i], K, res, radius)
            rgbs.append(rgb)
            masks.append(hit)
            depths.append(depth)
            # screen-projection cache for flow: project pts with each cam
            uvs.append(pts)

        def project(pts, rt):
            p = pts @ rt[:3, :3].T + rt[:3, 3]
            fx, fy, cx, cy = K
            return np.stack(
                [
                    fx * p[..., 0] / np.maximum(p[..., 2], 1e-6) + cx,
                    fy * p[..., 1] / np.maximum(p[..., 2], 1e-6) + cy,
                ],
                -1,
            )

        xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
        base_xy = np.stack([xs, ys], -1).astype(np.float32)

        flows_fw = {d: [] for d in deltas}
        flows_bw = {d: [] for d in deltas}
        for d in deltas:
            for i in range(0, num_frames - d, d):
                nxt = project(uvs[i], rts[i + d]) - base_xy
                uct = masks[i][..., None].astype(np.float32)
                flows_fw[d].append(
                    np.concatenate([nxt, uct], -1).astype(np.float32)
                )
                prv = project(uvs[i + d], rts[i]) - base_xy
                uct = masks[i + d][..., None].astype(np.float32)
                flows_bw[d].append(
                    np.concatenate([prv, uct], -1).astype(np.float32)
                )

        # write everything in the reference layout
        from PIL import Image

        for i in range(num_frames):
            frame8 = Image.fromarray((np.clip(rgbs[i], 0, 1) * 255).astype(np.uint8))
            frame8.save(f"{dirs['JPEGImages']}/{i:05d}.jpg")
            frame8.save(f"{dirs['JPEGImagesRaw']}/{i:05d}.jpg")

        prefix = f"crop-{res}"
        np.save(
            f"{dirs['JPEGImages']}/{prefix}.npy",
            np.stack(rgbs).astype(np.float16),
        )
        mask2 = np.stack(
            [
                np.stack([m, np.ones_like(m)], axis=-1).astype(bool)
                for m in masks
            ]
        )
        np.save(f"{dirs['Annotations']}/{prefix}.npy", mask2)
        np.save(
            f"{dirs['Annotations']}/{prefix}-crop2raw.npy",
            np.tile(
                np.array([1.0, 1.0, 0.0, 0.0], np.float32), (num_frames, 1)
            ),
        )
        np.save(
            f"{dirs['Annotations']}/{prefix}-is_detected.npy",
            np.ones(num_frames, np.float32),
        )
        np.save(
            f"{dirs['Depth']}/{prefix}.npy",
            np.stack(depths).astype(np.float16),
        )
        for d in deltas:
            if flows_fw[d]:
                np.save(
                    f"{dirs[f'FlowFW_{d}']}/{prefix}.npy",
                    np.stack(flows_fw[d]),
                )
                np.save(
                    f"{dirs[f'FlowBW_{d}']}/{prefix}.npy",
                    np.stack(flows_bw[d]),
                )
        # features: normal-based 16-d descriptors at feat_res
        feats = []
        for i in range(num_frames):
            _, hit, _, pts, normal = render_sphere_frame(
                rts[i], K * feat_res / res, feat_res, radius
            )
            f = np.concatenate(
                [normal, pts / radius, np.ones_like(normal[..., :1])], -1
            )
            f = np.tile(f, (1, 1, 3))[..., :16]
            f = f / np.maximum(
                np.linalg.norm(f, axis=-1, keepdims=True), 1e-6
            )
            feats.append(np.where(hit[..., None], f, 0.0))
        np.save(
            f"{dirs['Features']}/{prefix}-dinov2-01.npy",
            np.stack(feats).astype(np.float16),
        )

        np.save(f"{dirs['Cameras']}/00.npy", rts.astype(np.float32))
        np.save(f"{dirs['Cameras']}/01-canonical.npy", rts.astype(np.float32))

        # init meshes (unit-ish sphere for both fields)
        from lab4d_tpu_torch.meshlib import uv_sphere

        uv_sphere(radius=radius, count=[12, 12]).export(
            f"{dirs['Cameras']}/mesh-00-centered.obj"
        )
        uv_sphere(radius=radius, count=[12, 12]).export(
            f"{dirs['Cameras']}/mesh-01-centered.obj"
        )

        cfg_lines += [
            f"[data_{vid}]",
            f"img_path = {dirs['JPEGImages']}",
            f"ks = {K[0]} {K[1]} {K[2]} {K[3]}",
            f"shape = {res} {res}",
            "",
        ]

    with open(f"{root}/configs/{seqname}.config", "w") as f:
        f.write("\n".join(cfg_lines))
    return root



# ---------------------------------------------------------------------------
# raw scene: the preprocessing pipeline's input (tests/synthetic_raw.py)
# ---------------------------------------------------------------------------

FG_RADIUS = 0.5
BG_RADIUS = 6.0
CAM_DIST = 3.0


def _texture(p: np.ndarray, freqs=(3.1, 5.7, 9.3)) -> np.ndarray:
    """Procedural smooth 3D texture: (..., 3) rgb in [0, 1]."""
    r = np.zeros(p.shape[:-1] + (3,))
    for i, f in enumerate(freqs):
        phase = p @ np.array([f, f * 1.3 + i, f * 0.7 - i])
        r[..., i] = 0.5 + 0.3 * np.sin(phase) + 0.2 * np.sin(2.3 * phase + 1.0)
    return np.clip(r, 0, 1)


def _sphere_hit(origin, dirs, radius, inner=False):
    """Ray-sphere; returns (s, hit). inner=True takes the far root."""
    b = 2 * dirs @ origin
    a = np.sum(dirs * dirs, -1)
    c = origin @ origin - radius**2
    disc = b**2 - 4 * a * c
    ok = disc > 0
    sq = np.sqrt(np.maximum(disc, 0))
    s = (-b + sq) / (2 * a) if inner else (-b - sq) / (2 * a)
    ok = ok & (s > 0)
    return np.where(ok, s, 0.0), ok


def orbit_pose(t: float, dist: float = CAM_DIST):
    """Scene-to-camera SE(3), the camera orbiting the origin (y-axis)."""
    return _lookat_pose(t, dist)


def render_raw_frame(rt, K, res, tex_freqs=None, fg_radius: float = FG_RADIUS):
    """A textured sphere (fg, radius `fg_radius` at the origin) inside a
    textured room sphere (bg, radius 6): rgb (res,res,3), mask (fg bool),
    depth (z), pts (scene xyz). `tex_freqs` (3 floats) replace the fg
    texture's frequencies; the bg texture keeps its own."""
    xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    fx, fy, cx, cy = K
    d = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, float)], -1)
    R, tvec = rt[:3, :3], rt[:3, 3]
    origin = -R.T @ tvec
    dirs = d @ R

    s_fg, hit_fg = _sphere_hit(origin, dirs, fg_radius)
    s_bg, hit_bg = _sphere_hit(origin, dirs, BG_RADIUS, inner=True)
    use_fg = hit_fg & (~hit_bg | (s_fg < s_bg))
    s = np.where(use_fg, s_fg, s_bg)
    pts = origin + s[..., None] * dirs

    normal_fg = pts / fg_radius
    normal_bg = -pts / BG_RADIUS
    normal = np.where(use_fg[..., None], normal_fg, normal_bg)
    light = np.array([0.5, 0.7, 0.5])
    lam = 0.4 + 0.6 * np.clip(normal @ light, 0, 1)
    fg_tex = _texture(pts * 4.0) if tex_freqs is None else _texture(
        pts * 4.0, freqs=tuple(tex_freqs))
    tex = np.where(use_fg[..., None], fg_tex, _texture(pts, freqs=(1.3, 2.1, 0.9)))
    rgb = np.clip(lam[..., None] * tex, 0, 1)
    depth = s * d[..., 2]
    return rgb.astype(np.float32), use_fg, depth.astype(np.float32), pts


def project_points(pts, rt, K):
    p = pts @ rt[:3, :3].T + rt[:3, 3]
    fx, fy, cx, cy = K
    z = np.maximum(p[..., 2], 1e-6)
    return np.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def raw_orbit(num_frames: int, res: int, orbit_span: float):
    """Intrinsics (focal = max(H, W), the pipeline's guess) and the
    scene-to-camera poses of the orbit."""
    K = np.array([float(res), float(res), res / 2, res / 2], np.float64)
    rts = np.stack([_lookat_pose(orbit_span * i / num_frames, CAM_DIST)
                    for i in range(num_frames)])
    return K, rts


def make_raw_scene(
    root: str,
    seqname: str = "rawsim-0000",
    num_frames: int = 12,
    res: int = 96,
    write_masks: bool = True,
    write_depth: bool = True,
    write_flow: bool = True,
    deltas=(1, 2, 4, 8),
    orbit_span: float = 0.6,
):
    """Write the raw scene under <root>/processed (JPEGImages and
    JPEGImagesRaw at quality 95, optional GT masks, depth and flow);
    returns a dict of GT arrays, as tests/synthetic_raw.py does."""
    from PIL import Image

    proc = f"{root}/processed"
    dirs = {}
    subs = ["JPEGImages", "JPEGImagesRaw", "Annotations", "Depth"] + [
        f"Flow{d}_{k}" for k in deltas for d in ("FW", "BW")
    ]
    for sub in subs:
        dirs[sub] = f"{proc}/{sub}/Full-Resolution/{seqname}"
        os.makedirs(dirs[sub], exist_ok=True)

    K, rts = raw_orbit(num_frames, res, orbit_span)
    rgbs, masks, depths, pts_all = [], [], [], []
    for i in range(num_frames):
        rgb, fg, depth, pts = render_raw_frame(rts[i], K, res)
        rgbs.append(rgb)
        masks.append(fg)
        depths.append(depth)
        pts_all.append(pts)
        frame8 = Image.fromarray((rgb * 255).astype(np.uint8))
        frame8.save(f"{dirs['JPEGImages']}/{i:05d}.jpg", "JPEG", quality=95)
        frame8.save(f"{dirs['JPEGImagesRaw']}/{i:05d}.jpg", "JPEG", quality=95)
        if write_masks:
            np.save(f"{dirs['Annotations']}/{i:05d}.npy", fg.astype(np.int8))
        if write_depth:
            np.save(f"{dirs['Depth']}/{i:05d}.npy", depth.astype(np.float16))

    if write_flow:
        xs, ys = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
        base = np.stack([xs, ys], -1).astype(np.float32)
        for d in deltas:
            for i in range(num_frames - d):
                fw = project_points(pts_all[i], rts[i + d], K) - base
                bw = project_points(pts_all[i + d], rts[i], K) - base
                # occ: negative logit = visible (synthetic: all visible)
                occ = -np.ones((res, res, 1), np.float32)
                np.save(
                    f"{dirs[f'FlowFW_{d}']}/{i:05d}.npy",
                    np.concatenate([fw, occ], -1).astype(np.float32),
                )
                np.save(
                    f"{dirs[f'FlowBW_{d}']}/{i + d:05d}.npy",
                    np.concatenate([bw, occ], -1).astype(np.float32),
                )

    return {
        "K": K,
        "rts": rts,
        "rgbs": np.stack(rgbs),
        "masks": np.stack(masks),
        "depths": np.stack(depths),
        "seqname": seqname,
        "root": root,
    }


def _rodrigues(v: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(v)
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def rotation_fit_inputs(kind: str, n: int = 16):
    """(chain (n,4,4) float32, {frame: rotation}) for the canonical
    rotation fit. "consistent": the orbit and its own rotations at frames
    0 and 5 (the fit stops at once); "inconsistent": a chain with 6 deg of
    noise per frame and annotations at every 4th frame with 6 deg of their
    own (seed 1; the fit runs all its iterations)."""
    gt = np.stack([_lookat_pose(0.6 * i / n) for i in range(n)])
    if kind == "consistent":
        gt = gt.astype(np.float32)
        return gt, {0: gt[0], 5: gt[5]}
    rng = np.random.default_rng(1)

    def noise():
        return _rodrigues(rng.standard_normal(3) * np.radians(6) / np.sqrt(3))

    chain = gt.copy()
    for i in range(1, n):
        chain[i, :3, :3] = noise() @ gt[i, :3, :3]
    return chain.astype(np.float32), {k: (noise() @ gt[k, :3, :3]).astype(np.float32)
                                      for k in range(0, n, 4)}


def write_raw_video(database_root: str, vidname: str, num_frames: int = 64, res: int = 512,
                    orbit_span: float = 0.12, lead_black: int = 1, fps: int = 10) -> str:
    """The raw scene's orbit as database/raw/<vidname>/<vidname>.avi
    (MJPEG, OpenCV's own encoder), after `lead_black` black frames (the
    frame extractor skips them). Returns the video's path."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    out_dir = f"{database_root}/raw/{vidname}"
    os.makedirs(out_dir, exist_ok=True)
    path = f"{out_dir}/{vidname}.avi"
    K, rts = raw_orbit(num_frames, res, orbit_span)
    writer = cv2.VideoWriter(path, cv2.CAP_OPENCV_MJPEG, cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (res, res))
    if not writer.isOpened():
        raise IOError(f"OpenCV cannot write {path}")
    try:
        for _ in range(lead_black):
            writer.write(np.zeros((res, res, 3), np.uint8))
        # numpy releases the interpreter lock in the render's array work
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for rgb, *_ in pool.map(lambda rt: render_raw_frame(rt, K, res), rts):
                writer.write(np.ascontiguousarray((rgb * 255).astype(np.uint8)[..., ::-1]))
    finally:
        writer.release()
    return path

if __name__ == "__main__":
    import sys

    make_synthetic_dataset(sys.argv[1], seqname=sys.argv[2] if len(sys.argv) > 2 else "synthetic",
                           num_vids=int(sys.argv[3]) if len(sys.argv) > 3 else 1,
                           scale_step=float(sys.argv[4]) if len(sys.argv) > 4 else 0.0)
