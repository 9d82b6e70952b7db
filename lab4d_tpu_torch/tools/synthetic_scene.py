"""Synthetic preprocessed-dataset generator of the port: the same scene,
arrays and config as tests/synthetic.py, written without the JAX package
(frames through PIL, meshes through lab4d_tpu_torch.meshlib).

    python -m lab4d_tpu_torch.tools.synthetic_scene <root> [seqname] [num_vids] [scale_step]

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


if __name__ == "__main__":
    import sys

    make_synthetic_dataset(sys.argv[1], seqname=sys.argv[2] if len(sys.argv) > 2 else "synthetic",
                           num_vids=int(sys.argv[3]) if len(sys.argv) > 3 else 1,
                           scale_step=float(sys.argv[4]) if len(sys.argv) > 4 else 0.0)
