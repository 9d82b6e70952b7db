"""TSDF fusion of registered depth frames into a scene mesh (port of
preprocess/scripts/tsdf_fusion.py).

The voxel grid (up to 128^3) lives on the device; each frame's
integration projects every voxel, gathers its depth, and updates the
truncated SDF as a weighted running average, one frame after another
(JAX scans the frames with lax.scan). The fused grid feeds marching
tets on the host; the mesh is recentered and the camera trajectory
shifted accordingly (the scene origin becomes the mesh centre), then
both are written next to the cameras.
"""

from __future__ import annotations

import sys

import cv2
import numpy as np
import torch

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.libs.io import (
    K2inv_np,
    K2mat_np,
    default_intrinsics,
    frame_list,
    load_frame_data,
)

MAX_DEPTH = 10.0
GRID_DIM = 128  # voxels per axis


def integrate(tsdf: torch.Tensor, weight: torch.Tensor, vox: torch.Tensor,
              depths: torch.Tensor, Ks: torch.Tensor, scene2cams: torch.Tensor, trunc: float):
    """Integrate frames into (tsdf, weight) (V,) at voxel centres vox (V, 3).
    depths (T, H, W), Ks (T, 4) [fx fy px py], scene2cams (T, 4, 4)."""
    h, w = depths.shape[-2:]
    for depth, K, s2c in zip(depths, Ks, scene2cams):
        pts_cam = vox @ s2c[:3, :3].T + s2c[:3, 3]
        z = pts_cam[:, 2]
        u = K[0] * pts_cam[:, 0] / torch.clamp(z, min=1e-6) + K[2]
        v = K[1] * pts_cam[:, 1] / torch.clamp(z, min=1e-6) + K[3]
        ui = torch.clamp(torch.round(u).long(), 0, w - 1)
        vi = torch.clamp(torch.round(v).long(), 0, h - 1)
        d = depth[vi, ui]
        inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 0) & (d > 0)
        sdf = d - z
        obs = torch.clamp(sdf / trunc, -1.0, 1.0)
        upd = inside & (sdf >= -trunc)
        w_new = weight + upd.float()
        tsdf = torch.where(upd, (tsdf * weight + obs) / torch.clamp(w_new, min=1e-6), tsdf)
        weight = w_new
    return tsdf, weight


def tsdf_fusion(
    seqname: str,
    component_id: int,
    outdir: str = "database/processed",
    crop_size: int = 256,
    use_full: bool = True,
    voxel_size: float = 0.2,
    device=None,
):
    dev = resolve_device(device)
    img_paths = frame_list(outdir, seqname)
    cam_dir = f"{outdir}/Cameras/Full-Resolution/{seqname}"
    scene2cams = np.load(f"{cam_dir}/{component_id:02d}.npy")
    Kraw = K2mat_np(default_intrinsics(cv2.imread(img_paths[0]).shape))

    # pass 1: load frames, compute scene bounds from masked depth points
    depths, Ks = [], []
    bounds_lo = np.full(3, np.inf)
    bounds_hi = np.full(3, -np.inf)
    for t, path in enumerate(img_paths[:-1]):
        _, depth, mask, crop2raw = load_frame_data(
            path, crop_size, use_full, component_id
        )
        depth = np.where(mask & (depth < MAX_DEPTH), depth, 0.0)
        K = K2inv_np(crop2raw) @ Kraw
        depths.append(depth.astype(np.float32))
        Ks.append(np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32))
        ys, xs = np.nonzero(depth > 0)
        if len(xs) == 0:
            continue
        z = depth[ys, xs]
        pts_cam = np.stack(
            [(xs - K[0, 2]) / K[0, 0] * z, (ys - K[1, 2]) / K[1, 1] * z, z], -1
        )
        cam2scene = np.linalg.inv(scene2cams[t])
        pts = pts_cam @ cam2scene[:3, :3].T + cam2scene[:3, 3]
        bounds_lo = np.minimum(bounds_lo, pts.min(0))
        bounds_hi = np.maximum(bounds_hi, pts.max(0))

    if not np.isfinite(bounds_lo).all():
        raise RuntimeError(f"tsdf_fusion: no valid depth for {seqname}")
    # pad and pick an isotropic voxel size that fits the grid
    pad = 2 * voxel_size
    bounds_lo, bounds_hi = bounds_lo - pad, bounds_hi + pad
    vsize = max(voxel_size, float((bounds_hi - bounds_lo).max()) / (GRID_DIM - 1))
    dims = np.minimum(
        np.ceil((bounds_hi - bounds_lo) / vsize).astype(int) + 1, GRID_DIM
    )

    axes = [bounds_lo[i] + vsize * np.arange(dims[i]) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    vox = torch.from_numpy(np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)).to(dev)
    trunc = float(np.float32(5 * vsize))

    with torch.no_grad():
        tsdf, weight = integrate(
            torch.ones(vox.shape[0], dtype=torch.float32, device=dev),
            torch.zeros(vox.shape[0], dtype=torch.float32, device=dev),
            vox,
            torch.from_numpy(np.stack(depths)).to(dev),
            torch.from_numpy(np.stack(Ks)).to(dev),
            torch.from_numpy(scene2cams[: len(depths)].astype(np.float32)).to(dev),
            trunc,
        )
    tsdf = tsdf.cpu().numpy().reshape(tuple(dims))
    weight = weight.cpu().numpy().reshape(tuple(dims))

    from lab4d_tpu_torch.meshlib.marching import marching_tets

    # TSDF = observed_depth - voxel_depth: positive in free space, negative
    # behind the surface — the same outside-positive convention the SDF
    # fields use, so it feeds marching_tets directly.
    mesh = marching_tets(
        tsdf,
        level=0.0,
        mask=weight > 0,
        spacing=(vsize, vsize, vsize),
    )
    mesh.vertices = mesh.vertices + bounds_lo

    center = (
        mesh.vertices.max(0) + mesh.vertices.min(0)
    ) / 2 if len(mesh.vertices) else np.zeros(3)
    mesh.vertices = mesh.vertices - center
    mesh.export(f"{cam_dir}/mesh-{component_id:02d}-centered.obj")

    # shift cameras into the mesh-centered scene frame
    cams = []
    for s2c in scene2cams:
        c2s = np.linalg.inv(s2c)
        c2s[:3, 3] -= center
        cams.append(np.linalg.inv(c2s))
    cams = np.stack(cams).astype(np.float32)
    np.save(f"{cam_dir}/{component_id:02d}.npy", cams)

    from lab4d_tpu_torch.utils.vis import draw_cams

    draw_cams(cams).export(f"{cam_dir}/cameras-{component_id:02d}-centered.obj")
    print(f"tsdf fusion done: {seqname}, {component_id}")
    return mesh


if __name__ == "__main__":
    tsdf_fusion(sys.argv[1], int(sys.argv[2]))
