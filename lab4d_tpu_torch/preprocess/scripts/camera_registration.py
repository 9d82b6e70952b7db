"""Chained per-pair camera registration: depth + flow -> scene-to-camera
trajectory Cameras/<seq>/<component>.npy (port of
preprocess/scripts/camera_registration.py; Procrustes on the host).

component 0 = background (full frames, flow-confidence-gated pixels),
component 1 = foreground object (largest mask component).
"""

from __future__ import annotations

import os
import sys

import cv2
import numpy as np

from lab4d_tpu_torch.preprocess.libs.geometry import register_pair
from lab4d_tpu_torch.preprocess.libs.io import (
    K2inv_np,
    K2mat_np,
    default_intrinsics,
    frame_list,
    largest_component,
    load_frame_pack,
    process_flow_pair,
)


def camera_registration(
    seqname: str,
    component_id: int,
    outdir: str = "database/processed",
    crop_size: int = 256,
    registration_type: str = "procrustes",
):
    img_paths = frame_list(outdir, seqname)
    Kraw = K2mat_np(default_intrinsics(cv2.imread(img_paths[0]).shape))

    cam = np.eye(4)
    cams = [cam]
    for t in range(len(img_paths) - 1):
        p0 = load_frame_pack(img_paths[t], 1, crop_size, use_full=True)
        p1 = load_frame_pack(img_paths[t + 1], -1, crop_size, use_full=True)
        process_flow_pair(p0, p1)

        K0 = K2inv_np(p0.crop2raw) @ Kraw
        K1 = K2inv_np(p1.crop2raw) @ Kraw

        valid = p0.mask[..., 0].astype(int) == component_id
        if component_id > 0:
            valid = largest_component(valid)
        else:
            valid = valid & (np.asarray(p0.flow[..., 2], np.float32) > 0)

        rel = register_pair(
            p0.depth.astype(np.float32),
            p1.depth.astype(np.float32),
            np.asarray(p0.flow, np.float32),
            K0,
            K1,
            valid,
            registration_type,
        )
        cam = rel @ cam
        cams.append(cam)

    cams = np.stack(cams, 0).astype(np.float32)
    save_dir = f"{outdir}/Cameras/Full-Resolution/{seqname}"
    os.makedirs(save_dir, exist_ok=True)
    np.save(f"{save_dir}/{component_id:02d}.npy", cams)

    from lab4d_tpu_torch.utils.vis import draw_cams

    draw_cams(cams).export(f"{save_dir}/cameras-{component_id:02d}.obj")
    print(f"camera registration done: {seqname}, {component_id}")
    return cams


if __name__ == "__main__":
    camera_registration(sys.argv[1], int(sys.argv[2]))
