"""Camera trajectory generators and render-batch construction.

Port of lab4d_tpu/utils/cam_traj.py; trajectories are numpy, batches are
tensors on the requested device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lab4d_tpu_torch.utils.geom import K2inv
from lab4d_tpu_torch.utils.quat import se3_to_quaternion_translation


def get_object_to_camera_matrix(theta, axis, distance) -> np.ndarray:
    """(4, 4) object-to-camera rotating `theta` degrees about `axis` at
    `distance`."""
    from scipy.spatial.transform import Rotation

    axis = np.asarray(axis, dtype=np.float64)
    rt = np.eye(4)
    rt[:3, :3] = Rotation.from_rotvec(np.deg2rad(theta) * axis / np.linalg.norm(axis)).as_matrix()
    rt[2, 3] = distance
    return rt


def get_rotating_cam(num_cameras, axis=(0, 1, 0), distance=3.0, initial_angle=0.0,
                     max_angle=360.0) -> np.ndarray:
    angles = np.linspace(initial_angle, max_angle, num_cameras)
    return np.stack([get_object_to_camera_matrix(a, axis, distance) for a in angles])


def get_fixed_cam(num_cameras, axis=(0, 1, 0), distance=3.0, angle=0.0) -> np.ndarray:
    """num_cameras copies of one view: the object turned `angle` degrees
    about `axis` around a point `distance` in front of the camera."""
    lshift, rshift = np.eye(4)[None], np.eye(4)[None]
    lshift[0, :3, 3] = [0, 0, distance]
    rshift[0, :3, 3] = [0, 0, -distance]
    return lshift @ get_rotating_cam(num_cameras, axis, 0.0, angle, angle) @ rshift


def get_orbit_camera(num_cameras, max_angle=5.0, cycles=2) -> np.ndarray:
    """(num_cameras, 4, 4) rotations wobbling up to `max_angle` degrees
    about x and y, `cycles` times around."""
    from scipy.spatial.transform import Rotation

    max_angle = np.deg2rad(max_angle)
    out = np.tile(np.eye(4)[None], (num_cameras, 1, 1))
    for i in range(num_cameras):
        phase = cycles * 2 * np.pi * i / num_cameras
        out[i, :3, :3] = Rotation.from_rotvec(
            [max_angle * np.cos(phase), max_angle * np.sin(phase), 0.0]).as_matrix()
    return out


def get_bev_cam(field2cam: np.ndarray, elev: float = 90.0) -> np.ndarray:
    """Bird's-eye trajectory relative to the view-space object."""
    ave_depth = field2cam[:, 2, 3].mean()
    center2cam = get_object_to_camera_matrix(0, [1, 0, 0], ave_depth)[None]
    center2bev = get_object_to_camera_matrix(elev, [1, 0, 0], 2 * ave_depth)[None]
    return center2bev @ np.linalg.inv(center2cam) @ field2cam


def create_field2cam(cam_traj: np.ndarray, keys) -> Dict[str, np.ndarray]:
    keys = list(keys)
    if "bg" in keys and "fg" in keys:
        raise NotImplementedError
    return {keys[0]: cam_traj}


def create_xy_grid(res: int) -> np.ndarray:
    x, y = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    return np.stack([x.reshape(-1), y.reshape(-1), np.ones(res * res)], -1).astype(np.float32)


def construct_batch(inst_id: int, frameid_sub, eval_res: int,
                    field2cam: Optional[Dict[str, np.ndarray]], camera_int, crop2raw,
                    device="cpu") -> Dict:
    """Render batch; field2cam values (N,4,4) are stored as (N,7)
    quaternion + translation."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    frameid_sub = torch.as_tensor(np.asarray(frameid_sub, dtype=np.int64), device=device)
    batch = {
        "frameid_sub": frameid_sub,
        "dataid": torch.full_like(frameid_sub, inst_id),
        "hxy": tensor(create_xy_grid(eval_res))[None].repeat(len(frameid_sub), 1, 1),
    }
    if crop2raw is not None:
        batch["crop2raw"] = tensor(crop2raw)
    if field2cam is not None:
        batch["field2cam"] = {
            k: se3_to_quaternion_translation(tensor(v), tuple_out=False)
            for k, v in field2cam.items()
        }
    if camera_int is not None:
        batch["Kinv"] = K2inv(tensor(camera_int))
    return batch
