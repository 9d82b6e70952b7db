"""The geometry state a step and a frame read (aabb, per-frame near-far,
proxy corners), worked out from the model's cameras and the initial proxy
sphere, as the program's trainer sets it up before its first round."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.lab4d_ref.utils.geom import get_near_far
from benchmark.reference.lab4d_ref.utils.quat import quaternion_translation_to_se3
from benchmark.scene import uv_sphere

PROXY_RADIUS, PROXY_COUNT = 0.12, (4, 4)  # an articulated or deformed fg's first proxy


def proxy_sphere():
    """(vertices, (2, 3) bounds, (8, 3) box corners) of the first proxy."""
    verts, _ = uv_sphere(PROXY_RADIUS, PROXY_COUNT)
    bounds = np.stack([verts.min(0), verts.max(0)], 0)
    idx = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    corners = np.stack([bounds[idx[:, d], d] for d in range(3)], axis=-1)
    return verts, bounds, corners


def geo_state(model, frame_info, cate: str = "fg"):
    """{cate: {"aabb", "near_far", "corners"}} for the model's cameras."""
    verts, bounds, corners = proxy_sphere()
    with torch.no_grad():
        quat, trans = model.fields.field_params[cate].camera_mlp.get_vals()
        rtmat = quaternion_translation_to_se3(quat, trans)
        near_far_frames = get_near_far(torch.as_tensor(np.asarray(verts, np.float32),
                                                       device=rtmat.device), rtmat)
    near_far = np.tile(np.array([0.01, 10.0], np.float32), (frame_info.num_frames_raw, 1))
    near_far[frame_info.frame_mapping] = near_far_frames.cpu().numpy()
    return {cate: {"aabb": bounds.astype(np.float32), "near_far": near_far.astype(np.float32),
                   "corners": corners.astype(np.float32)}}


def geo_tensors(geo, device):
    """A step's batch["geo"]: the geometry state as device tensors."""
    return {cate: {"aabb": torch.as_tensor(g["aabb"], device=device),
                   "near_far_table": torch.as_tensor(g["near_far"], device=device),
                   "proxy_corners": torch.as_tensor(g["corners"], device=device)}
            for cate, g in geo.items()}
