"""Canonical-viewpoint CNN (port of preprocess/backends/viewpoint_net.py).

A small conv net maps a masked, bbox-cropped RGB image to the rotation
taking the object's canonical frame to the camera frame, predicted in
the continuous 6D rotation parameterisation (Zhou et al., CVPR 2019 —
two free columns, Gram-Schmidt).

Weights load from the local cache only:
``database/weights/viewpoint_{cls}.msgpack`` (fallback
``viewpoint_net.msgpack``) under ``database/weights`` or
``$LAB4D_WEIGHTS_DIR``; without them canonical registration fits the
camera chain alone.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.layers import Conv, load_net, to_nchw

RES = 96  # crop resolution fed to the net


class ViewpointNet(nn.Module):
    """Masked rgb crops (B, 3, RES, RES) in [0,1] -> rotations (B, 3, 3)."""

    def __init__(self):
        super().__init__()
        prev = 3
        for i, ch in enumerate((32, 64, 96, 128)):
            setattr(self, f"Conv_{2 * i}", Conv(prev, ch, stride=2))
            setattr(self, f"Conv_{2 * i + 1}", Conv(ch, ch))
            prev = ch
        self.Dense_0 = nn.Linear(128, 128)
        self.Dense_1 = nn.Linear(128, 6)

    def forward(self, x):
        for i in range(8):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = x.mean(dim=(2, 3))  # global average pool
        x = F.relu(self.Dense_0(x))
        return rot6d_to_matrix(self.Dense_1(x))


def rot6d_to_matrix(sixd: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt two columns -> SO(3) (Zhou et al. 6D rep)."""
    a1, a2 = sixd[..., :3], sixd[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), min=1e-6)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.vector_norm(a2p, dim=-1, keepdim=True), min=1e-6)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def weights_path(obj_class: str = "") -> str:
    from lab4d_tpu_torch.preprocess.backends.weights import resolve_weights

    if obj_class:
        p = resolve_weights(f"viewpoint_{obj_class}.msgpack")
        if os.path.exists(p):
            return p
    return resolve_weights("viewpoint_net.msgpack")


def load_model(obj_class: str = "", path: Optional[str] = None,
               device="cpu") -> Optional[ViewpointNet]:
    """The net with the cached weights on `device`, or None when absent/corrupt."""
    return load_net(ViewpointNet, path or weights_path(obj_class), "viewpoint",
                    "chain-only prior", device)


def available(obj_class: str = "") -> bool:
    return load_model(obj_class) is not None


def crop_masked(rgb_u8: np.ndarray, mask: np.ndarray) -> Optional[np.ndarray]:
    """Mask-centered square crop resized to RES, background zeroed."""
    import cv2

    ys, xs = np.nonzero(mask > 0)
    if len(ys) == 0:
        return None
    cy, cx = ys.mean(), xs.mean()
    half = max(np.ptp(ys), np.ptp(xs)) * 0.7 + 8
    h, w = mask.shape
    y0, y1 = int(max(0, cy - half)), int(min(h, cy + half))
    x0, x1 = int(max(0, cx - half)), int(min(w, cx + half))
    crop = rgb_u8[y0:y1, x0:x1] * (mask[y0:y1, x0:x1, None] > 0)
    return cv2.resize(crop, (RES, RES)).astype(np.float32) / 255.0


def predict_viewpoints(img_paths: List[str], obj_class: str = "", every: int = 4,
                       model: Optional[ViewpointNet] = None, device=None) -> dict:
    """Sparse {frame_idx: 3x3 rotation} priors for canonical registration
    (same contract as the reference's CSE viewpoint head outputs); the
    crops go through the net in one batch."""
    import cv2

    dev = resolve_device(device)
    model = model if model is not None else load_model(obj_class, device=dev)
    if model is None:
        raise FileNotFoundError(f"viewpoint weights missing or unusable: "
                                f"{weights_path(obj_class)}")
    idx, crops = [], []
    for i in range(0, len(img_paths), every):
        p = img_paths[i]
        mpath = p.replace("JPEGImages", "Annotations").replace(".jpg", ".npy")
        if not os.path.exists(mpath):
            continue
        crop = crop_masked(cv2.imread(p)[..., ::-1], np.load(mpath))
        if crop is None:
            continue
        idx.append(i)
        crops.append(crop)
    if not crops:
        return {}
    with torch.no_grad():
        rots = model(to_nchw(np.stack(crops), dev)).cpu().numpy()
    return dict(zip(idx, rots))
