"""Monocular depth U-Net (port of preprocess/backends/depth_unet.py).

  stride-2 conv encoder (4 stages) -> decoder with skip connections ->
  softplus metric depth at input resolution.

Weights load from the local cache only (``database/weights/
depth_unet.msgpack`` or ``$LAB4D_WEIGHTS_DIR/depth_unet.msgpack``);
without them the depth stage runs the motion-parallax proxy
(depth_backends.py). Frames do not depend on each other, so they go
through the net in batches.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.layers import UNet, load_net, to_nchw

WEIGHTS_NAME = "depth_unet.msgpack"
RES = 256  # native working resolution
BATCH = 16  # frames per call of the net


class DepthUNet(UNet):
    """rgb (B, 3, H, W) in [0,1] -> metric depth (B, H, W)."""

    # the output bias starts at the scene scale (~3), as flax's bias_init
    # in preprocess/backends/depth_unet.py does
    BIAS_INIT = {"Conv_14.bias": 3.0}

    def __init__(self):
        super().__init__(3)

    def forward(self, x):
        return F.softplus(super().forward(x))


def weights_path() -> str:
    from lab4d_tpu_torch.preprocess.backends.weights import resolve_weights

    return resolve_weights(WEIGHTS_NAME)


def load_model(path: Optional[str] = None, device="cpu") -> Optional[DepthUNet]:
    """The net with the cached weights on `device`, or None when absent/corrupt."""
    return load_net(DepthUNet, path or weights_path(), "depth_unet", "classical fallback",
                    device)


def available() -> bool:
    return load_model() is not None


def depth_video_unet(frames: List[np.ndarray], model: Optional[DepthUNet] = None,
                     res: int = RES, device=None) -> List[np.ndarray]:
    """Per-frame metric depth at the original frame resolution."""
    import cv2

    dev = resolve_device(device)
    model = model if model is not None else load_model(device=dev)
    if model is None:
        raise FileNotFoundError(f"depth_unet weights missing or unusable: {weights_path()}")
    out = []
    for i in range(0, len(frames), BATCH):
        chunk = frames[i:i + BATCH]
        x = to_nchw(np.stack([cv2.resize(f, (res, res)) for f in chunk]) / np.float32(255.0),
                    dev)
        with torch.no_grad():
            depth = model(x).cpu().numpy()
        for f, d in zip(chunk, depth):
            h, w = f.shape[:2]
            out.append(cv2.resize(d, (w, h), interpolation=cv2.INTER_LINEAR).astype(np.float32))
    return out
