"""Video segmentation U-Net (port of preprocess/backends/seg_unet.py).

  input  (B, 4, H, W): rgb in [0,1] + a previous-mask conditioning channel
                       (0.5 = unknown; the first frame bootstraps from
                       appearance/shading alone)
  output (B, H, W):    foreground probability

At inference the previous frame's probability is fed forward, so the net
tracks the object instead of re-deciding per frame: the frames go through
the net one at a time, in order. Weights load from the local cache only
(``database/weights/seg_unet.msgpack`` or
``$LAB4D_WEIGHTS_DIR/seg_unet.msgpack``); without them the segmentation
stage runs motion-seeded GrabCut (seg_backends.py).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.layers import UNet, load_net, to_nchw

WEIGHTS_NAME = "seg_unet.msgpack"
RES = 256  # native working resolution


class SegUNet(UNet):
    """x (B, 4, H, W) = [rgb, prev_mask] -> fg probability (B, H, W)."""

    def __init__(self):
        super().__init__(4)

    def forward(self, x):
        return torch.sigmoid(super().forward(x))


def weights_path() -> str:
    from lab4d_tpu_torch.preprocess.backends.weights import resolve_weights

    return resolve_weights(WEIGHTS_NAME)


def load_model(path: Optional[str] = None, device="cpu") -> Optional[SegUNet]:
    """The net with the cached weights on `device`, or None when absent/corrupt."""
    return load_net(SegUNet, path or weights_path(), "seg_unet", "grabcut fallback", device)


def available() -> bool:
    return load_model() is not None


def segment_probs(frames: List[np.ndarray], model: Optional[SegUNet] = None, res: int = RES,
                  device=None) -> Iterator[np.ndarray]:
    """Per-frame (res, res) foreground probabilities, each frame
    conditioned on the previous frame's (0.5 on the first)."""
    import cv2

    dev = resolve_device(device)
    model = model if model is not None else load_model(device=dev)
    if model is None:
        raise FileNotFoundError(f"seg_unet weights missing or unusable: {weights_path()}")
    prev = torch.full((1, 1, res, res), 0.5, dtype=torch.float32, device=dev)
    for f in frames:
        rgb = to_nchw(cv2.resize(f, (res, res))[None] / np.float32(255.0), dev)
        with torch.no_grad():
            prob = model(torch.cat([rgb, prev], 1))
        prev = prob[:, None]
        yield prob[0].cpu().numpy()


def segment_video_unet(frames: List[np.ndarray], model: Optional[SegUNet] = None,
                       res: int = RES, device=None) -> List[np.ndarray]:
    """Per-frame int8 fg masks at each frame's raw resolution: the
    probability above 0.5, its largest component kept."""
    import cv2

    out = []
    for f, prob in zip(frames, segment_probs(frames, model, res, device)):
        h, w = f.shape[:2]
        mask = (prob > 0.5).astype(np.uint8)
        # keep the largest component for stability (matches grabcut path)
        if mask.any():
            num, labels = cv2.connectedComponents(mask)
            if num > 2:
                counts = np.bincount(labels.ravel())
                counts[0] = 0
                mask = (labels == counts.argmax()).astype(np.uint8)
        full = cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)
        out.append(full.astype(np.int8))
    return out
