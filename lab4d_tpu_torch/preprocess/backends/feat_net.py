"""Learned pixel-descriptor net (port of preprocess/backends/feat_net.py):
a small conv U-Net producing dense 24-dim L2-normalised descriptor maps,
trained self-supervised on synthetic multi-view correspondences. The
collection-level masked PCA to 16 dims (feat_backends.py) applies to its
raw maps.

Weights resolve via weights.resolve_weights("feat_net.msgpack"); without
them the feature stage runs the filter bank.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.layers import Conv, load_net, resize_bilinear, to_nchw

FEAT_RES = 112
OUT_DIM = 24
WEIGHTS_NAME = "feat_net.msgpack"
BATCH = 32  # frames per call of the net


class FeatNet(nn.Module):
    """(B, 3, H, W) in [0,1] -> (B, OUT_DIM, H, W) L2-normalised descriptors."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 32)
        self.Conv_1 = Conv(32, 32)
        self.Conv_2 = Conv(32, 48, stride=2)
        self.Conv_3 = Conv(48, 48)
        self.Conv_4 = Conv(48, 64, stride=2)
        self.Conv_5 = Conv(64, 64)
        # dilated context at 1/4 res widens receptive field cheaply
        self.Conv_6 = Conv(64, 64, dilation=2)
        self.Conv_7 = Conv(64, 64, dilation=4)
        self.Conv_8 = Conv(64 + 48, 48)
        self.Conv_9 = Conv(48 + 32, 32)
        self.Conv_10 = Conv(32, OUT_DIM, 1)

    def forward(self, x):
        e0 = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        e1 = F.relu(self.Conv_3(F.relu(self.Conv_2(e0))))
        e2 = F.relu(self.Conv_5(F.relu(self.Conv_4(e1))))
        e2 = F.relu(self.Conv_7(F.relu(self.Conv_6(e2))))
        u1 = resize_bilinear(e2, e1.shape[-2:])
        u1 = F.relu(self.Conv_8(torch.cat([u1, e1], 1)))
        u0 = resize_bilinear(u1, x.shape[-2:])
        u0 = F.relu(self.Conv_9(torch.cat([u0, e0], 1)))
        out = self.Conv_10(u0)
        return out / torch.clamp(torch.linalg.vector_norm(out, dim=1, keepdim=True), min=1e-6)


def weights_path() -> str:
    from lab4d_tpu_torch.preprocess.backends.weights import resolve_weights

    return resolve_weights(WEIGHTS_NAME)


def load_model(path: Optional[str] = None, device="cpu") -> Optional[FeatNet]:
    """The net with the cached weights on `device`, or None when absent/corrupt."""
    return load_net(FeatNet, path or weights_path(), "feat_net", "filterbank fallback", device)


def probe_feat_net() -> bool:
    """The weights exist and load (a corrupt file means the filter bank)."""
    return load_model() is not None


def frames_features_net(rgbs_u8: List[np.ndarray], model: Optional[FeatNet] = None,
                        device=None) -> torch.Tensor:
    """(H, W, 3) uint8 frames -> (N, OUT_DIM, FEAT_RES, FEAT_RES) float32
    on the device."""
    import cv2

    dev = resolve_device(device)
    model = model if model is not None else load_model(device=dev)
    if model is None:
        raise FileNotFoundError(f"feat_net weights missing or unusable: {weights_path()}")
    out = []
    for i in range(0, len(rgbs_u8), BATCH):
        x = np.stack([cv2.resize(f, (FEAT_RES, FEAT_RES)) for f in rgbs_u8[i:i + BATCH]])
        with torch.no_grad():
            out.append(model(to_nchw(x / np.float32(255.0), dev)))
    return torch.cat(out)
