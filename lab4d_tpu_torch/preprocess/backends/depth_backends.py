"""Monocular depth backends (port of preprocess/backends/depth_backends.py).

  unet      — the monocular depth U-Net (depth_unet.py) when its weights,
              which ship in database/weights/, load
  flowdisp  — classical fallback: motion-parallax proxy depth. For a
              (predominantly translating) camera, apparent pixel speed
              is inversely proportional to depth; we take the
              cycle-verified flow magnitude relative to the dominant
              affine (camera) motion, invert it, and normalize the
              median scene depth to ~3 units, with temporal smoothing.
  const     — constant depth (3.0) everywhere

(The JAX package's ZoeDepth backend, which needs torch.hub weights, is
not part of the port.) Output contract: Depth/<seq>/%05d.npy float16.
"""

from __future__ import annotations

import glob
import os
from typing import List

import cv2
import numpy as np

MEDIAN_DEPTH = 3.0
EPS = 1e-3


def depth_video_flowdisp(frames: List[np.ndarray], res: int = 288,
                         device=None) -> List[np.ndarray]:
    """Parallax-proxy depth: residual flow speed -> inverse depth."""
    from lab4d_tpu_torch.preprocess.backends.flow_classical import compute_pair_flow
    from lab4d_tpu_torch.preprocess.backends.seg_backends import _dominant_affine_residual

    n = len(frames)
    inv_depths = []
    for i in range(n):
        j = i + 1 if i + 1 < n else i - 1
        fw, _ = compute_pair_flow(frames[min(i, j)], frames[max(i, j)], res=res,
                                 device=device)
        speed = np.linalg.norm(fw[..., :2], axis=-1)
        # remove the global-motion floor so static far regions read as far
        resid = _dominant_affine_residual(fw)
        inv = (0.5 * speed + 0.5 * resid) / res
        inv = cv2.GaussianBlur(inv, (0, 0), 5)
        inv_depths.append(inv)
    # temporal smoothing of inverse depth
    smoothed = []
    for i in range(n):
        lo, hi = max(0, i - 1), min(n, i + 2)
        smoothed.append(np.mean(inv_depths[lo:hi], axis=0))
    out = []
    for inv in smoothed:
        scale = np.median(inv) + EPS
        depth = MEDIAN_DEPTH * scale / (inv + EPS)
        out.append(np.clip(depth, 0.1, 20.0).astype(np.float32))
    return out


def depth_video_const(frames: List[np.ndarray]) -> List[np.ndarray]:
    return [np.full(f.shape[:2], MEDIAN_DEPTH, np.float32) for f in frames]


def pick_depth_backend() -> str:
    """Explicit env override, else unet when its weights load, else flowdisp."""
    choice = os.environ.get("LAB4D_DEPTH_BACKEND", "auto")
    if choice != "auto":
        return choice
    from lab4d_tpu_torch.preprocess.backends import depth_unet

    return "unet" if depth_unet.available() else "flowdisp"


def extract_depth(seqname: str, outdir: str = "database/processed", device=None):
    backend = pick_depth_backend()
    img_paths = sorted(
        glob.glob(f"{outdir}/JPEGImages/Full-Resolution/{seqname}/*.jpg")
    )
    out_dir = f"{outdir}/Depth/Full-Resolution/{seqname}"
    os.makedirs(out_dir, exist_ok=True)
    frames = [cv2.imread(p)[..., ::-1] for p in img_paths]
    if backend == "unet":
        from lab4d_tpu_torch.preprocess.backends.depth_unet import depth_video_unet

        depths = depth_video_unet(frames, device=device)
    elif backend == "const":
        depths = depth_video_const(frames)
    elif backend == "flowdisp":
        depths = depth_video_flowdisp(frames, device=device)
    else:
        raise ValueError(f"LAB4D_DEPTH_BACKEND={backend!r}: not one of unet, flowdisp, const")
    for p, d in zip(img_paths, depths):
        np.save(
            f"{out_dir}/{os.path.basename(p).replace('.jpg', '.npy')}",
            d.astype(np.float16),
        )
    print(f"depth ({backend}) done: {seqname}")
    return backend
