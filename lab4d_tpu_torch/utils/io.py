"""IO helpers: save dirs, video export. The port's copy of
lab4d_tpu/utils/io.py."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def make_save_dir(opts, sub_dir: str) -> str:
    save_dir = os.path.join(
        opts["logroot"], "%s-%s" % (opts["seqname"], opts["logname"]), sub_dir
    )
    os.makedirs(save_dir, exist_ok=True)
    return save_dir


def imwrite(path: str, image: np.ndarray):
    """One uint8 image (H, W) or (H, W, C) to a file whose format its
    extension names, through PIL at PIL's defaults: byte for byte what
    imageio.imwrite writes (a JPEG at quality 75, a PNG at zlib level 6)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(image)).save(path)


def save_video(frames: np.ndarray, path: str, fps: int = 10):
    """(T, H, W[, 3]) float [0,1] or uint8 -> an mp4 (OpenCV's MPEG-4
    writer); where OpenCV has no video backend, one png per frame,
    "<path without .mp4>-%05d.png", as the JAX package falls back."""
    import cv2

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    if frames.ndim == 3:
        frames = np.repeat(frames[..., None], 3, -1)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if writer.isOpened():
        try:
            for f in frames:
                writer.write(np.ascontiguousarray(f[..., 2::-1]))
        finally:
            writer.release()
        return
    base = path.rsplit(".", 1)[0]
    for i, f in enumerate(frames):
        imwrite(f"{base}-{i:05d}.png", f)


def save_rendered(
    rendered: Dict[str, np.ndarray], save_dir: str, raw_size, pca_fn=None,
    fps: int = 10,
):
    """Write one mp4 per rendered key (io.py:73-98)."""
    from lab4d_tpu_torch.utils.vis import img2color

    for k, frames in rendered.items():
        frames = np.asarray(frames)
        if frames.ndim < 4:
            continue
        vids = np.stack(
            [img2color(k, f, pca_fn=pca_fn) for f in frames]
        )
        save_video(vids, os.path.join(save_dir, f"{k}.mp4"), fps=fps)
