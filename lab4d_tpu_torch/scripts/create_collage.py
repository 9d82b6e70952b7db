"""Tile the rendered videos of several runs or sequences into one grid
video: the port of scripts/create_collage.py (clips read through PIL and
OpenCV, not imageio).

    python -m lab4d_tpu_torch.scripts.create_collage <glob-of-mp4s-or-png-dirs> <out.mp4> [cols]
"""

from __future__ import annotations

import glob
import math
import os
import sys

import numpy as np


def _load_clip(path, max_frames=150):
    """A directory's pngs in name order, or a video's frames (RGB); None
    when nothing is readable."""
    if os.path.isdir(path):
        from PIL import Image

        frames = [np.asarray(Image.open(p)) for p in sorted(glob.glob(f"{path}/*.png"))[:max_frames]]
        return np.stack(frames) if frames else None
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < max_frames:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return np.stack(frames) if frames else None


def collage_frames(clips, cols: int = 0, res: int = 256) -> np.ndarray:
    """(T, rows * res, cols * res, 3) uint8: each clip resized to res x res
    in a grid of `cols` columns (a square grid by default), shorter clips
    holding their last frame, empty cells black."""
    import cv2

    n = len(clips)
    cols = cols or int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    length = max(len(c) for c in clips)
    grid_frames = []
    for t in range(length):
        tiles = []
        for c in clips:
            f = c[min(t, len(c) - 1)]
            if f.ndim == 2:
                f = np.repeat(f[..., None], 3, -1)
            tiles.append(cv2.resize(f[..., :3], (res, res)))
        while len(tiles) < rows * cols:
            tiles.append(np.zeros((res, res, 3), np.uint8))
        rows_img = [np.concatenate(tiles[r * cols:(r + 1) * cols], 1) for r in range(rows)]
        grid_frames.append(np.concatenate(rows_img, 0))
    return np.stack(grid_frames)


def create_collage(pattern: str, out_path: str, cols: int = 0, res: int = 256):
    from lab4d_tpu_torch.utils.io import save_video

    paths = sorted(glob.glob(pattern))
    clips = [c for c in (_load_clip(p) for p in paths) if c is not None]
    if not clips:
        print(f"no clips matched {pattern}")
        return None
    n = len(clips)
    cols = cols or int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    save_video(collage_frames(clips, cols, res), out_path)
    print(f"collage ({n} clips, {rows}x{cols}) -> {out_path}")
    return out_path


if __name__ == "__main__":
    create_collage(sys.argv[1], sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 0)
