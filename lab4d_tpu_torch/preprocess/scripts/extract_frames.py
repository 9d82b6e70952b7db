"""Dump video frames to JPEGs, skipping leading black frames (port of
preprocess/scripts/extract_frames.py, which reads with imageio).

Image containers that PIL opens (GIF, APNG, multi-page TIFF) are read
frame by frame with PIL, as imageio's pillow plugin reads them; videos
with OpenCV. The JPEGs are written with PIL at its default quality (75),
byte for byte what imageio.imwrite writes.
"""

import os
import sys
from typing import Iterator

import numpy as np


def read_frames(in_path: str) -> Iterator[np.ndarray]:
    """(H, W, 3) uint8 RGB frames of a video or an animated image."""
    from PIL import Image, ImageSequence, UnidentifiedImageError

    try:
        image = Image.open(in_path)
    except UnidentifiedImageError:
        image = None
    if image is not None:
        with image:
            for frame in ImageSequence.Iterator(image):
                yield np.asarray(frame.convert("RGB"))
        return
    import cv2

    cap = cv2.VideoCapture(in_path)
    if not cap.isOpened():
        raise IOError(f"cannot read video {in_path}")
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            yield np.ascontiguousarray(bgr[..., ::-1])
    finally:
        cap.release()


def extract_frames(in_path: str, out_path: str):
    from PIL import Image

    print("extracting frames:", in_path)
    os.makedirs(out_path, exist_ok=True)
    count = 0
    started = False
    for im in read_frames(in_path):
        if not started:
            if not np.any(im > 0):
                continue  # leading black frame
            started = True
        Image.fromarray(im).save("%s/%05d.jpg" % (out_path, count), "JPEG")
        count += 1
    return count


if __name__ == "__main__":
    extract_frames(sys.argv[1], sys.argv[2])
