"""Motion-based frame filtering: drop near-static frames (port of
preprocess/scripts/frame_filter.py).

Walks raw frames in order, estimates flow from the last kept frame to the
candidate with the classical flow on the device at low resolution, and
keeps the candidate only when the median flow magnitude (normalized by
image size) exceeds a threshold. Caps the kept count (reference:
preprocess/third_party/vcnplus/frame_filter.py: threshold 0.05, cap 500).
Each candidate depends on the last kept frame, so the pairs go one at a
time.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys

import cv2
import numpy as np

FLOW_THRESHOLD = 0.05
MAX_FRAMES = 500
FILTER_RES = 160  # low-res flow is plenty for a motion statistic


def frame_filter(seqname: str, outdir: str, device=None):
    from lab4d_tpu_torch.preprocess.backends.flow_classical import compute_pair_flow

    in_paths = sorted(
        glob.glob(f"{outdir}/JPEGImagesRaw/Full-Resolution/{seqname}/*.jpg")
    )
    out_dir = f"{outdir}/JPEGImages/Full-Resolution/{seqname}"
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)

    if not in_paths:
        return []

    kept = [0]
    last_img = cv2.imread(in_paths[0])[..., ::-1]
    for idx in range(1, len(in_paths)):
        if len(kept) >= MAX_FRAMES:
            break
        cand = cv2.imread(in_paths[idx])[..., ::-1]
        fw, _ = compute_pair_flow(last_img, cand, res=FILTER_RES, device=device)
        med = np.median(np.linalg.norm(fw[..., :2], axis=-1)) / FILTER_RES
        if med > FLOW_THRESHOLD:
            kept.append(idx)
            last_img = cand

    for new_id, src_id in enumerate(kept):
        shutil.copy(in_paths[src_id], f"{out_dir}/{new_id:05d}.jpg")
    print(f"frame filter: kept {len(kept)}/{len(in_paths)} frames for {seqname}")
    return kept


if __name__ == "__main__":
    frame_filter(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "database/processed")
