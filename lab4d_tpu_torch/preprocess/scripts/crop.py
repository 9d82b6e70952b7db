"""Crop/packing stage, on the host (port of preprocess/scripts/crop.py):
resample every frame (and every frame-pair flow) into mask-centered crops
and pack per-video npy tensors — the exact buffers the training
dataloader mmaps.

For each delta in {1,2,4,8} and each pair (t, t+delta) with t % delta == 0:
  FlowFW_d/<seq>/{crop,full}-S.npy   (P,S,S,3) [u, v, cycle-uncertainty]
  FlowBW_d/<seq>/{crop,full}-S.npy
Per frame (from the delta=1 sweep, plus the trailing frame):
  JPEGImages/<seq>/{crop,full}-S.npy   (N,S,S,3) float16
  Annotations/<seq>/{crop,full}-S.npy  (N,S,S,2) bool [mask, vis2d]
  Annotations/<seq>/...-crop2raw.npy   (N,4), ...-is_detected.npy (N,)
  Depth/<seq>/{crop,full}-S.npy        (N,S,S) float16
"""

from __future__ import annotations

import os
import sys

import numpy as np


from lab4d_tpu_torch.preprocess.libs.io import frame_list, load_frame_pack, process_flow_pair

DELTAS = (1, 2, 4, 8)


def extract_crop(
    seqname: str,
    crop_size: int,
    use_full: int,
    outdir: str = "database/processed",
):
    prefix = ("full" if use_full else "crop") + f"-{crop_size}"
    img_paths = frame_list(outdir, seqname)
    n = len(img_paths)

    flow_fw = {d: [] for d in DELTAS}
    flow_bw = {d: [] for d in DELTAS}
    per_frame = {"rgb": [], "mask": [], "depth": [], "crop2raw": [], "det": []}

    for t in range(n):
        for delta in DELTAS:
            if t % delta != 0 or t + delta >= n:
                continue
            p0 = load_frame_pack(img_paths[t], delta, crop_size, bool(use_full))
            p1 = load_frame_pack(img_paths[t + delta], -delta, crop_size, bool(use_full))
            process_flow_pair(p0, p1)
            flow_fw[delta].append(p0.flow)
            flow_bw[delta].append(p1.flow)
            if delta == 1:
                for pack, last in ((p0, False), (p1, t == n - 2)):
                    if pack is p1 and not last:
                        continue
                    per_frame["rgb"].append(pack.img)
                    per_frame["mask"].append(pack.mask)
                    per_frame["depth"].append(pack.depth)
                    per_frame["crop2raw"].append(pack.crop2raw)
                    per_frame["det"].append(pack.is_detected)

    def save(sub, name, arrs):
        path = f"{outdir}/{sub}/Full-Resolution/{seqname}"
        os.makedirs(path, exist_ok=True)
        np.save(f"{path}/{name}.npy", np.stack(arrs, 0))

    for d in DELTAS:
        if flow_fw[d]:
            save(f"FlowFW_{d}", prefix, flow_fw[d])
            save(f"FlowBW_{d}", prefix, flow_bw[d])
    save("JPEGImages", prefix, per_frame["rgb"])
    save("Annotations", prefix, per_frame["mask"])
    save("Depth", prefix, per_frame["depth"])
    save("Annotations", f"{prefix}-crop2raw",
         [np.asarray(c, np.float32) for c in per_frame["crop2raw"]])
    save("Annotations", f"{prefix}-is_detected",
         [np.float32(d) for d in per_frame["det"]])
    print(f"crop (size={crop_size}, full={use_full}) done: {seqname}")


if __name__ == "__main__":
    extract_crop(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
