"""Per-delta optical flow over a processed video: writes per-frame
FlowFW_d / FlowBW_d npys (float16) at the flow working resolution (port
of preprocess/scripts/compute_flow.py). The pairs (t, t + delta) go
through the flow backend in batches of PAIRS_PER_CALL."""

from __future__ import annotations

import glob
import os
import sys

import cv2
import numpy as np

PAIRS_PER_CALL = 16


def pick_flow_backend(device=None):
    """Flow backend selection (mirrors the seg/depth/feat backends):
    LAB4D_FLOW_BACKEND = auto (default) | raft | classical. `auto`
    takes the RAFT-lite net when its weights load. Returns the name and
    fn(imgs0, imgs1) -> (fw, bw) (B, res, res, 3) at the backend's
    working resolution."""
    choice = os.environ.get("LAB4D_FLOW_BACKEND", "auto")
    if choice != "classical":
        from lab4d_tpu_torch.preprocess.backends import flow_raft

        model = flow_raft.load_model(device=device)
        if model is not None:
            return "raft", lambda a, b: flow_raft.compute_flows(a, b, model=model,
                                                                device=device)
        if choice == "raft":
            raise FileNotFoundError(
                f"LAB4D_FLOW_BACKEND=raft but no usable weights at "
                f"{flow_raft.weights_path()}"
            )
    from lab4d_tpu_torch.preprocess.backends import flow_classical

    return "classical", lambda a, b: flow_classical.compute_flows(a, b, device=device)


def compute_flow(seqname: str, outdir: str, dframe: int, device=None):
    from lab4d_tpu_torch.preprocess import resolve_device

    device = resolve_device(device)
    backend, flows = pick_flow_backend(device)

    img_paths = sorted(
        glob.glob(f"{outdir}/JPEGImages/Full-Resolution/{seqname}/*.jpg")
    )
    fw_dir = f"{outdir}/FlowFW_{dframe}/Full-Resolution/{seqname}"
    bw_dir = f"{outdir}/FlowBW_{dframe}/Full-Resolution/{seqname}"
    os.makedirs(fw_dir, exist_ok=True)
    os.makedirs(bw_dir, exist_ok=True)

    def load(i):
        return cv2.imread(img_paths[i])[..., ::-1]

    n_pairs = max(len(img_paths) - dframe, 0)
    for start in range(0, n_pairs, PAIRS_PER_CALL):
        idx = range(start, min(start + PAIRS_PER_CALL, n_pairs))
        frames = {i: load(i) for i in sorted(set(idx) | {i + dframe for i in idx})}
        fws, bws = flows([frames[i] for i in idx], [frames[i + dframe] for i in idx])
        for i, fw, bw in zip(idx, fws, bws):
            name_i = os.path.basename(img_paths[i]).replace(".jpg", ".npy")
            name_j = os.path.basename(img_paths[i + dframe]).replace(".jpg", ".npy")
            np.save(f"{fw_dir}/{name_i}", fw.astype(np.float16))
            np.save(f"{bw_dir}/{name_j}", bw.astype(np.float16))
    print(f"flow (delta={dframe}, backend={backend}) done: {seqname}")
    return backend


if __name__ == "__main__":
    compute_flow(sys.argv[1], sys.argv[2], int(sys.argv[3]))
