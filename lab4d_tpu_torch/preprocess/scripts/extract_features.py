"""Feature-map extraction for a whole collection with a shared PCA basis:
Features/<seq>/{crop,full}-<S>-dinov2-01.npy (port of
preprocess/scripts/extract_features.py; the filename keeps the
reference's "dinov2" tag for loader compatibility regardless of
backend)."""

from __future__ import annotations

import os
import sys

import numpy as np

from lab4d_tpu_torch.preprocess.backends import pick_backend
from lab4d_tpu_torch.preprocess.backends.feat_backends import extract_features_collection
from lab4d_tpu_torch.preprocess.libs.io import config_seqnames, frame_list


def extract_features(
    collection_name: str,
    crop_size: int = 256,
    component_id: int = 1,
    database_root: str = "database",
    device=None,
):
    from lab4d_tpu_torch.preprocess.backends.feat_net import probe_feat_net

    from lab4d_tpu_torch.preprocess.backends.feat_backends import probe_dinov2

    outdir = f"{database_root}/processed"
    # hub-cached dinov2 > the trained descriptor net (its weights exist) > the filter bank
    fallback = pick_backend("LAB4D_FEAT_BACKEND", "net", "filterbank", probe_feat_net)
    backend = pick_backend("LAB4D_FEAT_BACKEND", "dinov2", fallback, probe_dinov2)

    seqnames = config_seqnames(collection_name, database_root)
    seq_frames = [frame_list(outdir, s) for s in seqnames]
    for use_full, prefix in ((False, "crop"), (True, "full")):
        feats = extract_features_collection(
            seq_frames, crop_size, use_full, component_id, backend=backend, device=device
        )
        for seqname, f in zip(seqnames, feats):
            feat_dir = f"{outdir}/Features/Full-Resolution/{seqname}"
            os.makedirs(feat_dir, exist_ok=True)
            np.save(
                f"{feat_dir}/{prefix}-{crop_size}-dinov2-{component_id:02d}.npy", f
            )
    print(f"features ({backend}) done: {collection_name}")
    return backend


if __name__ == "__main__":
    extract_features(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 256)
