"""Offline preprocessing pipeline of the port: raw videos ->
database/processed/** priors, the same artifacts as the JAX package's
preprocess/ + scripts/run_preprocess.py with its default `auto` backends.

  frames -> filter -> segmentation -> flow -> depth -> crop/pack
         -> camera registration -> TSDF fusion -> canonical registration
         -> feature extraction

The five nets whose weights ship in database/weights/ (RAFT-lite flow,
depth and segmentation U-Nets, the descriptor net, the viewpoint net) and
the dense programs (Lucas-Kanade flow, TSDF integration, the canonical
rotation fit, the filter bank) run on the card; decoding, cropping and
the Procrustes registration stay on the host, as in the JAX package.
Entry point: `python -m lab4d_tpu_torch.preprocess.run`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a stage runs on: the card unless the caller asks for
    another one. Raises when a CUDA device is asked for and none is
    visible; on the card, fp32 products run in full precision (no TF32)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "preprocessing runs on a CUDA device and none is visible; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
