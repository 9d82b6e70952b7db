"""Pluggable preprocessing backends.

Each prior (flow, depth, segmentation, features) has a classical backend
that needs no weights and a neural one that runs when its weights, which
ship in database/weights/, load. Selection via env vars:

  LAB4D_DEPTH_BACKEND   = zoe | unet | flowdisp | const      (default: auto)
  LAB4D_SEG_BACKEND     = external | unet | grabcut | full   (default: auto)
  LAB4D_FEAT_BACKEND    = dinov2 | net | filterbank          (default: auto)
  LAB4D_FLOW_BACKEND    = raft | classical                   (default: auto)

"auto" picks, as the JAX package does, a torch.hub model whose repo the
hub cache already holds (ZoeDepth, DINOv2) or a plugin module that
imports (`track_anything_cli`; `cse_viewpoint` for the canonical
rotations, scripts/canonical_registration.py), else the neural backend
if its weights load, else the classical one. Nothing is downloaded.
"""

import os


def pick_backend(env_key: str, neural: str, classical: str, probe) -> str:
    """Resolve a backend name: explicit env var wins, else probe() decides."""
    choice = os.environ.get(env_key, "auto")
    if choice != "auto":
        return choice
    try:
        ok = probe()
    except Exception:  # a probe that fails means the backend is unavailable
        ok = False
    return neural if ok else classical
