"""Pluggable preprocessing backends.

Each prior (flow, depth, segmentation, features) has a classical backend
that needs no weights and a neural one that runs when its weights, which
ship in database/weights/, load. Selection via env vars:

  LAB4D_DEPTH_BACKEND   = unet | flowdisp | const      (default: auto)
  LAB4D_SEG_BACKEND     = unet | grabcut | full        (default: auto)
  LAB4D_FEAT_BACKEND    = net | filterbank             (default: auto)
  LAB4D_FLOW_BACKEND    = raft | classical             (default: auto)

"auto" picks the neural backend if its weights load, else the classical
one. (The JAX package's torch.hub and plugin backends, ZoeDepth, DINOv2,
Track-Anything and the CSE viewpoint head, are not part of the port.)
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
