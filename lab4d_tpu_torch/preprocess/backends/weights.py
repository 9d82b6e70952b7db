"""Weight-file resolution shared by the neural preprocessing backends.

Search order for a weight file ``<name>``:

1. ``$LAB4D_WEIGHTS_DIR/<name>`` (explicit override)
2. ``database/weights/<name>`` relative to the CURRENT directory
   (user-local weights in a workdir)
3. ``database/weights/<name>`` relative to the REPO (the trained
   weights shipped in-tree), so that a user running from their own
   workdir still gets the neural backends.

Returns the first existing path, else the cwd-relative path.
"""

from __future__ import annotations

import os

# lab4d_tpu_torch/preprocess/backends/weights.py -> the repo root
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def resolve_weights(name: str) -> str:
    env_dir = os.environ.get("LAB4D_WEIGHTS_DIR")
    if env_dir:
        return os.path.join(env_dir, name)
    cwd_path = os.path.join("database", "weights", name)
    if os.path.exists(cwd_path):
        return cwd_path
    repo_path = os.path.join(_REPO, "database", "weights", name)
    if os.path.exists(repo_path):
        return repo_path
    return cwd_path



def train_out_path(name: str) -> str:
    """Where a trainer (lab4d_tpu_torch/scripts/train_*.py) writes its
    weights by default: ``$LAB4D_WEIGHTS_DIR/<name>``, else
    ``database/weights/<name>`` relative to the current directory. It never
    falls back to the repo, so a short run cannot overwrite the shipped
    weights."""
    wdir = os.environ.get("LAB4D_WEIGHTS_DIR", os.path.join("database", "weights"))
    return os.path.join(wdir, name)
