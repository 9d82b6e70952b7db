"""Monocular depth stage: Depth/Full-Resolution/<seqname>/*.npy (float16)
from database/processed/JPEGImages/Full-Resolution/<seqname>/*.jpg, through
the depth backends' `auto` choice (port of preprocess/scripts/depth.py).

    python -m lab4d_tpu_torch.preprocess.scripts.depth <seqname> [--device cuda|cpu]

Runs on the card unless `--device cpu` is given, and raises when no card
is visible; a backend's failure is raised, not caught.
"""

from __future__ import annotations

import argparse

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.depth_backends import extract_depth


def main(argv=None) -> str:
    """Returns the backend that ran."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("seqname")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda or cpu)")
    args = p.parse_args(argv)
    return extract_depth(args.seqname, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
