"""Segmentation stage: Annotations/Full-Resolution/<seqname>/*.npy masks
from <outdir>/JPEGImages/Full-Resolution/<seqname>/*.jpg, through the
segmentation backends' `auto` choice (port of
preprocess/scripts/segmentation.py).

    python -m lab4d_tpu_torch.preprocess.scripts.segmentation <seqname> [outdir] [prompt]
        [--device cuda|cpu]

outdir defaults to database/processed, prompt (the text that picks an
instance among the tracked components) to "". Runs on the card unless
`--device cpu` is given, and raises when no card is visible; a backend's
failure is raised, not caught.
"""

from __future__ import annotations

import argparse

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.backends.seg_backends import run_segmentation


def main(argv=None) -> str:
    """Returns the backend that ran."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("seqname")
    p.add_argument("outdir", nargs="?", default="database/processed")
    p.add_argument("prompt", nargs="?", default="")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda or cpu)")
    args = p.parse_args(argv)
    return run_segmentation(args.seqname, args.outdir, args.prompt,
                            device=resolve_device(args.device))


if __name__ == "__main__":
    main()
