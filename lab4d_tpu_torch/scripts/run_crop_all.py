"""Re-crop every processed sequence of a video collection, fanned out over
worker processes (utils/device_map.py; one CPU worker on a host without
a card): the port of scripts/run_crop_all.py, through the port's
preprocess/scripts/crop.py extract_crop.

    python -m lab4d_tpu_torch.scripts.run_crop_all <collection> [crop_size] [outdir]
    e.g. python -m lab4d_tpu_torch.scripts.run_crop_all cat-pikachu 256
"""

from __future__ import annotations

import glob
import os
import sys


def crop_one(seqname: str, use_full: int, crop_size: int, outdir: str):
    """Module-level worker (device_map spawns processes; the target must
    be picklable)."""
    from lab4d_tpu_torch.preprocess.scripts.crop import extract_crop

    extract_crop(seqname, crop_size, use_full, outdir=outdir)


def main(argv=None):
    from lab4d_tpu_torch.utils.device_map import device_map

    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or (len(argv) > 1 and not argv[1].isdigit()):
        print(__doc__)
        sys.exit(1)
    collection = argv[0]
    crop_size = int(argv[1]) if len(argv) > 1 else 256
    outdir = argv[2] if len(argv) > 2 else "database/processed"

    seq_dirs = sorted(glob.glob(os.path.join(outdir, "JPEGImages", "Full-Resolution",
                                             collection + "*")))
    if not seq_dirs:
        print(f"no sequences matching {collection}* under {outdir}")
        sys.exit(1)
    seqnames = [os.path.basename(p) for p in seq_dirs]

    # one task per (sequence, crop / full) pair
    tasks = [(s, use_full, crop_size, outdir) for s in seqnames for use_full in (0, 1)]
    print(f"cropping {len(seqnames)} seqs ({len(tasks)} tasks) at {crop_size}px")
    device_map(crop_one, tasks)
    print("done")
    return seqnames


if __name__ == "__main__":
    main()
