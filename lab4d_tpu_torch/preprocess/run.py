"""End-to-end preprocessing: raw videos in database/raw/<vidname>/ ->
training-ready database/processed/** priors and configs/<vidname>.config
(port of scripts/run_preprocess.py: the same stages in the same order).

  python -m lab4d_tpu_torch.preprocess.run <vidname> <text_prompt_seg> <obj_class> <devlist>
  e.g.    python -m lab4d_tpu_torch.preprocess.run cat-pikachu-0 cat quad 0

obj_class in {human, quad, other}; "other" expects manual camera
annotations (Cameras/<seq>/01-manual.json, see
scripts/manual_cameras.py). The per-video stages fan out over the cards
of `devlist` (utils/device_map.py: one worker process per card, pinned
with CUDA_VISIBLE_DEVICES): the frames of every video, then the config,
then each video's segmentation and priors in one worker (the JAX
package maps segmentation and priors separately; each video's stages
keep their order, and the manual-camera templates of obj_class "other",
which need only the frame lists, are written before them). Runs on the
card; `--device cpu` runs every stage on the CPU. Every stage returns
what it ran (its backend), and the run returns seconds per stage and the
peak device memory of each worker.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Dict

import torch

from lab4d_tpu_torch.preprocess import resolve_device
from lab4d_tpu_torch.preprocess.libs.io import config_seqnames
from lab4d_tpu_torch.utils.device_map import device_map

OBJ_CLASSES = ("human", "quad", "other")


class StageLog:
    """Seconds and backend of each stage of one worker, and its peak
    device memory; what a worker returns through device_map."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}
        self.backends: Dict[str, str] = {}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def record(self) -> Dict:
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        return {"seconds": self.seconds, "backends": self.backends, "peak_bytes": peak}


def run_extract_frames(seqname, outdir, infile, use_filter_frames, device=None):
    from lab4d_tpu_torch.preprocess.scripts.extract_frames import extract_frames
    from lab4d_tpu_torch.preprocess.scripts.frame_filter import frame_filter

    device = resolve_device(device)
    log = StageLog(device)
    raw_dir = f"{outdir}/JPEGImagesRaw/Full-Resolution/{seqname}"
    shutil.rmtree(raw_dir, ignore_errors=True)
    os.makedirs(raw_dir, exist_ok=True)
    with log.stage("extract_frames"):
        extract_frames(infile, raw_dir)

    # clear stale per-sequence outputs
    for sub in ("JPEGImages", "Annotations", "Cameras", "Features", "Depth"):
        shutil.rmtree(
            f"{outdir}/{sub}/Full-Resolution/{seqname}", ignore_errors=True
        )
    for d in glob.glob(f"{outdir}/Flow*/Full-Resolution/{seqname}"):
        shutil.rmtree(d, ignore_errors=True)

    with log.stage("frame_filter"):
        if use_filter_frames:
            frame_filter(seqname, outdir, device=device)
            log.backends["frame_filter"] = "classical"
        else:
            out_dir = f"{outdir}/JPEGImages/Full-Resolution/{seqname}"
            os.makedirs(out_dir, exist_ok=True)
            for p in sorted(glob.glob(f"{raw_dir}/*.jpg")):
                shutil.copy(p, out_dir)
    return log.record()


def run_segmentation(seqname, outdir, text_prompt="", device=None):
    from lab4d_tpu_torch.preprocess.backends.seg_backends import run_segmentation as segment

    device = resolve_device(device)
    log = StageLog(device)
    with log.stage("segmentation"):
        log.backends["segmentation"] = segment(seqname, outdir, text_prompt, device=device)
    return log.record()


def run_extract_priors(seqname, outdir, obj_class, device=None):
    from lab4d_tpu_torch.preprocess.backends.depth_backends import extract_depth
    from lab4d_tpu_torch.preprocess.scripts.camera_registration import camera_registration
    from lab4d_tpu_torch.preprocess.scripts.canonical_registration import canonical_registration
    from lab4d_tpu_torch.preprocess.scripts.compute_flow import compute_flow
    from lab4d_tpu_torch.preprocess.scripts.crop import extract_crop
    from lab4d_tpu_torch.preprocess.scripts.tsdf_fusion import tsdf_fusion

    device = resolve_device(device)
    log = StageLog(device)
    print("extracting priors:", seqname)
    with log.stage("flow"):
        log.backends["flow"] = ",".join(sorted({
            compute_flow(seqname, outdir, dframe, device=device) for dframe in (1, 2, 4, 8)}))
    with log.stage("depth"):
        log.backends["depth"] = extract_depth(seqname, outdir, device=device)
    # the two crops, and the two components' registrations, are independent
    # host work (numpy / OpenCV, which release the interpreter lock): two threads
    with log.stage("crop"), ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda full: extract_crop(seqname, 256, full, outdir), (0, 1)))
    with log.stage("camera_registration"), ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda comp: camera_registration(seqname, comp, outdir), (0, 1)))
    with log.stage("tsdf_fusion"):
        tsdf_fusion(seqname, 0, outdir, device=device)
    with log.stage("canonical_registration"):
        _, log.backends["viewpoint"] = canonical_registration(
            seqname, 256, obj_class, outdir=outdir, device=device)
    return log.record()


def run_video(seqname, outdir, text_prompt, obj_class, device=None):
    """One video's segmentation, then its priors, in one worker."""
    return {"segmentation": run_segmentation(seqname, outdir, text_prompt, device),
            "priors": run_extract_priors(seqname, outdir, obj_class, device)}


def run_preprocess(
    vidname: str,
    text_prompt_seg: str,
    obj_class: str,
    devlist,
    database_root: str = "database",
    use_filter_frames: bool = True,
    device="cuda",
) -> Dict:
    """Run every stage; returns {"workers": {seqname: {stage: record}},
    "features": record, "seqnames": [...]}."""
    from lab4d_tpu_torch.preprocess.scripts.extract_features import extract_features
    from lab4d_tpu_torch.preprocess.scripts.write_config import write_config

    if obj_class not in OBJ_CLASSES:
        raise ValueError(f"obj_class {obj_class!r}: not one of {OBJ_CLASSES}")
    device = str(resolve_device(device))
    outdir = f"{database_root}/processed"
    viddir = f"{database_root}/raw/{vidname}"

    if not os.path.isdir(viddir) or not os.listdir(viddir):
        from lab4d_tpu_torch.preprocess.scripts.download import download_seq

        download_seq(vidname, database_root)

    frame_args = []
    for counter, infile in enumerate(sorted(glob.glob(f"{viddir}/*"))):
        seqname = f"{vidname}-{counter:04d}"
        frame_args.append((seqname, outdir, infile, use_filter_frames, device))
    if not frame_args:
        raise FileNotFoundError(f"no raw videos under {viddir}")
    frames = device_map(run_extract_frames, frame_args, devices=devlist)

    write_config(vidname, database_root)
    seqnames = config_seqnames(vidname, database_root)

    if obj_class == "other":  # templates from the frame lists alone
        from lab4d_tpu_torch.preprocess.scripts.manual_cameras import ensure_manual_cameras

        ensure_manual_cameras(seqnames, outdir)

    videos = device_map(
        run_video,
        [(s, outdir, text_prompt_seg, obj_class, device) for s in seqnames],
        devices=devlist,
    )

    log = StageLog(device)
    with log.stage("features"):
        log.backends["features"] = extract_features(vidname, 256, database_root=database_root,
                                                    device=device)
    print(f"preprocessing done: {vidname}")
    by_seq = {a[0]: {"frames": r} for a, r in zip(frame_args, frames)}
    for s, rec in zip(seqnames, videos):
        by_seq.setdefault(s, {}).update(rec)
    return {"workers": by_seq, "features": log.record(), "seqnames": seqnames}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("vidname")
    p.add_argument("text_prompt_seg")
    p.add_argument("obj_class", choices=OBJ_CLASSES)
    p.add_argument("devlist", help="comma-separated card ids, e.g. 0,1")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda or cpu)")
    p.add_argument("--database_root", default="database")
    args = p.parse_args(argv)
    return run_preprocess(
        args.vidname, args.text_prompt_seg, args.obj_class,
        [int(x) for x in args.devlist.split(",")],
        database_root=args.database_root, device=args.device,
    )


if __name__ == "__main__":
    main()
