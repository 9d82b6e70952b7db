"""Sequence-level dataset assembly and metadata, eval side.

Port of lab4d_tpu/dataloader/data_utils.py: the same INI config
(database/configs/<seqname>.config) and get_data_info contract. The
per-video reader (VidData) is the JAX package's own numpy module,
imported where it is used, so that rendering from in-memory metadata
never loads the JAX package.
"""

from __future__ import annotations

import configparser
import glob
from typing import TYPE_CHECKING, Dict, List

import numpy as np

from lab4d_tpu_torch.nnutils.embedding import FrameInfo

if TYPE_CHECKING:
    from lab4d_tpu.dataloader.vidloader import VidData


def load_sequence_config(seqname: str, database_root: str = "database"):
    """Parse database/configs/<seqname>.config into one dict per video."""
    config = configparser.RawConfigParser()
    path = f"{database_root}/configs/{seqname}.config"
    if not config.read(path):
        raise FileNotFoundError(path)

    def section_dict(section, base=None):
        d = dict(base or {})
        for key, cast in (
            ("img_path", str),
            ("init_frame", int),
            ("end_frame", int),
            ("ks", lambda s: [float(v) for v in s.split(" ")]),
            ("shape", lambda s: [int(v) for v in s.split(" ")]),
        ):
            if config.has_option(section, key):
                d[key] = cast(config.get(section, key))
        return d

    base = section_dict("data")
    numvid = len(config.sections()) - 1
    return [section_dict(f"data_{i}", base) for i in range(numvid)]


def config_to_datasets(opts: Dict) -> List[VidData]:
    """One eval VidData per video of the sequence (full frames, no flow
    pairs beyond delta 1)."""
    from lab4d_tpu.dataloader.vidloader import VidData

    sections = load_sequence_config(opts["seqname"], opts.get("database_root", "database"))
    prefix = "%s-%d" % (opts["data_prefix"], opts["train_res"])
    datasets = []
    for vidid, sec in enumerate(sections):
        rgblist = sorted(glob.glob("%s/*.jpg" % sec["img_path"]))
        if sec.get("end_frame", -1) > -1:
            rgblist = rgblist[: sec["end_frame"]]
        if sec.get("init_frame", 0) > 0:
            rgblist = rgblist[sec["init_frame"]:]
        datasets.append(
            VidData(
                rgblist, dataid=vidid, ks=sec["ks"], raw_size=sec["shape"], prefix=prefix,
                feature_type=opts["feature_type"], delta_list=[], pixels_per_image=-1,
            )
        )
    return datasets


def get_data_info(datasets: List[VidData]):
    """Aggregate per-video metadata: frame tables, intrinsics, raw sizes,
    feature PCA, camera priors."""
    from lab4d_tpu.utils.numpy_utils import pca_numpy

    frame_offset, frame_offset_raw, frame_mapping = [0], [0], []
    intrinsics, raw_size, feature_pxs = [], [], []
    acc_raw = 0
    for ds in datasets:
        frame_mapping += [f + acc_raw for f in ds.frame_map]
        acc_raw += ds.num_frames_raw
        frame_offset.append(ds.num_frames)
        frame_offset_raw.append(ds.num_frames_raw)
        intrinsics += [ds.ks] * ds.num_frames
        raw_size.append(ds.raw_size)
        feat = np.asarray(ds.mmap["feature"]).reshape(-1, 16)
        feature_pxs.append(feat[:: max(1, len(feat) // 1000)])

    feature_pxs = np.concatenate(feature_pxs, 0).astype(np.float32)
    feature_pxs = feature_pxs[np.linalg.norm(feature_pxs, 2, -1) > 0]
    if len(feature_pxs) == 0:
        feature_pxs = np.random.default_rng(0).random((100, 16)).astype(np.float32)
    frame_info = FrameInfo(
        np.asarray(frame_offset).cumsum(), np.asarray(frame_offset_raw).cumsum(), frame_mapping
    )
    rtmat_bg = np.concatenate(
        [np.load(ds.dict_list["cambg"]).astype(np.float32) for ds in datasets], 0
    )
    rtmat_fg = np.concatenate(
        [np.load(ds.dict_list["camfg"]).astype(np.float32) for ds in datasets], 0
    )
    return {
        "frame_info": frame_info,
        "total_frames": frame_info.num_frames,
        "intrinsics": np.asarray(intrinsics, dtype=np.float32),
        "raw_size": np.asarray(raw_size),
        "apply_pca_fn": pca_numpy(feature_pxs, n_components=3),
        "vis_info": {"bg": 0, "fg": 1},
        "rtmat": np.stack([rtmat_bg, rtmat_fg], 0),
    }


def get_vid_length(inst_id, data_info):
    off = data_info["frame_info"].frame_offset_raw
    return int(off[inst_id + 1] - off[inst_id])
