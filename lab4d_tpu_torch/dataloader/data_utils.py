"""Sequence-level dataset assembly, metadata and the threaded training
batch pipeline.

Port of lab4d_tpu/dataloader/data_utils.py: the same INI config
(database/configs/<seqname>.config), get_data_info contract and
TrainBatchLoader, which prefetches fixed-shape (M, 2, N, ...) numpy
batches of frame pairs in worker threads.
"""

from __future__ import annotations

import configparser
import glob
import queue
import threading
from typing import Dict, List

import numpy as np

from lab4d_tpu_torch.dataloader.vidloader import VidData
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from lab4d_tpu_torch.utils.numpy_utils import pca_numpy


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


def config_to_datasets(opts: Dict, is_eval: bool = False) -> List[VidData]:
    """One VidData per video of the sequence: full frames without flow
    pairs beyond delta 1 for eval, `pixels_per_image` pixels of pairs at
    deltas {1, 2, 4, 8} for training."""
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
                feature_type=opts["feature_type"], delta_list=[] if is_eval else [2, 4, 8],
                pixels_per_image=-1 if is_eval else opts["pixels_per_image"],
            )
        )
    return datasets


def get_data_info(datasets: List[VidData]):
    """Aggregate per-video metadata: frame tables, intrinsics, raw sizes,
    feature PCA, camera priors and the initial meshes."""
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
    camera_prefix = datasets[0].dict_list["cambg"].rsplit("/", 1)[0]
    return {
        "frame_info": frame_info,
        "total_frames": frame_info.num_frames,
        "intrinsics": np.asarray(intrinsics, dtype=np.float32),
        "raw_size": np.asarray(raw_size),
        "apply_pca_fn": pca_numpy(feature_pxs, n_components=3),
        "vis_info": {"bg": 0, "fg": 1},
        "rtmat": np.stack([rtmat_bg, rtmat_fg], 0),
        "geom_path": [f"{camera_prefix}/mesh-00-centered.obj",
                      f"{camera_prefix}/mesh-01-centered.obj"],
    }


def load_eval_frame(datasets: List[VidData], global_fid: int, data_info):
    """One full-resolution eval frame pair by global filtered-frame index:
    reference images and batch metadata, (2, ...) arrays."""
    offset = data_info["frame_info"].frame_offset
    di = int(np.searchsorted(offset, global_fid, side="right") - 1)
    ds = datasets[di]
    return ds.load_pair(min(int(global_fid - offset[di]), len(ds) - 1))


def get_vid_length(inst_id, data_info):
    off = data_info["frame_info"].frame_offset_raw
    return int(off[inst_id + 1] - off[inst_id])


class TrainBatchLoader:
    """Threaded prefetching sampler of fixed-shape (M, 2, N, ...) training
    batches: each batch samples `imgs_per_batch` frame pairs uniformly over
    all videos, with the datasets' `pixels_per_image` pixels each, gathered
    by `gather` ("native" or its numpy "reference"; VidData.load_pairs_batch).

    imgs_per_batch is the global batch of a run over ranks
    (parallel/dist.py): every rank's loader draws the same global batches
    in the same order, and the rank trains on its block of rows. Each
    worker thread draws from streams of its own (worker 0 from the pair
    stream and the datasets' own delta and pixel draws, as the JAX
    package's single worker does; worker w > 0 from streams seeded from
    the loader's seed, VidData.with_draws) and the workers' batches are
    taken in turn, so that the sequence does not depend on which thread
    runs first.
    With video_shards > 1, block j of the leading axis (one of the
    total_shards blocks) draws its pairs from the videos of group
    j % video_shards (di % video_shards), as the JAX package's loader does
    for its ("data", "video") mesh."""

    def __init__(self, datasets: List[VidData], imgs_per_batch: int, num_workers: int = 2,
                 prefetch: int = 4, seed: int = 0, gather: str = "native",
                 total_shards: int = 1, video_shards: int = 1):
        self.datasets = datasets
        self.imgs_per_batch = imgs_per_batch
        self.gather = gather
        self.total_shards = max(1, total_shards)
        self.video_shards = max(1, video_shards)
        if self.total_shards % self.video_shards or imgs_per_batch % self.total_shards:
            raise ValueError(f"{imgs_per_batch} pairs over {self.total_shards} shards and "
                             f"{self.video_shards} video shards do not split evenly")
        pool = []
        for di, ds in enumerate(datasets):
            pool += [(di, fi) for fi in range(len(ds))]
        self.pool = np.asarray(pool, dtype=np.int64)
        if self.video_shards > 1:
            self.group_pools = [self.pool[self.pool[:, 0] % self.video_shards == g]
                                for g in range(self.video_shards)]
            if not all(len(p) for p in self.group_pools):
                raise ValueError("every video shard needs at least one video")
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.queues: List[queue.Queue] = []
        self._turn = 0
        self._stop = threading.Event()
        self._threads = []

    def _pick_pairs(self, rng) -> np.ndarray:
        """Ordered (imgs_per_batch, 2) array of (dataset_idx, frame_idx)."""
        if self.video_shards == 1:
            return self.pool[rng.integers(0, len(self.pool), size=self.imgs_per_batch)]
        m = self.imgs_per_batch // self.total_shards
        blocks = []
        for j in range(self.total_shards):
            gpool = self.group_pools[j % self.video_shards]
            blocks.append(gpool[rng.integers(0, len(gpool), size=m)])
        return np.concatenate(blocks, axis=0)

    def _make_batch(self, rng, datasets=None) -> Dict[str, np.ndarray]:
        datasets = self.datasets if datasets is None else datasets
        ordered = self._pick_pairs(rng)
        # one gather per video over its pairs, rows scattered back to the drawn order
        by_vid: Dict[int, list] = {}
        order: Dict[int, list] = {}
        for row, (di, fi) in enumerate(ordered):
            by_vid.setdefault(int(di), []).append(int(fi))
            order.setdefault(int(di), []).append(row)
        chunks = [(datasets[di].load_pairs_batch(fis, rng, gather=self.gather), order[di])
                  for di, fis in by_vid.items()]
        inv = np.argsort(np.concatenate([np.asarray(r) for _, r in chunks]))
        return {k: np.concatenate([c[k] for c, _ in chunks], axis=0)[inv] for k in chunks[0][0]}

    def _worker(self, wid: int, rng, datasets):
        q = self.queues[wid]
        while not self._stop.is_set():
            # a batch made before a stop and not queued is queued first after
            # a restart, so that the stream skips none
            if self._held[wid] is None:
                self._held[wid] = self._make_batch(rng, datasets)
            while not self._stop.is_set():
                try:
                    q.put(self._held[wid], timeout=0.5)
                    self._held[wid] = None
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._threads:
            return
        self._stop.clear()
        if not self.queues:  # the workers' streams, seeded in worker order
            self.queues = [queue.Queue(maxsize=max(1, self.prefetch // self.num_workers))
                           for _ in range(self.num_workers)]
            self._rngs = [np.random.default_rng(self.rng.integers(0, 2**31) + w)
                          for w in range(self.num_workers)]
            self._views = [self.datasets] + [
                [ds.with_draws(int(self.rng.integers(0, 2**31))) for ds in self.datasets]
                for _ in range(1, self.num_workers)]
            self._held = [None] * self.num_workers
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(w, self._rngs[w], self._views[w]),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The next batch, from the workers in turn: the same sequence in
        every run from the same seed, whichever thread finishes first."""
        if not self._threads:
            self.start()
        batch = self.queues[self._turn].get()
        self._turn = (self._turn + 1) % self.num_workers
        return batch

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
