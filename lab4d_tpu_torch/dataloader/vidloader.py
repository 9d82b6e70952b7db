"""Per-video frame data over numpy mmap. The port's copy of
lab4d_tpu/dataloader/vidloader.py: a training batch's pixels are gathered
by the native sampler (lab4d_tpu_torch/native), in the JAX package's draw
order.

Parity: lab4d/dataloader/vidloader.py — identical on-disk contract
(database/processed/{JPEGImages,Annotations,FlowFW_k,FlowBW_k,Depth,
Features,Cameras}/Full-Resolution/<seq>/ with packed per-video .npy
tensors), re-designed as a plain host-side sampler feeding fixed-shape
numpy batches to the device (no torch Dataset/DataLoader machinery).
"""

from __future__ import annotations

import copy
import glob
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from lab4d_tpu_torch import native
from lab4d_tpu_torch.utils.numpy_utils import bilinear_interp


class RangeSampler:
    """Sample without replacement from [0, num_elems) via shuffled queue
    (vidloader.py:13-43)."""

    def __init__(self, num_elems: int, rng: Optional[np.random.Generator] = None):
        self.num_elems = num_elems
        self.rng = rng or np.random.default_rng()
        self._refill()

    def _refill(self):
        self.queue = self.rng.permutation(self.num_elems)
        self.curr = 0

    def sample(self, n: int) -> np.ndarray:
        if self.curr + n > self.num_elems:
            self._refill()
        out = self.queue[self.curr : self.curr + n]
        self.curr += n
        return out


class VidData:
    """Frame data and annotations for one video.

    Args:
        rgblist: sorted list of filtered frame jpg paths
        dataid: video index in the sequence
        ks: [fx, fy, cx, cy] intrinsics guess
        raw_size: [H, W] of raw frames
        prefix: data prefix, e.g. "crop-256"
        feature_type: "dinov2" or "cse"
        delta_list: flow deltas available beyond 1 (e.g. [2, 4, 8])
        pixels_per_image: pixels sampled per frame (-1 = full image)
    """

    def __init__(
        self,
        rgblist,
        dataid: int,
        ks,
        raw_size,
        prefix: str = "crop-256",
        feature_type: str = "dinov2",
        delta_list=(2, 4, 8),
        pixels_per_image: int = 16,
        rng: Optional[np.random.Generator] = None,
    ):
        self.rgblist = rgblist
        self.dataid = dataid
        self.ks = list(ks)
        self.raw_size = list(raw_size)
        self.delta_list = list(delta_list)
        self.pixels_per_image = pixels_per_image
        self.rng = rng or np.random.default_rng()

        self.dict_list = self._construct_data_list(rgblist, prefix, feature_type)
        self._load_data_list()

        self.img_size = self.mmap["rgb"].shape[1:3]
        self.idx_sampler = RangeSampler(
            self.img_size[0] * self.img_size[1], rng=self.rng
        )

        # frame metadata (parity: data_utils.FrameInfo)
        first_dir = os.path.dirname(rgblist[0])
        raw_dir = first_dir.replace("JPEGImages", "JPEGImagesRaw")
        raw_frames = glob.glob(os.path.join(raw_dir, "*.jpg"))
        self.num_frames = len(rgblist)
        self.num_frames_raw = (
            len(raw_frames) if raw_frames else self.mmap["rgb"].shape[0]
        )
        self.frame_map = [
            int(os.path.basename(p).split(".")[0]) for p in rgblist
        ]

    def _construct_data_list(self, reflist, prefix, feature_type) -> Dict[str, str]:
        """Derive npy paths from the frame list (vidloader.py:74-121)."""
        first = reflist[0]
        stem = os.path.basename(first)
        rgb_path = first.replace(stem, f"{prefix}.npy")
        mask_path = rgb_path.replace("JPEGImages", "Annotations")
        feature_path = str(
            Path(rgb_path.replace("JPEGImages", "Features")).parent
        ) + f"/{prefix}-{feature_type}-01.npy"
        return {
            "ref": reflist,
            "rgb": rgb_path,
            "mask": mask_path,
            "flowfw": rgb_path.replace("JPEGImages", "FlowFW"),
            "flowbw": rgb_path.replace("JPEGImages", "FlowBW"),
            "depth": rgb_path.replace("JPEGImages", "Depth"),
            "feature": feature_path,
            "crop2raw": mask_path.replace(".npy", "-crop2raw.npy"),
            "is_detected": mask_path.replace(".npy", "-is_detected.npy"),
            "cambg": first.replace("JPEGImages", "Cameras").replace(stem, "00.npy"),
            "camfg": first.replace("JPEGImages", "Cameras").replace(
                stem, "01-canonical.npy"
            ),
        }

    def _load_data_list(self):
        self.crop2raw = np.load(self.dict_list["crop2raw"])
        self.is_detected = np.load(self.dict_list["is_detected"])
        self.mmap = {}
        for k in ("rgb", "mask", "depth"):
            self.mmap[k] = np.load(self.dict_list[k], mmap_mode="r")
        for k in ("flowfw", "flowbw"):
            self.mmap[k] = {}
            for delta in [1] + self.delta_list:
                path = self.dict_list[k].replace("FlowFW", f"FlowFW_{delta}").replace(
                    "FlowBW", f"FlowBW_{delta}"
                )
                if os.path.exists(path):
                    self.mmap[k][delta] = np.load(path, mmap_mode="r")
        try:
            self.mmap["feature"] = np.load(self.dict_list["feature"], mmap_mode="r")
        except (FileNotFoundError, ValueError):
            print(f"Warning: cannot load {self.dict_list['feature']}")
            self.mmap["feature"] = np.random.rand(
                len(self) + 1, 112, 112, 16
            ).astype(np.float16)

    def __len__(self):
        # last frame cannot start a pair
        return len(self.dict_list["ref"]) - 1

    # -------------------------------------------------------------- sampling

    def sample_delta(self, index: int) -> int:
        """Random pair distance in {1} + delta_list subject to alignment and
        range (vidloader.py:167-181)."""
        choices = [1] + [
            d
            for d in self.delta_list
            if index % d == 0 and index + d < len(self.dict_list["ref"])
        ]
        return int(self.rng.choice(choices))

    def sample_xy(self) -> Optional[np.ndarray]:
        if self.pixels_per_image == -1:
            return None
        idx = self.idx_sampler.sample(self.pixels_per_image)
        y0 = idx % self.img_size[0]
        x0 = idx // self.img_size[0]
        return np.stack([x0, y0], axis=-1)

    def with_draws(self, seed: int) -> "VidData":
        """This video (its data shared, not copied) with delta and pixel
        draws of its own, from `seed`."""
        view = copy.copy(self)
        view.rng = np.random.default_rng(seed)
        view.idx_sampler = RangeSampler(self.idx_sampler.num_elems, rng=view.rng)
        return view

    def load_pairs_batch(self, indices, rng=None, gather: str = "native") -> Dict[str, np.ndarray]:
        """Pairs for `indices` (F,) pair-start frames, every modality
        gathered in one call over all 2F frames; returns dict of (F, 2, ...)
        arrays matching load_pair's contract.

        The draws are the JAX package's (lab4d_tpu/dataloader/vidloader.py
        load_pairs_batch): all F deltas first, then the 2F pixel sets, both
        from self.rng. gather: "native" (the C++ library) or "reference"
        (its numpy version, the same values)."""
        ops = native.backend(gather)
        F = len(indices)
        N = self.pixels_per_image
        deltas = [self.sample_delta(int(i)) for i in indices]
        f0 = np.asarray([int(i) for i in indices], np.int32)
        f1 = f0 + np.asarray(deltas, np.int32)
        fids = np.empty(2 * F, np.int32)
        fids[0::2] = f0
        fids[1::2] = f1
        xys = np.stack([self.sample_xy() for _ in range(2 * F)]).astype(np.int32)

        rgb = ops.gather_pixels(self.mmap["rgb"], fids, xys)
        if rgb.shape[-1] == 1:  # gray
            rgb = np.repeat(rgb, 3, axis=-1)
        mask2 = ops.gather_pixels(self.mmap["mask"], fids, xys)
        depth = ops.gather_pixels(self.mmap["depth"], fids, xys)
        feat_map = self.mmap["feature"]
        feature = ops.gather_features_bilinear(
            feat_map, fids, xys, float(feat_map.shape[1]) / self.img_size[0])

        # flow: one gather per (delta, direction)
        flow = np.zeros((2 * F, N, 3), np.float32)
        groups: Dict[tuple, list] = {}
        for i in range(F):
            groups.setdefault((deltas[i], True), []).append(i)
            groups.setdefault((deltas[i], False), []).append(i)
        for (d, is_fw), rows in groups.items():
            rows = np.asarray(rows)
            if is_fw:
                src, sel = self.mmap["flowfw"][d], 2 * rows  # first of the pair
                sub_fids = (f0[rows] // d).astype(np.int32)
            else:
                src, sel = self.mmap["flowbw"][d], 2 * rows + 1
                sub_fids = (f1[rows] // d - 1).astype(np.int32)
            flow[sel] = ops.gather_pixels(src, sub_fids, xys[sel])

        hxy = np.concatenate([xys.astype(np.float32), np.ones((2 * F, N, 1), np.float32)], -1)

        def pair(x):
            return x.reshape((F, 2) + x.shape[1:])

        return {
            "rgb": pair(rgb),
            "mask": pair(mask2[..., :1]),
            "depth": pair(depth),
            "feature": pair(feature),
            "flow": pair(flow[..., :2]),
            "flow_uct": pair(flow[..., 2:]),
            "vis2d": pair(mask2[..., 1:]),
            "crop2raw": self.crop2raw[fids].astype(np.float32).reshape(F, 2, 4),
            "is_detected": self.is_detected[fids].astype(np.float32).reshape(F, 2),
            "dataid": np.full((F, 2), self.dataid, np.int32),
            "frameid_sub": np.asarray(self.frame_map, np.int32)[fids].reshape(F, 2),
            "hxy": pair(hxy),
        }

    def load_pair(self, im0idx: int) -> Dict[str, np.ndarray]:
        """Sample a (frame, frame+delta) pair -> dict of (2, ...) arrays."""
        delta = self.sample_delta(im0idx)
        d0 = self.read_raw(im0idx, delta, rand_xy=self.sample_xy())
        d1 = self.read_raw(im0idx + delta, -delta, rand_xy=self.sample_xy())
        return {k: np.stack([d0[k], d1[k]]) for k in d0}

    def read_raw(self, idx: int, delta: int, rand_xy=None) -> Dict[str, np.ndarray]:
        """All modalities for one frame at sampled pixels (vidloader.py:223-262)."""
        rgb = self._read_px("rgb", idx, rand_xy)
        if rgb.ndim == (1 if rand_xy is not None else 2):
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        mask2 = self._read_px("mask", idx, rand_xy)
        mask, vis2d = mask2[..., :1], mask2[..., 1:]
        depth = self._read_px("depth", idx, rand_xy)[..., None]
        flow = self.read_flow(idx, delta, rand_xy)
        feature = self.read_feature(idx, rand_xy)

        if rand_xy is None:
            x0, y0 = np.meshgrid(range(self.img_size[1]), range(self.img_size[0]))
            hxy = np.stack([x0, y0, np.ones_like(x0)], axis=-1)
        else:
            hxy = np.concatenate([rand_xy, np.ones_like(rand_xy[:, :1])], axis=-1)

        return {
            "rgb": np.ascontiguousarray(rgb, dtype=np.float32),
            "mask": np.ascontiguousarray(mask, dtype=np.float32),
            "depth": np.ascontiguousarray(depth, dtype=np.float32),
            "feature": feature.astype(np.float32),
            "flow": flow[..., :2].astype(np.float32),
            "flow_uct": flow[..., 2:].astype(np.float32),
            "vis2d": np.ascontiguousarray(vis2d, dtype=np.float32),
            "crop2raw": self.crop2raw[idx].astype(np.float32),
            "is_detected": np.float32(self.is_detected[idx]),
            "dataid": np.int32(self.dataid),
            "frameid_sub": np.int32(self.frame_map[idx]),
            "hxy": hxy.astype(np.float32),
        }

    def _read_px(self, key, idx, rand_xy):
        arr = self.mmap[key][idx]
        if rand_xy is not None:
            return arr[rand_xy[:, 1], rand_xy[:, 0]]
        return arr

    def read_feature(self, idx, rand_xy):
        feat = self.mmap["feature"][idx]  # (112, 112, C)
        if rand_xy is not None:
            xy = rand_xy / self.img_size[0] * feat.shape[0]
            return bilinear_interp(feat, xy).astype(np.float32)
        return np.asarray(feat, dtype=np.float32)

    def read_flow(self, idx, delta, rand_xy):
        is_fw = delta > 0
        delta = abs(delta)
        if is_fw:
            flow = self.mmap["flowfw"][delta][idx // delta]
        else:
            flow = self.mmap["flowbw"][delta][idx // delta - 1]
        if rand_xy is not None:
            flow = flow[rand_xy[:, 1], rand_xy[:, 0]]
        return np.asarray(flow, dtype=np.float32)
