"""Host-side IO for the preprocessing pipeline (numpy and cv2 only).

Reads per-frame artifacts (jpg frames, npy masks/flow/depth) at raw
resolution and resamples them into the mask-centered square crop frame
that training consumes.  File formats follow the reference layout
(reference: preprocess/libs/io.py, lab4d/utils/geom_utils.py:143-171):

  JPEGImages/Full-Resolution/<seq>/%05d.jpg      uint8 RGB, raw res
  Annotations/.../%05d.npy                       int mask; 0=bg, >0=fg id,
                                                 any negative value => frame
                                                 had no detection
  FlowFW_d/.../%05d.npy, FlowBW_d/...            (h,w,3) float: u,v,occ
                                                 (occ>0 means occluded);
                                                 may be stored at reduced res
  Depth/.../%05d.npy                             (h,w) float16 metric-ish depth

The crop transform is encoded as ``crop2raw = [fx, fy, px, py]`` mapping
homogeneous crop pixel coords to raw pixel coords (a scaled axis-aligned
intrinsics-style transform).
"""

from __future__ import annotations

import glob
import os
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import cv2
import numpy as np


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def run_bash_command(cmd: str):
    subprocess.run(cmd, shell=True, check=True)


def K2mat_np(K: np.ndarray) -> np.ndarray:
    """[fx fy px py] -> 3x3 matrix (numpy twin of utils/geom.py K2mat)."""
    m = np.eye(3, dtype=np.float64)
    m[0, 0], m[1, 1], m[0, 2], m[1, 2] = K[0], K[1], K[2], K[3]
    return m


def K2inv_np(K: np.ndarray) -> np.ndarray:
    m = np.eye(3, dtype=np.float64)
    m[0, 0], m[1, 1] = 1.0 / K[0], 1.0 / K[1]
    m[0, 2], m[1, 2] = -K[2] / K[0], -K[3] / K[1]
    return m


def default_intrinsics(raw_shape) -> np.ndarray:
    """Intrinsics guess used across the pipeline: f = max(H, W), pp = center."""
    h, w = raw_shape[:2]
    f = float(max(h, w))
    return np.array([f, f, w / 2.0, h / 2.0], dtype=np.float64)


def frame_list(outdir: str, seqname: str, sub: str = "JPEGImages") -> List[str]:
    return sorted(glob.glob(f"{outdir}/{sub}/Full-Resolution/{seqname}/*.jpg"))


def config_seqnames(collection_name: str, database_root: str = "database") -> List[str]:
    """The sequence names of configs/<collection_name>.config's videos."""
    import configparser

    config = configparser.RawConfigParser()
    config.read(f"{database_root}/configs/{collection_name}.config")
    seqnames = []
    for vidid in range(len(config.sections()) - 1):
        img_path = config.get(f"data_{vidid}", "img_path")
        seqnames.append(img_path.strip("/").split("/")[-1])
    return seqnames


def sibling_path(img_path: str, sub: str, ext: str = ".npy") -> str:
    out = img_path.replace("JPEGImages", sub)
    return out[: out.rfind(".")] + ext


def largest_component(mask: np.ndarray) -> np.ndarray:
    """Keep only the largest connected foreground component of a bool mask."""
    mask_u8 = mask.astype(np.uint8)
    num, labels = cv2.connectedComponents(mask_u8)
    if num <= 2:
        return mask.astype(bool)
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return labels == counts.argmax()


def backward_warp_image(img: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Sample img at (x + u, y + v): img1 values pulled to frame-0 pixels."""
    h, w = flow.shape[:2]
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    map_x = (xx + flow[..., 0]).astype(np.float32)
    map_y = (yy + flow[..., 1]).astype(np.float32)
    return cv2.remap(img.astype(np.float32), map_x, map_y, cv2.INTER_LINEAR)


# ---------------------------------------------------------------------------
# raw readers
# ---------------------------------------------------------------------------


def load_mask(img_path: str, raw_shape):
    """Returns (mask>0 int, vis2d, is_detected). Missing file => undetected."""
    path = sibling_path(img_path, "Annotations")
    h, w = raw_shape[:2]
    if not os.path.exists(path):
        return np.ones((h, w), int), np.ones((h, w), int), False
    raw = np.load(path)
    if raw.ndim == 3:
        raw = raw[..., 0]
    if raw.shape[0] != h or raw.shape[1] != w:
        raw = cv2.resize(raw.astype(np.int32), (w, h), interpolation=cv2.INTER_NEAREST)
    is_detected = bool(raw.min() >= 0)
    mask = (raw > 0).astype(int)
    vis2d = np.ones_like(mask)
    return mask, vis2d, is_detected


def load_depth(img_path: str, raw_shape) -> np.ndarray:
    path = sibling_path(img_path, "Depth")
    depth = np.load(path).astype(np.float32)
    h, w = raw_shape[:2]
    if depth.shape[0] != h or depth.shape[1] != w:
        depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_LINEAR)
    return depth


def load_flow(img_path: str, delta: int, raw_shape):
    """Flow stored for pair (t, t+delta) under FlowFW_d (delta>0) or
    FlowBW_d (delta<0). Rescales to raw resolution. Returns (flow uv, occ)."""
    sub = f"FlowFW_{abs(delta)}" if delta > 0 else f"FlowBW_{abs(delta)}"
    path = sibling_path(img_path, sub)
    data = np.load(path).astype(np.float32)
    uv, occ = data[..., :2], data[..., 2]
    h, w = raw_shape[:2]
    oh, ow = uv.shape[:2]
    if (oh, ow) != (h, w):
        uv = cv2.resize(uv, (w, h))
        occ = cv2.resize(occ, (w, h))
        uv[..., 0] *= w / ow
        uv[..., 1] *= h / oh
    return uv, occ


# ---------------------------------------------------------------------------
# crop frame
# ---------------------------------------------------------------------------


def compute_crop_params(
    mask: np.ndarray,
    crop_factor: float = 1.2,
    crop_size: int = 256,
    use_full: bool = False,
) -> np.ndarray:
    """crop2raw [fx fy px py] for a mask-centered square crop.

    The crop covers a box crop_factor x the tight mask bbox (half-lengths
    scaled), resampled to crop_size^2.  With use_full (or no mask) the crop
    is the full frame (reference: lab4d/utils/geom_utils.py:143-171).
    """
    if use_full or mask.min() < 0:
        mask = np.ones_like(mask)
        crop_factor = 1.0
    ys, xs = np.nonzero(mask > 0)
    cx, cy = (xs.max() + xs.min()) // 2, (ys.max() + ys.min()) // 2
    hx = int(crop_factor * ((xs.max() - xs.min()) // 2))
    hy = int(crop_factor * ((ys.max() - ys.min()) // 2))
    return np.array(
        [2 * hx / crop_size, 2 * hy / crop_size, float(cx - hx), float(cy - hy)],
        dtype=np.float64,
    )


def crop_grid(crop2raw: np.ndarray, crop_size: int):
    """Raw-image sampling locations for every crop pixel: (S,S) map_x, map_y
    plus homogeneous crop coords hxy (S,S,3)."""
    xs, ys = np.meshgrid(np.arange(crop_size), np.arange(crop_size), indexing="xy")
    hxy = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)
    hraw = hxy @ K2mat_np(crop2raw).T.astype(np.float32)
    return hraw[..., 0], hraw[..., 1], hxy, hraw


@dataclass
class FramePack:
    """All per-frame tensors resampled into the crop frame."""

    img: np.ndarray  # (S,S,3) float16, 0-1
    mask: np.ndarray  # (S,S,2) bool: [mask, vis2d]
    depth: np.ndarray  # (S,S) float16
    crop2raw: np.ndarray  # (4,)
    is_detected: bool
    hxy: np.ndarray  # (S,S,3) crop pixel coords
    hraw: np.ndarray  # (S,S,3) raw pixel coords of crop pixels
    flow: Optional[np.ndarray] = None  # raw-frame uv resampled to crop grid
    occ: Optional[np.ndarray] = None
    extras: Dict[str, np.ndarray] = field(default_factory=dict)


def load_frame_pack(
    img_path: str,
    delta: int,
    crop_size: int,
    use_full: bool,
    with_flow: bool = True,
) -> FramePack:
    """Read one frame's rgb/mask/depth/flow and resample into its crop."""
    bgr = cv2.imread(img_path)
    img = bgr[..., ::-1].astype(np.float32) / 255.0
    shape = img.shape
    mask, vis2d, is_detected = load_mask(img_path, shape)
    if not is_detected:
        use_full = True
    crop2raw = compute_crop_params(mask, crop_size=crop_size, use_full=use_full)
    depth = load_depth(img_path, shape)

    map_x, map_y, hxy, hraw = crop_grid(crop2raw, crop_size)
    map_x, map_y = map_x.astype(np.float32), map_y.astype(np.float32)

    def lin(a):
        return cv2.remap(a.astype(np.float32), map_x, map_y, cv2.INTER_LINEAR)

    def near(a):
        return cv2.remap(a.astype(np.float32), map_x, map_y, cv2.INTER_NEAREST)

    pack = FramePack(
        img=lin(img).astype(np.float16),
        mask=np.stack([near(mask), near(vis2d)], -1).astype(bool),
        depth=lin(depth).astype(np.float16),
        crop2raw=crop2raw,
        is_detected=is_detected,
        hxy=hxy,
        hraw=hraw,
    )
    if with_flow:
        uv, occ = load_flow(img_path, delta, shape)
        pack.flow = lin(uv)
        pack.occ = lin(occ)
    return pack


def load_frame_data(
    img_path: str,
    crop_size: int,
    use_full: bool,
    component_id: int,
    with_flow: bool = False,
):
    """(rgb float, depth, bool mask of component, crop2raw) in crop frame."""
    pack = load_frame_pack(img_path, 1, crop_size, use_full, with_flow=with_flow)
    mask = pack.mask[..., 0].astype(int) == component_id
    if component_id > 0:
        mask = largest_component(mask)
    return (
        pack.img.astype(np.float32),
        pack.depth.astype(np.float32),
        mask,
        pack.crop2raw,
    )


# ---------------------------------------------------------------------------
# pairwise flow processing (crop-space flow + cycle uncertainty)
# ---------------------------------------------------------------------------


def _flow_to_crop_space(pack_src: FramePack, pack_dst: FramePack) -> np.ndarray:
    """Raw-frame flow at src crop pixels -> displacement in dst crop coords."""
    target_raw = pack_src.hraw[..., :2] + pack_src.flow
    hom = np.concatenate([target_raw, np.ones_like(target_raw[..., :1])], -1)
    raw2crop = np.linalg.inv(K2mat_np(pack_dst.crop2raw)).astype(np.float32)
    target_crop = hom @ raw2crop.T
    return target_crop  # (S,S,3); displacement = [..., :2] - hxy[..., :2]


def cycle_uncertainty(
    occ: np.ndarray,
    flow_crop: np.ndarray,
    roundtrip_xy: np.ndarray,
    hxy: np.ndarray,
) -> np.ndarray:
    """exp(-25 * cycle-error / (S/2)); zeroed when < 0.25 or occluded
    (reference: preprocess/libs/io.py:188-201)."""
    crop_size = occ.shape[0]
    back = backward_warp_image(roundtrip_xy, flow_crop)
    err = np.linalg.norm(back[..., :2] - hxy[..., :2], axis=-1)
    uct = np.exp(-25.0 * (err / crop_size * 2.0))
    uct[uct < 0.25] = 0.0
    uct[occ > 0] = 0.0
    return uct


def process_flow_pair(pack0: FramePack, pack1: FramePack):
    """Convert both packs' raw flow to crop space, attach cycle uncertainty,
    and store (S,S,3) float16 [u, v, uct] in pack.flow."""
    tgt1 = _flow_to_crop_space(pack0, pack1)  # frame0 px -> frame1 crop coords
    tgt0 = _flow_to_crop_space(pack1, pack0)
    lim = 4.0 * pack0.hxy.shape[0]  # keep values finite in float16
    flow0 = np.clip(tgt1[..., :2] - pack0.hxy[..., :2], -lim, lim).astype(np.float32)
    flow1 = np.clip(tgt0[..., :2] - pack1.hxy[..., :2], -lim, lim).astype(np.float32)
    uct0 = cycle_uncertainty(pack0.occ, flow0, tgt0[..., :2], pack0.hxy)
    uct1 = cycle_uncertainty(pack1.occ, flow1, tgt1[..., :2], pack1.hxy)
    pack0.flow = np.concatenate([flow0, uct0[..., None]], -1).astype(np.float16)
    pack1.flow = np.concatenate([flow1, uct1[..., None]], -1).astype(np.float16)


def mask_bbox(img_path: str, component_id: int) -> Optional[np.ndarray]:
    """Tight bbox [x0, y0, w, h] of a mask component at raw res, or None."""
    shape = cv2.imread(img_path).shape
    mask, _, _ = load_mask(img_path, shape)
    mask = mask == component_id
    if not mask.any():
        return None
    ys, xs = np.nonzero(mask)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min()])
