"""Segmentation backends: per-frame object masks for a video (port of
preprocess/backends/seg_backends.py).

  unet      — the video segmentation U-Net with a previous-mask
              conditioning channel (seg_unet.py); auto-selected when its
              weights, which ship in database/weights/, load
  grabcut   — classical fallback: motion-residual seeding (dominant-affine
              background flow model) + cv2.grabCut colour refinement,
              propagated frame-to-frame through the classical flow
  full      — everything is foreground (rigid-scene setups)

(The JAX package's Track-Anything CLI backend is not part of the port.)
Output contract (consumed by libs/io.py load_mask): one int npy per
frame, 0 = background, 1 = foreground, all -1 = no detection.
"""

from __future__ import annotations

import os
from typing import List, Optional

import cv2
import numpy as np


def _dominant_affine_residual(flow: np.ndarray) -> np.ndarray:
    """Fit flow with a 6-dof affine model (least squares over all pixels,
    one reweighted refinement) and return per-pixel residual magnitude."""
    h, w = flow.shape[:2]
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    A = np.stack(
        [xx.ravel() / w, yy.ravel() / h, np.ones(h * w)], -1
    ).astype(np.float64)
    uv = flow[..., :2].reshape(-1, 2).astype(np.float64)
    weights = np.ones(h * w)
    for _ in range(3):
        Aw = A * weights[:, None]
        coef, *_ = np.linalg.lstsq(Aw.T @ A, Aw.T @ uv, rcond=None)
        resid = np.linalg.norm(uv - A @ coef, axis=-1)
        sigma = max(np.median(resid) * 1.5, 1e-3)
        weights = 1.0 / (1.0 + (resid / sigma) ** 2)
    return resid.reshape(h, w).astype(np.float32)


def _grabcut_refine(
    rgb_u8: np.ndarray,
    seed_fg: np.ndarray,
    seed_bg: np.ndarray,
    iters: int = 3,
    seed_fg_sure: Optional[np.ndarray] = None,
) -> np.ndarray:
    """GrabCut boundary refinement around motion seeds; returns bool mask.

    seed_fg_sure pixels are pinned (GC_FGD) so overlapping color models
    can't erase the motion evidence; GrabCut only refines the rim.
    """
    gc_mask = np.full(rgb_u8.shape[:2], cv2.GC_PR_BGD, np.uint8)
    gc_mask[seed_fg] = cv2.GC_PR_FGD
    gc_mask[seed_bg] = cv2.GC_BGD
    if seed_fg_sure is not None:
        gc_mask[seed_fg_sure] = cv2.GC_FGD
    if not seed_fg.any():
        return np.zeros(rgb_u8.shape[:2], bool)
    bgd, fgd = np.zeros((1, 65), np.float64), np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(
            rgb_u8[..., ::-1].copy(), gc_mask, None, bgd, fgd, iters,
            cv2.GC_INIT_WITH_MASK,
        )
    except cv2.error:
        return seed_fg
    return (gc_mask == cv2.GC_FGD) | (gc_mask == cv2.GC_PR_FGD)


def segment_video_grabcut(frames: List[np.ndarray], res: int = 288, device=None):
    """Motion-seeded GrabCut over a video. frames: list of uint8 RGB.

    Returns list of int masks at each frame's raw resolution.
    """
    from lab4d_tpu_torch.preprocess.backends.flow_classical import compute_pair_flow

    n = len(frames)
    masks_small: List[Optional[np.ndarray]] = [None] * n
    prev_mask = None
    for i in range(n):
        img_small = cv2.resize(frames[i], (res, res), interpolation=cv2.INTER_AREA)
        if i + 1 < n:
            fw, _ = compute_pair_flow(frames[i], frames[i + 1], res=res, device=device)
        else:
            fw = None
        if fw is not None:
            resid = _dominant_affine_residual(fw)
            thresh = max(np.percentile(resid, 75) * 1.5, 0.5)
            moving = resid > thresh
        else:
            moving = np.zeros((res, res), bool)
        if prev_mask is not None:
            moving = moving | prev_mask
        # clean seeds: drop specks, erode to high-confidence core
        moving_u8 = cv2.morphologyEx(
            moving.astype(np.uint8), cv2.MORPH_OPEN, np.ones((3, 3), np.uint8)
        )
        seed_fg = moving_u8.astype(bool)
        seed_core = cv2.erode(moving_u8, np.ones((5, 5), np.uint8)).astype(bool)
        seed_bg = ~cv2.dilate(moving_u8, np.ones((15, 15), np.uint8)).astype(bool)
        mask = _grabcut_refine(img_small, seed_fg, seed_bg, seed_fg_sure=seed_core)
        # keep the largest component for stability
        if mask.any():
            num, labels = cv2.connectedComponents(mask.astype(np.uint8))
            if num > 2:
                counts = np.bincount(labels.ravel())
                counts[0] = 0
                mask = labels == counts.argmax()
        masks_small[i] = mask
        # propagate through flow for the next frame's prior
        if fw is not None and mask.any():
            xx, yy = np.meshgrid(np.arange(res), np.arange(res))
            tx = np.clip((xx + fw[..., 0]).round().astype(int), 0, res - 1)
            ty = np.clip((yy + fw[..., 1]).round().astype(int), 0, res - 1)
            prop = np.zeros((res, res), bool)
            prop[ty[mask], tx[mask]] = True
            prev_mask = cv2.dilate(
                prop.astype(np.uint8), np.ones((3, 3), np.uint8)
            ).astype(bool)
        else:
            prev_mask = mask

    out = []
    for i, m in enumerate(masks_small):
        h, w = frames[i].shape[:2]
        full = cv2.resize(m.astype(np.uint8), (w, h), interpolation=cv2.INTER_NEAREST)
        out.append(full.astype(np.int8))
    return out


def segment_video_full(frames: List[np.ndarray]):
    """Everything-foreground fallback."""
    return [np.ones(f.shape[:2], np.int8) for f in frames]


def pick_seg_backend() -> str:
    """Explicit env override, else unet when its weights load, else grabcut."""
    choice = os.environ.get("LAB4D_SEG_BACKEND", "auto")
    if choice != "auto":
        return choice
    from lab4d_tpu_torch.preprocess.backends import seg_unet

    return "unet" if seg_unet.available() else "grabcut"


def run_segmentation(seqname: str, outdir: str, text_prompt: str = "", device=None):
    """Write Annotations/<seq>/%05d.npy masks using the selected backend."""
    import glob as _glob

    backend = pick_seg_backend()
    img_paths = sorted(
        _glob.glob(f"{outdir}/JPEGImages/Full-Resolution/{seqname}/*.jpg")
    )
    out_dir = f"{outdir}/Annotations/Full-Resolution/{seqname}"
    os.makedirs(out_dir, exist_ok=True)

    frames = [cv2.imread(p)[..., ::-1] for p in img_paths]
    if backend == "full":
        masks = segment_video_full(frames)
    elif backend == "unet":
        from lab4d_tpu_torch.preprocess.backends.seg_unet import segment_video_unet

        masks = segment_video_unet(frames, device=device)
    elif backend == "grabcut":
        masks = segment_video_grabcut(frames, device=device)
    else:
        raise ValueError(f"LAB4D_SEG_BACKEND={backend!r}: not one of unet, grabcut, full")
    if text_prompt.strip():
        # prompt-grounded instance selection over the tracked components
        # (see backends/prompt_select.py)
        from lab4d_tpu_torch.preprocess.backends.prompt_select import select_by_prompt

        masks, inst = select_by_prompt(frames, masks, text_prompt)
        print(f"prompt {text_prompt!r}: selected instance {inst}")
    for p, m in zip(img_paths, masks):
        if not (m > 0).any():
            m = np.full_like(m, -1)  # undetected-frame convention
        np.save(f"{out_dir}/{os.path.basename(p).replace('.jpg', '.npy')}", m)
    print(f"segmentation ({backend}) done: {seqname}")
    return backend
