"""Text-prompt object selection over tracked mask components.

Parity target: the reference's preprocessing is driven by a text prompt
through GroundingDINO + Track-Anything (`scripts/run_preprocess.py:25-38`
in the reference). This environment has zero egress, so no open-vocab
grounding model can be downloaded; this module is the documented local
stand-in: the segmentation backend's foreground masks are decomposed
into connected components, tracked across frames by IoU, and scored
against a small attribute grammar grounded in measurable per-instance
features (color in HSV space, image position, relative size). The
external Track-Anything path, when installed, still takes precedence and
receives the raw prompt (seg_backends.run_segmentation).

Grammar (case-insensitive):
  colors:    red orange yellow green cyan blue purple violet magenta
             pink white black gray grey brown
  position:  left right top bottom center middle
  size:      large big largest biggest small little smallest tiny

Category words ("cat", "human", ... — the reference's primary usage)
are not groundable without an open-vocab model; a prompt containing ONLY
unrecognized words falls back to the dominant-object heuristic (most
persistent, then largest, track) — which matches what GroundingDINO
picks in the reference's single-subject tutorial videos.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

# hue centers on the OpenCV 0-180 hue circle
_HUES = {
    "red": 0.0,
    "orange": 12.0,
    "yellow": 25.0,
    "green": 55.0,
    "cyan": 90.0,
    "blue": 115.0,
    "purple": 135.0,
    "violet": 135.0,
    "magenta": 155.0,
    "pink": 165.0,
    "brown": 10.0,
}
_ACHROMATIC = ("white", "black", "gray", "grey")
_POSITIONS = ("left", "right", "top", "bottom", "center", "middle")
_SIZES_BIG = ("large", "big", "largest", "biggest")
_SIZES_SMALL = ("small", "little", "smallest", "tiny")


def parse_prompt(text: str) -> Dict:
    """Extract color / position / size attributes from a free-form prompt."""
    words = [w.strip(".,!?'\"").lower() for w in text.split()]
    spec = {"colors": [], "achromatic": [], "position": None, "size": None,
            "category_fallback": False}
    matched = False
    for w in words:
        if w in _HUES:
            spec["colors"].append(w)
        elif w in _ACHROMATIC:
            spec["achromatic"].append("gray" if w == "grey" else w)
        elif w in _POSITIONS:
            spec["position"] = "center" if w == "middle" else w
        elif w in _SIZES_BIG:
            spec["size"] = "large"
        elif w in _SIZES_SMALL:
            spec["size"] = "small"
        else:
            continue
        matched = True
    # a non-empty prompt with no recognized attribute is a category word
    # ("cat", "human"): fall back to the dominant object (see module doc)
    spec["category_fallback"] = bool(words) and not matched
    return spec


def _components(mask: np.ndarray, min_area: int = 16) -> List[np.ndarray]:
    """Connected components of a binary mask as boolean masks."""
    n, lab = cv2.connectedComponents((mask > 0).astype(np.uint8))
    out = []
    for i in range(1, n):
        m = lab == i
        if m.sum() >= min_area:
            out.append(m)
    return out


def track_components(masks: List[np.ndarray], min_area: int = 16,
                     iou_thresh: float = 0.1) -> List[List[Optional[np.ndarray]]]:
    """Greedy IoU tracking of per-frame components into instance tracks.

    Returns tracks: tracks[i][t] is instance i's bool mask at frame t (or
    None when unmatched)."""
    T = len(masks)
    tracks: List[List[Optional[np.ndarray]]] = []
    last: List[Optional[np.ndarray]] = []  # last seen mask per track
    for t, m in enumerate(masks):
        comps = _components(m, min_area)
        used = [False] * len(comps)
        for i, prev in enumerate(last):
            if prev is None:
                tracks[i].append(None)
                continue
            best, best_iou = -1, iou_thresh
            for j, c in enumerate(comps):
                if used[j]:
                    continue
                inter = np.logical_and(prev, c).sum()
                union = np.logical_or(prev, c).sum()
                iou = inter / max(union, 1)
                if iou > best_iou:
                    best, best_iou = j, iou
            if best >= 0:
                used[best] = True
                tracks[i].append(comps[best])
                last[i] = comps[best]
            else:
                tracks[i].append(None)
        for j, c in enumerate(comps):
            if not used[j]:
                tracks.append([None] * t + [c])
                last.append(c)
    for tr in tracks:
        tr.extend([None] * (T - len(tr)))
    return tracks


def _instance_features(frames, track) -> Optional[Dict]:
    """Mean HSV color, mean normalized centroid, mean area fraction."""
    hs, ss, vs, cxs, cys, areas = [], [], [], [], [], []
    for img, m in zip(frames, track):
        if m is None or not m.any():
            continue
        hsv = cv2.cvtColor(
            (np.asarray(img[..., :3], np.float32) * (
                255.0 if img.dtype != np.uint8 else 1.0
            )).astype(np.uint8),
            cv2.COLOR_RGB2HSV,
        )
        h, w = m.shape
        # circular hue mean
        hue = hsv[..., 0][m].astype(np.float64) * (np.pi / 90.0)
        hs.append(np.arctan2(np.sin(hue).mean(), np.cos(hue).mean())
                  % (2 * np.pi) * (90.0 / np.pi))
        ss.append(hsv[..., 1][m].mean() / 255.0)
        vs.append(hsv[..., 2][m].mean() / 255.0)
        ys, xs = np.nonzero(m)
        cxs.append(xs.mean() / w)
        cys.append(ys.mean() / h)
        areas.append(m.mean())
    if not areas:
        return None
    return dict(
        hue=float(np.mean(hs)), sat=float(np.mean(ss)),
        val=float(np.mean(vs)), cx=float(np.mean(cxs)),
        cy=float(np.mean(cys)), area=float(np.mean(areas)),
        presence=len(areas) / len(frames),
    )


def _hue_dist(a: float, b: float) -> float:
    """Circular distance on the 0-180 hue circle."""
    d = abs(a - b) % 180.0
    return min(d, 180.0 - d)


def _score(feat: Dict, spec: Dict, area_rank: float) -> float:
    """Higher = better match; attributes combine multiplicatively so a
    missing attribute never dominates."""
    s = feat["presence"]
    for cname in spec["colors"]:
        # chromatic colors need saturation; hue tolerance ~20 degrees
        s *= np.exp(-(_hue_dist(feat["hue"], _HUES[cname]) / 20.0) ** 2)
        s *= min(1.0, feat["sat"] / 0.25)
    for aname in spec["achromatic"]:
        s *= max(0.0, 1.0 - feat["sat"] / 0.3)  # unsaturated
        if aname == "white":
            s *= feat["val"]
        elif aname == "black":
            s *= 1.0 - feat["val"]
        else:  # gray
            s *= 1.0 - abs(feat["val"] - 0.5)
    pos = spec["position"]
    if pos is not None:
        if pos == "left":
            s *= 1.0 - feat["cx"]
        elif pos == "right":
            s *= feat["cx"]
        elif pos == "top":
            s *= 1.0 - feat["cy"]
        elif pos == "bottom":
            s *= feat["cy"]
        else:  # center
            s *= 1.0 - np.hypot(feat["cx"] - 0.5, feat["cy"] - 0.5)
    if spec["size"] == "large":
        s *= area_rank
    elif spec["size"] == "small":
        s *= 1.0 - area_rank
    if spec.get("category_fallback"):
        # dominant object: presence (already in s) breaks toward the
        # most persistent track; area_rank toward the largest
        s *= 0.5 + 0.5 * area_rank
    return float(s)


def select_by_prompt(
    frames: List[np.ndarray], masks: List[np.ndarray], text_prompt: str
) -> Tuple[List[np.ndarray], int]:
    """Keep only the tracked instance best matching the prompt.

    Args:
        frames: per-frame rgb images (H,W,3), uint8 or float [0,1]
        masks: per-frame binary/int foreground masks from a seg backend
        text_prompt: free-form prompt, see module grammar
    Returns:
        (selected int8 masks (1 = object, 0 = rest), instance index)
    """
    spec = parse_prompt(text_prompt)
    tracks = track_components(masks)
    if not tracks:
        return [np.zeros_like(np.asarray(m), np.int8) for m in masks], -1

    feats = [_instance_features(frames, tr) for tr in tracks]
    alive = [i for i, f in enumerate(feats) if f is not None]
    if not alive:
        return [np.zeros_like(np.asarray(m), np.int8) for m in masks], -1
    areas = np.array([feats[i]["area"] for i in alive])
    order = areas.argsort().argsort()  # rank 0 = smallest
    rank = {i: (order[k] / max(len(alive) - 1, 1))
            for k, i in enumerate(alive)}
    scores = {i: _score(feats[i], spec, rank[i]) for i in alive}
    best = max(scores, key=scores.get)
    out = [
        (np.zeros_like(np.asarray(m), np.int8) if tr is None
         else tr.astype(np.int8))
        for m, tr in zip(masks, tracks[best])
    ]
    return out, best
