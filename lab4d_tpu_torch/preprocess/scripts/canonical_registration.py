"""Canonical registration: estimate per-frame object-canonical-to-camera
rotations for the fg field's camera prior, Cameras/<seq>/01-canonical.npy
(port of preprocess/scripts/canonical_registration.py).

Rotation priors come from, in order of preference:
  1. manual annotations  Cameras/<seq>/01-manual.json  {frame: 4x4 list}
  2. the CSE viewpoint plugin (a `cse_viewpoint` module) when importable
  3. the viewpoint CNN (backends/viewpoint_net.py) when its weights load
  4. none — the Procrustes chain alone, gauge-fixed at frame 0
fused with the pairwise relative-rotation chain by the fit in
libs/registration.py, on the device. Translations use the bbox
heuristic: depth = focal / sqrt(bbox area) (unit surface area), xy from
the bbox center ray, z capped at 10.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import cv2
import numpy as np

from lab4d_tpu_torch.preprocess.libs.io import frame_list, mask_bbox
from lab4d_tpu_torch.preprocess.libs.registration import fit_canonical_rotations

DEFAULT_DEPTH = 3.0
MAX_DEPTH = 10.0


def load_rotation_priors(seqname, outdir, obj_class, img_paths, device=None):
    """({frame: rotation}, the source's name: "manual", "cse", "net" or
    "none")."""
    cam_dir = f"{outdir}/Cameras/Full-Resolution/{seqname}"
    manual = f"{cam_dir}/01-manual.json"
    if obj_class == "other" or os.path.exists(manual):
        with open(manual) as f:
            raw = json.load(f)
        return {int(k): np.asarray(v, np.float32) for k, v in raw.items()}, "manual"
    if importlib.util.find_spec("cse_viewpoint") is not None:
        import cse_viewpoint  # a plugin, installed beside the port

        rots = cse_viewpoint.predict_viewpoints(img_paths, obj_class)
        return {i: np.asarray(r, np.float32) for i, r in enumerate(rots)}, "cse"
    from lab4d_tpu_torch.preprocess.backends import viewpoint_net

    model = viewpoint_net.load_model(obj_class, device=device)
    if model is not None:
        rots = viewpoint_net.predict_viewpoints(img_paths, obj_class, model=model,
                                                device=device)
        return {i: np.asarray(r, np.float32) for i, r in rots.items()}, "net"
    return {}, "none"


def canonical_registration(
    seqname: str,
    crop_size: int,
    obj_class: str,
    component_id: int = 1,
    outdir: str = "database/processed",
    device=None,
):
    """Writes 01-canonical.npy (and its cameras .obj); returns the cameras
    and the source of the rotation priors."""
    from lab4d_tpu_torch.preprocess import resolve_device

    device = resolve_device(device)
    img_paths = frame_list(outdir, seqname)
    cam_dir = f"{outdir}/Cameras/Full-Resolution/{seqname}"
    cams_chain = np.load(f"{cam_dir}/{component_id:02d}.npy")

    priors, source = load_rotation_priors(seqname, outdir, obj_class, img_paths, device)
    print(f"canonical registration: {len(priors)} annotated frames ({source})")
    rots, stops = fit_canonical_rotations(cams_chain, priors, device=device)
    print(f"canonical registration: the fit's phases stopped at iterations {stops}")

    cams = np.tile(np.eye(4, dtype=np.float32), (len(img_paths), 1, 1))
    cams[:, :3, :3] = rots[: len(img_paths)]
    cams[:, 2, 3] = DEFAULT_DEPTH

    # translation from the detection bbox (unit object surface area)
    for t, path in enumerate(img_paths):
        bbox = mask_bbox(path, component_id)
        if bbox is None or bbox[2] * bbox[3] == 0:
            continue
        shape = cv2.imread(path).shape[:2]
        focal = max(shape)
        depth = min(focal / np.sqrt(bbox[2] * bbox[3]), MAX_DEPTH)
        center = bbox[:2] + bbox[2:] / 2.0
        cams[t, :2, 3] = depth * (center - np.array(shape[::-1]) / 2.0) / focal
        cams[t, 2, 3] = depth

    np.save(f"{cam_dir}/{component_id:02d}-canonical.npy", cams)

    from lab4d_tpu_torch.utils.vis import draw_cams

    draw_cams(cams).export(
        f"{cam_dir}/cameras-{component_id:02d}-canonical.obj"
    )
    print(f"canonical registration (crop_size={crop_size}) done: {seqname}")
    return cams, source


if __name__ == "__main__":
    canonical_registration(sys.argv[1], int(sys.argv[2]), sys.argv[3])
