"""The reference's frames: the render CLI's reference-view batch and its
frame loop (the program's render.py construct_batch_from_opts and
render_batch), over lab4d_ref's model."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.lab4d_ref.utils.geom import K2inv, K2mat, mat2K


def xy_grid(res: int) -> np.ndarray:
    """(res*res, 3) homogeneous pixel coordinates, x fastest."""
    x, y = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    return np.stack([x.reshape(-1), y.reshape(-1), np.ones(res * res)], -1).astype(np.float32)


def ref_view_batch(model, raw_size, res: int, device) -> Dict:
    """The batch of every frame of video 0 in the reference view at res^2."""
    fi = model.frame_info
    frameid_sub = fi.frame_mapping[fi.frame_offset[0]:fi.frame_offset[1]] - fi.frame_offset_raw[0]
    n = len(frameid_sub)
    frameid = torch.as_tensor(frameid_sub + fi.frame_offset_raw[0], device=device)
    with torch.no_grad():
        intrinsics = model.intrinsics.get_vals(frameid)
    scale = torch.zeros((n, 4), device=device)
    scale[:, 0] = raw_size[1] / res
    scale[:, 1] = raw_size[0] / res
    camera_int = mat2K(K2inv(scale) @ K2mat(intrinsics))
    sub = torch.as_tensor(np.asarray(frameid_sub, np.int64), device=device)
    return {
        "frameid_sub": sub,
        "dataid": torch.zeros_like(sub),
        "hxy": torch.as_tensor(xy_grid(res), device=device)[None].repeat(n, 1, 1),
        "Kinv": K2inv(camera_int.float()),
    }


def render_frame(model, batch, geo_state, i: int, chunk: int, topk=None) -> Dict[str, np.ndarray]:
    """Frame i of the batch: {channel: (res, res, C) float32}."""
    device = batch["hxy"].device
    geo = {cate: {"aabb": torch.tensor(np.asarray(g["aabb"], np.float32), device=device),
                  "proxy_corners": torch.tensor(np.asarray(g["corners"], np.float32),
                                                device=device)}
           for cate, g in geo_state.items()}
    sub = {k: v[i : i + 1] for k, v in batch.items()}
    sub["geo"] = geo
    with torch.no_grad():
        samples = model.prepare_eval_samples(sub)
        hxy = sub["hxy"]
        npix = hxy.shape[1]
        outs: Dict[str, list] = {}
        for s in range(0, npix, chunk):
            samples_c = {c: {**samples[c], "hxy": hxy[:, s : s + chunk]} for c in samples}
            for k, v in model.evaluate_rays(samples_c, topk=topk).items():
                if v.ndim >= 3:
                    outs.setdefault(k, []).append(v[0])
    res = int(round(np.sqrt(npix)))
    return {k: torch.cat(v, 0).reshape(res, res, -1).float().cpu().numpy() for k, v in outs.items()}
