"""Rendering CLI: reference-view and novel-view frames of a fitted model.

Port of lab4d_tpu/render.py on PyTorch: the same flag names and defaults
(from lab4d_tpu/config.py and lab4d_tpu/render.py), the same checkpoint
(`<logroot>/<seqname>-<logname>/ckpt_<load_suffix>.flax`, written by the
JAX trainer) and the same outputs under
`<logroot>/<seqname>-<logname>/renderings_<inst>/<viewpoint>/`.

    python -m lab4d_tpu_torch.render --seqname cat --logname run \\
        --fg_motion skel-quad --load_suffix latest --render_res 512

Rendering uses the exact merged two-pass eval (the JAX CLI's
`--eval_topk 0`). Top-k eval and channel subsets are not ported yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from lab4d_tpu_torch.bridge import load_flax_checkpoint, params_from_flax
from lab4d_tpu_torch.dataloader import data_utils
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.utils import cam_traj as C
from lab4d_tpu_torch.utils.geom import K2inv, K2mat, mat2K

# rays per evaluate_rays call at 512^2: sized so the activations of the
# normal-gradient pass (both halves of 64 samples per ray) stay a few GB
DEFAULT_CHUNK = 16384


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seqname", default="cat", help="name of the sequence")
    p.add_argument("--logname", default="tmp", help="name of the saved log")
    p.add_argument("--load_suffix", default="", help="suffix of params, {latest, 0, 10, ...}")
    p.add_argument("--logroot", default="logdir/", help="root directory for log files")
    p.add_argument("--database_root", default="database",
                   help="root of preprocessed dataset + configs")
    p.add_argument("--data_prefix", default="crop", help="prefix of the data entries")
    p.add_argument("--train_res", type=int, default=256, help="size of training images")
    p.add_argument("--feature_type", default="dinov2", help="{dinov2, cse}")
    p.add_argument("--field_type", default="fg", help="{bg, fg, comp}; only fg is ported")
    p.add_argument("--fg_motion", default="rigid",
                   help="{rigid, dense, bob, skel-human, skel-quad}; only skel-quad is ported")
    p.add_argument("--inst_id", type=int, default=0, help="video/instance id")
    p.add_argument("--render_res", type=int, default=128, help="rendering resolution")
    p.add_argument("--viewpoint", default="ref",
                   help="camera viewpoint, {ref, rot-elev-deg, bev-elev}")
    p.add_argument("--freeze_id", type=int, default=-1, help="freeze frame id to render, -1=off")
    p.add_argument("--num_frames", type=int, default=-1,
                   help="frames to render if freeze_id used")
    p.add_argument("--noskip", action="store_true", help="render all frames skipped by flow")
    p.add_argument("--render_keys", default="",
                   help="channel subset to render; only '' (every channel) is ported")
    p.add_argument("--eval_topk", type=int, default=0,
                   help="per-ray sample budget of the heavy eval channels; only 0 "
                        "(exact every-sample evaluation) is ported")
    p.add_argument("--device", default="cuda", help="torch device to render on")
    return p


def check_opts(opts: Dict):
    if opts["eval_topk"] != 0:
        raise NotImplementedError(
            "--eval_topk > 0 (query_field_eval_topk) is not ported yet (ROADMAP.md, P8)"
        )
    if opts["render_keys"]:
        raise NotImplementedError("--render_keys is not ported yet (ROADMAP.md, P8)")


def construct_test_model(opts: Dict, device):
    """Model from the dataset metadata + the JAX trainer's checkpoint.
    Returns (model, geo_state, data_info)."""
    data_info = data_utils.get_data_info(data_utils.config_to_datasets(opts))
    model = DVRModel(data_info["frame_info"], field_type=opts["field_type"],
                     fg_motion=opts["fg_motion"], num_inst=1)
    path = "%s/%s-%s/ckpt_%s.flax" % (
        opts["logroot"], opts["seqname"], opts["logname"], opts["load_suffix"]
    )
    ckpt = load_flax_checkpoint(path)
    model.load_state_dict(params_from_flax(ckpt["model"]))
    model.to(device).eval().requires_grad_(False)
    return model, ckpt["geo_state"], data_info


def construct_batch_from_opts(opts: Dict, model: DVRModel, geo_state, data_info, device):
    """Render batch for the selected viewpoint; returns (batch, raw_size)."""
    video_id = opts["inst_id"]
    raw_size = data_info["raw_size"][video_id]
    vid_length = data_utils.get_vid_length(video_id, data_info)
    frame_info = data_info["frame_info"]
    if opts["freeze_id"] == -1:
        if opts["noskip"]:
            frameid_sub = np.arange(vid_length)
        else:
            off = frame_info.frame_offset
            frameid = frame_info.frame_mapping[off[video_id] : off[video_id + 1]]
            frameid_sub = frameid - frame_info.frame_offset_raw[video_id]
    elif 0 <= opts["freeze_id"] < vid_length:
        num_frames = vid_length if opts["num_frames"] <= 0 else opts["num_frames"]
        frameid_sub = np.asarray([opts["freeze_id"]] * num_frames)
    else:
        raise ValueError("frame id %d out of range" % opts["freeze_id"])
    render_length = len(frameid_sub)
    frameid = torch.as_tensor(frameid_sub + frame_info.frame_offset_raw[video_id], device=device)

    with torch.no_grad():
        field2cam_fr = {k: v.cpu().numpy() for k, v in model.fields.get_cameras(frameid).items()}
        intrinsics_fr = model.intrinsics.get_vals(frameid)
        logscales = {k: v.item() for k, v in model.fields.get_logscales().items()}
    aabb = {c: np.asarray(geo_state[c]["aabb"]) / logscales[c] for c in geo_state}

    viewpoint = opts["viewpoint"]
    if viewpoint == "ref":
        field2cam = None
        scale = torch.zeros((render_length, 4), device=device)
        scale[:, 0] = raw_size[1] / opts["render_res"]
        scale[:, 1] = raw_size[0] / opts["render_res"]
        camera_int = mat2K(K2inv(scale) @ K2mat(intrinsics_fr)).cpu().numpy()
    elif viewpoint.startswith("rot"):
        elev, max_angle = [int(v) for v in viewpoint.split("-")[1:]]
        obj_size = (aabb["fg"][1] - aabb["fg"][0]).max()
        traj = C.get_rotating_cam(render_length, distance=obj_size * 2.5, max_angle=max_angle)
        elev_mat = C.get_object_to_camera_matrix(elev, [1, 0, 0], 0)[None]
        field2cam = C.create_field2cam(traj @ elev_mat, field2cam_fr.keys())
        camera_int = np.zeros((render_length, 4))
        camera_int[:, :2] = opts["render_res"] * 2 * 0.8
        camera_int[:, 2:] = opts["render_res"] / 2
        raw_size = (640, 640)
    elif viewpoint.startswith("bev"):
        elev = int(viewpoint.split("-")[1])
        field2cam = {"fg": C.get_bev_cam(field2cam_fr["fg"], elev=elev)}
        camera_int = np.zeros((render_length, 4))
        camera_int[:, :2] = opts["render_res"] * 2
        camera_int[:, 2:] = opts["render_res"] / 2
        raw_size = (640, 640)
    else:
        raise ValueError("Unknown viewpoint %s" % viewpoint)

    batch = C.construct_batch(
        inst_id=opts["inst_id"], frameid_sub=frameid_sub, eval_res=opts["render_res"],
        field2cam=field2cam, camera_int=camera_int, crop2raw=None, device=device,
    )
    return batch, raw_size


def render_batch(model: DVRModel, batch, geo_state, chunk: int = DEFAULT_CHUNK):
    """Render the batch frame by frame, `chunk` rays per evaluate_rays
    call. Returns {channel: (frames, res, res, C) float32 numpy}; every
    non-mask channel is already mask-blended by evaluate_rays."""
    device = batch["hxy"].device
    geo = {
        cate: {
            "aabb": torch.tensor(np.asarray(g["aabb"], np.float32), device=device),
            "proxy_corners": torch.tensor(np.asarray(g["corners"], np.float32), device=device),
        }
        for cate, g in geo_state.items()
    }
    n_frames = len(batch["frameid_sub"])
    frames: Dict[str, list] = {}
    start = time.time()
    with torch.no_grad():
        for i in range(n_frames):
            sub = {
                k: ({k2: v2[i : i + 1] for k2, v2 in v.items()} if isinstance(v, dict)
                    else v[i : i + 1])
                for k, v in batch.items()
            }
            sub["geo"] = geo
            samples = model.prepare_eval_samples(sub)
            hxy = sub["hxy"]
            npix = hxy.shape[1]
            outs: Dict[str, list] = {}
            for s in range(0, npix, chunk):
                samples_c = {c: {**samples[c], "hxy": hxy[:, s : s + chunk]} for c in samples}
                for k, v in model.evaluate_rays(samples_c).items():
                    if v.ndim >= 3:  # (1, rays, C) image channels
                        outs.setdefault(k, []).append(v[0])
            res = int(round(np.sqrt(npix)))
            for k, v in outs.items():
                img = torch.cat(v, dim=0).reshape(res, res, -1)
                frames.setdefault(k, []).append(img.float().cpu().numpy())
    print("rendering time: %.3f s (%d frames)" % (time.time() - start, n_frames))
    return {k: np.stack(v) for k, v in frames.items()}


def render(opts: Dict):
    from lab4d_tpu.utils.io import make_save_dir, save_rendered

    check_opts(opts)
    device = torch.device(opts["device"])
    model, geo_state, data_info = construct_test_model(opts, device)
    batch, raw_size = construct_batch_from_opts(opts, model, geo_state, data_info, device)
    save_dir = make_save_dir(opts, sub_dir="renderings_%04d/%s" % (opts["inst_id"], opts["viewpoint"]))
    rendered = render_batch(model, batch, geo_state)
    save_rendered(rendered, save_dir, raw_size, data_info["apply_pca_fn"])
    print("Saved to %s" % save_dir)
    return rendered


def main(argv=None):
    return render(vars(get_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
