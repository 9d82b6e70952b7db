"""Rendering CLI: reference-view and novel-view frames of a fitted model.

Port of lab4d_tpu/render.py on PyTorch: the same flag names and defaults
(from lab4d_tpu/config.py and lab4d_tpu/render.py), the same checkpoint
(`<logroot>/<seqname>-<logname>/ckpt_<load_suffix>.flax`, written by the
JAX trainer) and the same outputs under
`<logroot>/<seqname>-<logname>/renderings_<inst>/<viewpoint>/`.

    python -m lab4d_tpu_torch.render --seqname cat --logname run \\
        --fg_motion skel-quad --load_suffix latest --render_res 512

As in the JAX CLI, the heavy channels run at the 8 highest-weight samples
of each ray by default (`--eval_topk 8`; 0: the exact every-sample eval),
and `--render_keys` renders a subset of the channels. `--flagfile` reads a
run's opts.log (flagfile.py), as the JAX CLI does. reanimate.py renders
through `render` with its own batch.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from lab4d_tpu_torch.bridge import load_flax_checkpoint, params_from_flax
from lab4d_tpu_torch.dataloader import data_utils
from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.flagfile import (add_config_flags, add_flagfile_option, parse_opts,
                                      validate_opts)
from lab4d_tpu_torch.utils import cam_traj as C
from lab4d_tpu_torch.utils.geom import K2inv, K2mat, mat2K
from lab4d_tpu_torch.utils.io import make_save_dir, save_rendered

# rays per evaluate_rays call at 512^2, by eval mode. Exact: sized so the
# activations of the normal-gradient pass (both halves of 64 samples per
# ray) stay a few GB. Top-k: its 64-sample pass keeps no gradient and its
# heavy pass holds 8 samples per ray (PERF.md: the chunk sweeps of
# tools/profile_render.py)
DEFAULT_CHUNK = 16384
TOPK_CHUNK = 65536


def common_parser(description: str) -> argparse.ArgumentParser:
    """The flags the render, export and reanimate CLIs share: the run, its
    checkpoint, the dataset, the model and the device, and every other
    training flag of lab4d_tpu/config.py (taken and unused, as the JAX
    package's apps take them)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--seqname", default="cat", help="name of the sequence")
    p.add_argument("--logname", default="tmp", help="name of the saved log")
    p.add_argument("--load_suffix", default="", help="suffix of params, {latest, 0, 10, ...}")
    p.add_argument("--logroot", default="logdir/", help="root directory for log files")
    p.add_argument("--database_root", default="database",
                   help="root of preprocessed dataset + configs")
    p.add_argument("--data_prefix", default="crop", help="prefix of the data entries")
    p.add_argument("--train_res", type=int, default=256, help="size of training images")
    p.add_argument("--feature_type", default="dinov2", help="{dinov2, cse}")
    p.add_argument("--field_type", default="fg", help="{bg, fg, comp}")
    p.add_argument("--fg_motion", default="rigid",
                   help="{rigid, dense, nvp, bob, skel-human, skel-quad, "
                        "comp_skel-human_dense, comp_skel-quad_dense}")
    p.add_argument("--single_inst", action=argparse.BooleanOptionalAction, default=True,
                   help="assume the same morphology over objs (--nosingle_inst: a "
                        "multi-video category model, one instance code per video)")
    p.add_argument("--inst_id", type=int, default=0, help="video/instance id")
    p.add_argument("--device", default="cuda", help="torch device to run on")
    p.add_argument("--use_cpu", action=argparse.BooleanOptionalAction, default=False,
                   help="run on the CPU (the same as --device cpu)")
    add_flagfile_option(p)
    add_config_flags(p)
    return p


def get_parser() -> argparse.ArgumentParser:
    p = common_parser(__doc__.split("\n")[0])
    p.add_argument("--render_res", type=int, default=128, help="rendering resolution")
    p.add_argument("--viewpoint", default="ref",
                   help="camera viewpoint, {ref, rot-elev-deg, bev-elev}")
    p.add_argument("--freeze_id", type=int, default=-1, help="freeze frame id to render, -1=off")
    p.add_argument("--num_frames", type=int, default=-1,
                   help="frames to render if freeze_id used")
    p.add_argument("--noskip", action="store_true", help="render all frames skipped by flow")
    p.add_argument("--render_keys", default="",
                   help="comma-separated channel subset to render (e.g. rgb,depth,mask,"
                        "normal); '' renders every channel. Restricting channels skips "
                        "their producers (feature/vis MLPs, cycle warp, the normal-gradient "
                        "pass)")
    p.add_argument("--eval_topk", type=int, default=8,
                   help="per-ray sample budget for the heavy eval channels: density and the "
                        "integration weights still use all 64 union samples, heavy heads "
                        "(rgb/vis/feature/normal vjp/cycle) run only at the top-k weighted "
                        "samples. 0 = exact every-sample evaluation (the reference's "
                        "behavior). Approximation error is bounded by the dropped "
                        "integration mass")
    return p


def eval_mode(opts: Dict):
    """(topk, channels) of evaluate_rays from --eval_topk and --render_keys."""
    topk = opts["eval_topk"] if opts["eval_topk"] > 0 else None
    keys = frozenset(k.strip() for k in opts["render_keys"].split(",") if k.strip())
    return topk, keys or None


def construct_test_model(opts: Dict, device):
    """Model from the dataset metadata + a trainer's checkpoint (either
    package's), with one instance or (--nosingle_inst) one per video.
    Returns (model, geo_state, data_info)."""
    data_info = data_utils.get_data_info(data_utils.config_to_datasets(opts, is_eval=True))
    frame_info = data_info["frame_info"]
    model = DVRModel(frame_info, field_type=opts["field_type"], fg_motion=opts["fg_motion"],
                     num_inst=1 if opts["single_inst"] else frame_info.num_vids, device=device)
    path = "%s/%s-%s/ckpt_%s.flax" % (
        opts["logroot"], opts["seqname"], opts["logname"], opts["load_suffix"]
    )
    ckpt = load_flax_checkpoint(path)
    model.load_state_dict(params_from_flax(ckpt["model"]))
    model.to(device).eval().requires_grad_(False)
    return model, ckpt["geo_state"], data_info


def construct_batch_from_opts(opts: Dict, model: DVRModel, geo_state, data_info, device):
    """Render batch for the selected viewpoint; returns (batch, raw_size).
    The frames are those of video opts["motion_id"] where it is given
    (reanimation), else of opts["inst_id"]."""
    video_id = opts.get("motion_id", opts["inst_id"])
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
        if "bg" in field2cam_fr:
            # above the first frame's camera, looking down at the scene's centre
            center_to_bev = C.get_object_to_camera_matrix(elev, [1, 0, 0], 0)[None]
            camt0_to_center = np.eye(4)
            camt0_to_center[2, 3] = -field2cam_fr["bg"][0, 2, 3]
            camt0_to_bev = np.linalg.inv(camt0_to_center) @ center_to_bev @ camt0_to_center
            bg2bev = camt0_to_bev @ field2cam_fr["bg"][:1]
            bg2bev[..., 2, 3] *= 3
            field2cam = {"bg": np.tile(bg2bev, (render_length, 1, 1))}
            if "fg" in field2cam_fr:  # comp: the fg keeps its pose relative to the bg
                camt2bg = np.linalg.inv(field2cam_fr["bg"])
                field2cam["fg"] = field2cam["bg"] @ camt2bg @ field2cam_fr["fg"]
        else:
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


def render_batch(model: DVRModel, batch, geo_state, chunk: Optional[int] = None,
                 topk: Optional[int] = None, channels=None):
    """Render the batch frame by frame, `chunk` rays per evaluate_rays
    call (None: the eval mode's DEFAULT_CHUNK or TOPK_CHUNK); topk and
    channels: evaluate_rays'. Returns {channel: (frames, res, res, C)
    float32 numpy}; every non-mask channel is already mask-blended by
    evaluate_rays."""
    if chunk is None:
        chunk = TOPK_CHUNK if topk is not None else DEFAULT_CHUNK
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
                for k, v in model.evaluate_rays(samples_c, topk=topk, channels=channels).items():
                    if v.ndim >= 3:  # (1, rays, C) image channels
                        outs.setdefault(k, []).append(v[0])
            res = int(round(np.sqrt(npix)))
            for k, v in outs.items():
                img = torch.cat(v, dim=0).reshape(res, res, -1)
                frames.setdefault(k, []).append(img.float().cpu().numpy())
    print("rendering time: %.3f s (%d frames)" % (time.time() - start, n_frames))
    return {k: np.stack(v) for k, v in frames.items()}


def render(opts: Dict, construct_batch_func=construct_batch_from_opts):
    """Render the run's checkpoint into renderings_<inst_id>/<viewpoint>/;
    construct_batch_func(opts, model, geo_state, data_info, device) ->
    (batch, raw_size) builds the frames' batch."""
    device = torch.device(opts["device"])
    model, geo_state, data_info = construct_test_model(opts, device)
    batch, raw_size = construct_batch_func(opts, model, geo_state, data_info, device)
    save_dir = make_save_dir(opts, sub_dir="renderings_%04d/%s" % (opts["inst_id"], opts["viewpoint"]))
    topk, channels = eval_mode(opts)
    rendered = render_batch(model, batch, geo_state, topk=topk, channels=channels)
    save_rendered(rendered, save_dir, raw_size, data_info["apply_pca_fn"])
    print("Saved to %s" % save_dir)
    return rendered


def main(argv=None):
    opts = parse_opts(get_parser(), argv)
    validate_opts(opts)
    return render(opts)


if __name__ == "__main__":
    main()
