"""Export CLI: canonical meshes, per-frame articulated meshes, bone
meshes and the motion parameters (fg-motion.json) that reanimate.py reads.

Port of lab4d_tpu/export.py on PyTorch, with the same flags and outputs
under `<logroot>/<seqname>-<logname>/export_<inst_id>/`: `<cate>.obj`
(the rest mesh), `<cate>-%05d.obj` (the mesh at each frame),
`<cate>-%05d-bone.obj` (the bones at each frame, skinning warps only) and
`<cate>-motion.json` with `field2cam`, `t_articulation` and `joint_so3`.

    python -m lab4d_tpu_torch.export --seqname cat --logname run \\
        --fg_motion skel-quad --load_suffix latest --grid_size 128

The canonical SDF grid runs through the fused Fourier MLP kernel (K4f) on
the card, the per-frame cameras and articulations through the TimeMLP
kernel (K3f); the frames are exported one at a time.
"""

from __future__ import annotations

import json
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lab4d_tpu_torch.engine.model import DVRModel
from lab4d_tpu_torch.flagfile import parse_opts, validate_opts
from lab4d_tpu_torch.meshlib import Mesh
from lab4d_tpu_torch.meshlib.marching import marching_cubes
from lab4d_tpu_torch.render import common_parser, construct_test_model
from lab4d_tpu_torch.utils.io import make_save_dir
from lab4d_tpu_torch.utils.quat import (
    dual_quaternion_to_quaternion_translation,
    dual_quaternion_to_se3,
    quaternion_translation_to_se3,
)
from lab4d_tpu_torch.utils.vis import draw_skeleton_bones


def get_parser():
    p = common_parser(__doc__.split("\n")[0])
    p.add_argument("--grid_size", type=int, default=128, help="grid size of marching cubes")
    p.add_argument("--level", type=float, default=0.0,
                   help="contour value of marching cubes isosurface")
    return p


class MotionParamsExpl(NamedTuple):
    field2cam: Tuple[np.ndarray, np.ndarray]  # (quat, trans), world units
    t_articulation: Optional[Tuple[np.ndarray, np.ndarray]]  # dual quaternions (1, B, 4)
    so3: Optional[np.ndarray]  # (B, 3) joint angles
    mesh_t: Mesh  # the mesh at the frame, camera space
    bone_t: Optional[Mesh]  # the bones at the frame, camera space


def _numpy(x):
    return x.detach().cpu().numpy()


def extract_canonical_mesh(model: DVRModel, geo_state, cate: str, opts: Dict) -> Mesh:
    """Marching cubes over the field's canonical SDF in its aabb; the
    largest connected component for fg."""
    field = model.fields.field_params[cate]
    device = next(model.parameters()).device

    def sdf_fn(pts):
        pts = torch.as_tensor(pts, dtype=torch.float32, device=device)
        inst_id = torch.full((pts.shape[0],), opts["inst_id"], dtype=torch.long, device=device)
        with torch.no_grad():
            return _numpy(field.forward(pts, inst_id=inst_id, get_density=False))

    return marching_cubes(sdf_fn, np.asarray(geo_state[cate]["aabb"]), grid_size=opts["grid_size"],
                          level=opts["level"], apply_connected_component=(cate == "fg"))


def extract_deformation(model: DVRModel, cate: str, mesh_rest: Mesh, inst_id: int, frame_ids):
    """The rest mesh with the instance's morphology (skinning warps) and,
    for each raw frame id, the motion parameters and the rest mesh warped
    forward into that frame's camera (MotionParamsExpl). Joint angles and
    the bones' edges exist for the skeleton warps only (skel-*, comp_*),
    not for the bag of bones (bob)."""
    field = model.fields.field_params[cate]
    device = next(model.parameters()).device
    has_skinning = cate == "fg" and field.has_skinning
    articulation = field.warp.articulation if has_skinning else None
    has_skel = has_skinning and field.warp.skel_type != "flat"
    edges = articulation.skeleton.edges if has_skel else None
    xyz = torch.as_tensor(np.asarray(mesh_rest.vertices, np.float32), device=device)[None, None]
    inst = torch.tensor([inst_id], device=device)
    logscale = float(torch.exp(field.logscale))

    motion_tuples = {}
    with torch.no_grad():
        for frame_id in frame_ids:
            fid = torch.tensor([int(frame_id)], device=device)
            field2cam = field.camera_mlp.get_vals(fid)
            samples_dict, mesh_bones_t, so3, t_art = {}, None, None, None
            if has_skinning:
                t_art, rest_art = articulation.get_vals_and_mean(fid)
                samples_dict = {"t_articulation": t_art, "rest_articulation": rest_art}
                if has_skel:
                    so3 = _numpy(articulation.get_vals(fid, return_so3=True))[0]
                centers = dual_quaternion_to_quaternion_translation((t_art[0][0], t_art[1][0]))[1]
                mesh_bones_t = draw_skeleton_bones(_numpy(centers), edges)
                mesh_bones_t.apply_transform(_numpy(quaternion_translation_to_se3(*field2cam))[0])
                t_art = tuple(_numpy(a) for a in t_art)
            xyz_t = field.forward_warp(xyz, field2cam, fid, inst, samples_dict=samples_dict)
            motion_tuples[int(frame_id)] = MotionParamsExpl(
                field2cam=(_numpy(field2cam[0]), _numpy(field2cam[1]) / logscale),
                t_articulation=t_art, so3=so3,
                mesh_t=Mesh(_numpy(xyz_t)[0, 0], mesh_rest.faces), bone_t=mesh_bones_t,
            )

        if has_skinning:
            # the warp stretches the bones from the mean instance's rest pose
            # to this instance's
            identity = (torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device),
                        torch.zeros((1, 3), device=device))
            samples_dict = {"t_articulation": articulation.get_mean_vals(inst),
                            "rest_articulation": articulation.get_mean_vals()}
            xyz_i = field.forward_warp(xyz, identity, None, inst, samples_dict=samples_dict)
            mesh_rest = Mesh(_numpy(xyz_i)[0, 0], mesh_rest.faces)
    return mesh_rest, motion_tuples


def save_motion_params(meshes_rest: Dict[str, Mesh], motion_tuples, save_dir: str):
    """Write the objs and `<cate>-motion.json` of every category."""
    for cate, mesh_rest in meshes_rest.items():
        mesh_rest.export("%s/%s.obj" % (save_dir, cate))
        motion_params = {"field2cam": [], "t_articulation": [], "joint_so3": []}
        for frame_id, mp in motion_tuples[cate].items():
            mp.mesh_t.export("%s/%s-%05d.obj" % (save_dir, cate, frame_id))
            if mp.bone_t is not None and not mp.bone_t.is_empty:
                mp.bone_t.export("%s/%s-%05d-bone.obj" % (save_dir, cate, frame_id))
            f2c = quaternion_translation_to_se3(*(torch.as_tensor(a) for a in mp.field2cam))
            motion_params["field2cam"].append(f2c.numpy()[0].tolist())
            if mp.t_articulation is not None:
                t_arti = dual_quaternion_to_se3(tuple(torch.as_tensor(a) for a in mp.t_articulation))
                motion_params["t_articulation"].append(t_arti.numpy()[0].tolist())
            if mp.so3 is not None:
                motion_params["joint_so3"].append(np.asarray(mp.so3).tolist())
        with open("%s/%s-motion.json" % (save_dir, cate), "w") as fp:
            json.dump(motion_params, fp)


def extract_motion_params(model: DVRModel, geo_state, opts: Dict, data_info):
    """The rest mesh and the per-frame motion of every category in
    geo_state, over the frames of video opts["inst_id"]."""
    inst_id = opts["inst_id"]
    frame_info = data_info["frame_info"]
    offset = frame_info.frame_offset
    frame_ids = frame_info.frame_mapping[offset[inst_id] : offset[inst_id + 1]]
    print("Extracting motion parameters for frame ids:", list(frame_ids))

    meshes_rest, motion_tuples = {}, {}
    for cate in geo_state:
        mesh = extract_canonical_mesh(model, geo_state, cate, opts)
        meshes_rest[cate], motion_tuples[cate] = extract_deformation(
            model, cate, mesh, inst_id, frame_ids)
    return meshes_rest, motion_tuples


def export(opts: Dict) -> str:
    """Export the run's checkpoint; returns the output directory."""
    device = torch.device(opts["device"])
    model, geo_state, data_info = construct_test_model(opts, device)
    save_dir = make_save_dir(opts, sub_dir="export_%04d" % opts["inst_id"])
    meshes_rest, motion_tuples = extract_motion_params(model, geo_state, opts, data_info)
    save_motion_params(meshes_rest, motion_tuples, save_dir)
    print("Saved to %s" % save_dir)
    return save_dir


def main(argv=None):
    opts = parse_opts(get_parser(), argv)
    validate_opts(opts)
    return export(opts)


if __name__ == "__main__":
    main()
