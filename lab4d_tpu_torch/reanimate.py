"""Reanimation CLI: drive a fitted model with the motion exported from
another video (motion transfer).

Port of lab4d_tpu/reanimate.py on PyTorch: it reads
`<logroot>/<seqname>-<logname>/export_<motion_id>/fg-motion.json` (written
by export.py of either package), renders as render.py does, and replaces
the batch's fg camera poses and joint angles with the file's.

    python -m lab4d_tpu_torch.reanimate --seqname cat --logname run \\
        --fg_motion skel-quad --load_suffix latest --motion_id 0
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from lab4d_tpu_torch.flagfile import parse_opts, validate_opts
from lab4d_tpu_torch.render import construct_batch_from_opts, get_parser as render_parser, render
from lab4d_tpu_torch.utils.quat import se3_to_quaternion_translation


def get_parser():
    p = render_parser()
    p.description = __doc__.split("\n")[0]
    p.add_argument("--motion_id", type=int, default=0, help="motion id (source video)")
    return p


def construct_batch_from_opts_reanimate(opts: Dict, model, geo_state, data_info, device):
    """render.construct_batch_from_opts over the frames of video motion_id,
    with batch["joint_so3"] and batch["field2cam"]["fg"] from its
    fg-motion.json (no joint angles but for a skeleton: the bag of bones
    keeps its own articulation); a comp model's bg keeps its camera MLP."""
    motion_path = "%s/%s-%s/export_%04d/fg-motion.json" % (
        opts["logroot"], opts["seqname"], opts["logname"], opts["motion_id"])
    with open(motion_path) as fp:
        motion_data = json.load(fp)
    field2cam = np.asarray(motion_data["field2cam"], np.float32).reshape(-1, 4, 4)
    joint_so3 = np.asarray(motion_data["joint_so3"], np.float32)

    opts = dict(opts, num_frames=len(field2cam))
    batch, raw_size = construct_batch_from_opts(opts, model, geo_state, data_info, device)
    batch["joint_so3"] = torch.as_tensor(joint_so3, device=device)
    batch["field2cam"] = {"fg": se3_to_quaternion_translation(
        torch.as_tensor(field2cam, device=device), tuple_out=False)}
    return batch, raw_size


def main(argv=None):
    opts = parse_opts(get_parser(), argv)
    validate_opts(opts)
    return render(opts, construct_batch_func=construct_batch_from_opts_reanimate)


if __name__ == "__main__":
    main()
