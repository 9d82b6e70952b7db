"""The weights of a run, drawn from the seed on the device.

Every Linear layer's weight and bias ~ U(+-1/sqrt(fan_in)) (torch.nn.Linear's
init, which the program's own init copies) and every code table ~
N(0, 1/sqrt(channels)), from one torch.Generator on the run's device in two
calls. The other leaves (log scales, beta, the skeleton's tables, the base
rotations) keep the values the reference's constructor gives them. Then the
trainer's prior surgery, on random weights: intrinsics and camera base
rotation from the video's first frame, and the camera MLP's translation bias
offset so that its mean output is the prior's (field units); without it
almost every ray misses the object. The same state is loaded into the
program and into the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from benchmark.reference import model as ref_model
from benchmark.reference.lab4d_ref.nnutils.multifields import INIT_SCALE
from benchmark.reference.lab4d_ref.utils.quat import matrix_to_quaternion


def _draw_(leaves, draw, generator, device):
    total = sum(t.numel() for t, _ in leaves)
    if total == 0:
        return
    flat = draw(total, generator=generator, device=device)
    off = 0
    with torch.no_grad():
        for t, fn in leaves:
            n = t.numel()
            t.copy_(fn(flat[off : off + n].view_as(t)))
            off += n


def prior_surgery(model, priors: dict, cate: str = "fg"):
    """Intrinsics and the camera's base rotation and translation from the
    priors (the trainer's set-up before its fits)."""
    fi = model.frame_info
    first = fi.frame_offset[:-1]
    intr = np.asarray(priors["intrinsics"], np.float32)
    rtmat = np.array(priors["rtmat"], np.float32)
    rtmat[:, :3, 3] *= INIT_SCALE[cate]
    cam = model.fields.field_params[cate].camera_mlp
    with torch.no_grad():
        model.intrinsics.base_logfocal.copy_(torch.as_tensor(np.log(intr[first, :2])))
        model.intrinsics.base_ppoint.copy_(torch.as_tensor(intr[first, 2:]))
        cam.base_quat.copy_(matrix_to_quaternion(torch.as_tensor(rtmat[first, :3, :3])))
        _, trans = cam.get_vals()
        prior = torch.as_tensor(rtmat[:, :3, 3], device=trans.device)
        cam.trans_head[1].bias += (prior - trans).mean(0)


def make_state(cfg: dict, priors: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The run's weights: {name: tensor} on `device`, a state dict of the
    configuration's model."""
    device = torch.device(device)
    model = ref_model.build(cfg, priors, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    linear, codes = [], []
    for m in model.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / np.sqrt(max(m.in_features, 1))
            for t in (m.weight, m.bias):
                linear.append((t, lambda u, b=bound: (u * 2 - 1) * b))
        elif isinstance(m, nn.Embedding):
            std = 1.0 / np.sqrt(m.embedding_dim)
            codes.append((m.weight, lambda z, s=std: z * s))
    _draw_(linear, torch.rand, gen, device)
    _draw_(codes, torch.randn, gen, device)
    prior_surgery(model, priors)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
