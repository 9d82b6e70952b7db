"""The reference's model of a configuration (lab4d_ref's DVRModel)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.lab4d_ref.engine.model import DVRModel
from benchmark.reference.lab4d_ref.nnutils.embedding import FrameInfo


def frame_info(num_frames: int) -> FrameInfo:
    return FrameInfo.single_video(num_frames)


def build(cfg: dict, priors: dict, device, loss_weights=()) -> DVRModel:
    """The configuration's model on `device`, its weights from a fixed CPU
    generator (the benchmark overwrites them: weights.make_state).

    priors: {"num_frames", "intrinsics" (frames, 4), "rtmat" (frames, 4, 4)}
    """
    fi = frame_info(priors["num_frames"])
    return DVRModel(fi, field_type=cfg["field_type"], fg_motion=cfg["fg_motion"], num_inst=1,
                    device=device, generator=torch.Generator().manual_seed(0),
                    intrinsics_init=np.asarray(priors["intrinsics"], np.float32),
                    rtmat_fg=np.asarray(priors["rtmat"], np.float32),
                    rtmat_bg=np.asarray(priors["rtmat"], np.float32),
                    train_res=priors.get("train_res", 256), loss_weights=loss_weights)
