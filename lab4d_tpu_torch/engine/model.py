"""Top-level DVR model, eval side. Port of lab4d_tpu/engine/model.py.

Geometry state (aabb, proxy corners) arrives in batch["geo"], as in the
JAX package. Losses and the training forward are not ported yet
(ROADMAP.md, slice 2).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from lab4d_tpu_torch.nnutils.intrinsics import IntrinsicsMLP
from lab4d_tpu_torch.nnutils.multifields import MultiFields
from lab4d_tpu_torch.ops.renderer import render_pixel
from lab4d_tpu_torch.utils.geom import K2inv, K2mat


class DVRModel(nn.Module):
    """Differentiable volume rendering model over the foreground field.

    The module is built from `generator` on the CPU and then moved to
    `device`.
    """

    def __init__(self, frame_info: FrameInfo, field_type: str = "fg",
                 fg_motion: str = "skel-quad", num_inst: int = 1, device="cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.frame_info = frame_info
        self.fields = MultiFields(frame_info, field_type=field_type, fg_motion=fg_motion,
                                  num_inst=num_inst, generator=generator)
        self.intrinsics = IntrinsicsMLP(frame_info, num_freq_t=0, generator=generator)
        self.register_buffer("frame_offset_raw", torch.as_tensor(frame_info.frame_offset_raw),
                             persistent=False)
        self.to(device)

    def process_frameid(self, batch):
        batch["frameid"] = batch["frameid_sub"] + self.frame_offset_raw[batch["dataid"]]
        return batch

    def get_samples(self, batch):
        if "Kinv" in batch:
            Kinv = batch["Kinv"]
        else:
            Kmat = self.intrinsics.get_vals(batch["frameid"])
            Kinv = K2inv(Kmat) @ K2mat(batch["crop2raw"])
        return self.fields.get_samples(Kinv, batch)

    def render_samples(self, samples_dict):
        multifields_dict, deltas_dict, _ = self.fields.query_multifields(samples_dict)
        return render_pixel(*self.fields.compose_fields(multifields_dict, deltas_dict))

    def prepare_eval_samples(self, batch):
        """Per-frame half of eval: frame ids, camera/intrinsics MLPs, FK
        articulations, near-far from proxy corners. Run once per frame;
        ray chunks then stream through evaluate_rays."""
        batch = dict(batch)
        geo = batch.pop("geo")
        batch = self.process_frameid(batch)
        batch["geo"] = geo
        return self.get_samples(batch)

    def evaluate_rays(self, samples_dict):
        """Per-chunk half of eval: render the rays in samples_dict[cate]
        ["hxy"]. Every non-mask channel is blended with the rendered mask
        (render * mask + 0 * (1 - mask))."""
        rendered = self.render_samples(samples_dict)
        mask = rendered["mask"]

        def blend(v):
            return v * (mask if v.ndim == mask.ndim else mask[..., 0])

        return {k: v if "mask" in k else blend(v) for k, v in rendered.items()}
