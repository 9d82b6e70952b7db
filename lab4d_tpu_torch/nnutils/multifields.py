"""Container of neural fields. Port of lab4d_tpu/nnutils/multifields.py
for the foreground-only configuration (field_type "fg"); "bg" and "comp"
are ROADMAP.md P9."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lab4d_tpu_torch.nnutils.deformable import Deformable
from lab4d_tpu_torch.nnutils.embedding import FrameInfo
from lab4d_tpu_torch.utils.quat import quaternion_translation_to_se3


class MultiFields(nn.Module):
    """Dict of fields ("fg" -> Deformable): no directional encoding,
    appearance codes, init_scale=0.2, D=5 W=128."""

    def __init__(self, frame_info: FrameInfo, field_type: str = "fg",
                 fg_motion: str = "skel-quad", num_inst: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if field_type != "fg":
            raise NotImplementedError(
                f"field_type {field_type!r} is not ported yet (ROADMAP.md, P9 other families)"
            )
        self.field_type = field_type
        self.field_params = nn.ModuleDict({
            "fg": Deformable(
                "fg", fg_motion=fg_motion, frame_info=frame_info, num_inst=num_inst, D=5,
                W=128, num_freq_dir=-1, appr_channels=32, init_scale=0.2, generator=generator,
            )
        })

    @property
    def categories(self):
        return (self.field_type,)

    def get_samples(self, Kinv, batch):
        """Per-field camera/articulation samples for eval."""
        samples_dict = {}
        for cate in self.categories:
            batch_sub = dict(batch)
            if "field2cam" in batch:
                batch_sub["field2cam"] = batch["field2cam"][cate]
            if "geo" in batch:
                batch_sub.update(batch_sub.pop("geo")[cate])
            samples_dict[cate] = self.field_params[cate].get_samples(Kinv, batch_sub)
        return samples_dict

    def query_multifields(self, samples_dict):
        multifields_dict, deltas_dict, aux_dict = {}, {}, {}
        for cate in self.categories:
            multifields_dict[cate], deltas_dict[cate], aux_dict[cate] = (
                self.field_params[cate].query_field(samples_dict[cate])
            )
        return multifields_dict, deltas_dict, aux_dict

    @staticmethod
    def compose_fields(multifields_dict, deltas_dict):
        """One field: composition is the identity."""
        (cate,) = multifields_dict.keys()
        return multifields_dict[cate], deltas_dict[cate]

    def get_cameras(self, frame_id=None):
        """World-unit object-to-camera matrices per field."""
        field2cam = {}
        for cate in self.categories:
            field = self.field_params[cate]
            quat, trans = field.camera_mlp.get_vals(frame_id)
            field2cam[cate] = quaternion_translation_to_se3(quat, trans / torch.exp(field.logscale))
        return field2cam

    def get_logscales(self):
        return {cate: torch.exp(self.field_params[cate].logscale) for cate in self.categories}
