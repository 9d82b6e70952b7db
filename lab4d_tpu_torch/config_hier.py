"""Hierarchical (structured) configuration mirror of the absl flag
schema. The port's copy of lab4d_tpu/config_hier.py.

Parity: lab4d/config_omega.py — the reference keeps an experimental
OmegaConf tree alongside its absl flags; here the tree is plain
dataclasses with the same grouping. `to_opts()` flattens to the flat dict
of every flag of lab4d_tpu/config.py, `from_opts()` lifts a flat dict back
into the tree, and `validate(flat)` checks such a dict at startup (the
port's CLIs build it with `flagfile.absl_flags`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class LossWeights:
    mask_wt: float = 0.1
    rgb_wt: float = 0.1
    depth_wt: float = 1e-4
    flow_wt: float = 0.5
    vis_wt: float = 1e-2
    feature_wt: float = 1e-2
    feat_reproj_wt: float = 5e-2
    reg_visibility_wt: float = 1e-4
    reg_eikonal_wt: float = 1e-3
    reg_deform_cyc_wt: float = 0.01
    reg_delta_skin_wt: float = 5e-3
    reg_skin_entropy_wt: float = 5e-4
    reg_gauss_skin_wt: float = 1e-3
    reg_cam_prior_wt: float = 0.1
    reg_skel_prior_wt: float = 0.1
    reg_gauss_mask_wt: float = 0.01
    reg_soft_deform_wt: float = 100.0


@dataclass
class ModelConfig:
    field_type: str = "fg"
    fg_motion: str = "rigid"
    single_inst: bool = True


@dataclass
class IOConfig:
    seqname: str = "cat"
    logname: str = "tmp"
    data_prefix: str = "crop"
    train_res: int = 256
    logroot: str = "logdir/"
    database_root: str = "database"
    load_suffix: str = ""
    feature_type: str = "dinov2"
    load_path: str = ""


@dataclass
class OptConfig:
    learning_rate: float = 5e-4
    num_rounds: int = 20
    iters_per_round: int = 200
    imgs_per_gpu: int = 128
    pixels_per_image: int = 16
    freeze_bone_len: bool = False
    reset_steps: bool = True


@dataclass
class EfficiencyConfig:
    ngpu: int = 1
    geo_init_steps: int = 500
    video_shards: int = 1
    num_workers: int = 2
    eval_res: int = 64
    save_freq: int = 10
    profile: bool = False
    use_cpu: bool = False


# legal values for the string-enum flags (lab4d_tpu/config.py, warping.parse_warp_type)
FIELD_TYPES = ("fg", "bg", "comp")
FG_MOTIONS = (
    "rigid", "dense", "nvp", "bob", "skel-human", "skel-quad",
    "comp_skel-human_dense", "comp_skel-quad_dense",
)


def validate(flat: Dict) -> None:
    """Validate a flat opts dict against this hierarchical schema: every
    schema field must be present with the right type, and string enums
    must hold legal values. Called by the CLIs at startup so a typo'd or
    mistyped flag fails fast instead of deep in the trainer."""
    cfg = Config()
    for group in dataclasses.fields(Config):
        sub = getattr(cfg, group.name)
        for f in dataclasses.fields(sub):
            if f.name not in flat:
                raise ValueError(f"missing config key: {group.name}.{f.name}")
            v = flat[f.name]
            want = type(getattr(sub, f.name))
            if want is float and isinstance(v, int):
                continue  # int literals are fine for float flags
            if not isinstance(v, want):
                raise TypeError(
                    f"config key {f.name}: expected {want.__name__}, "
                    f"got {type(v).__name__} ({v!r})"
                )
    if flat["field_type"] not in FIELD_TYPES:
        raise ValueError(f"field_type must be one of {FIELD_TYPES}")
    fg = flat["fg_motion"]
    if fg not in FG_MOTIONS and not fg.startswith(("skel-", "comp_")):
        raise ValueError(f"fg_motion {fg!r} not in {FG_MOTIONS}")
    for k in ("num_rounds", "iters_per_round", "imgs_per_gpu",
              "pixels_per_image", "ngpu", "video_shards", "train_res"):
        if flat[k] <= 0:
            raise ValueError(f"config key {k} must be positive, got {flat[k]}")


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    io: IOConfig = field(default_factory=IOConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    eff: EfficiencyConfig = field(default_factory=EfficiencyConfig)
    loss: LossWeights = field(default_factory=LossWeights)

    def to_opts(self) -> Dict:
        """Flatten to the mutable opts dict all layers consume."""
        out = {}
        for group in dataclasses.fields(self):
            out.update(dataclasses.asdict(getattr(self, group.name)))
        return out

    @classmethod
    def from_opts(cls, opts: Dict) -> "Config":
        cfg = cls()
        for group in dataclasses.fields(cls):
            sub = getattr(cfg, group.name)
            for f in dataclasses.fields(sub):
                if f.name in opts:
                    setattr(sub, f.name, opts[f.name])
        return cfg

    def to_json(self) -> str:
        return json.dumps(
            {g.name: dataclasses.asdict(getattr(self, g.name))
             for g in dataclasses.fields(self)},
            indent=1,
        )

    @classmethod
    def from_json(cls, payload: str) -> "Config":
        data = json.loads(payload)
        flat = {}
        for sub in data.values():
            flat.update(sub)
        return cls.from_opts(flat)
