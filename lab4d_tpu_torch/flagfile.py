"""opts.log and --flagfile in the JAX package's format.

The JAX CLIs snapshot their flags into `<logroot>/<seqname>-<logname>/
opts.log` with absl's `append_flags_into_file` (lab4d_tpu/config.py
`save_config`), and the test-time tools reload that file with
`--flagfile`. The port writes the same file and reads the same format:

- `write_opts_log` writes one line per flag that lab4d_tpu/config.py
  defines (`JAX_CONFIG_FLAGS`), sorted by name, each with the port's value
  (the JAX default where the port has no such option): `--name=value`, and
  booleans as `--name` / `--noname`. The port's `--device` is written as
  the JAX flag `use_cpu`.
- `expand_flagfiles` replaces each `--flagfile=PATH` of an argument list by
  the flags of that file (absl's format: one flag per line, `#` and `//`
  comments, nested flagfiles), in place, so that later arguments override
  them as in absl. Flags the parser does not take are left out: a JAX
  opts.log carries the training flags, which the render CLI has no use
  for, and absl's own. `--use_cpu` becomes `--device=cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

# every flag of lab4d_tpu/config.py with its default (a training run's opts.log)
JAX_CONFIG_FLAGS = {
    "data_prefix": "crop", "database_root": "database", "depth_wt": 0.0001, "eval_res": 64,
    "feat_reproj_wt": 0.05, "feature_type": "dinov2", "feature_wt": 0.01, "fg_motion": "rigid",
    "field_type": "fg", "flow_wt": 0.5, "freeze_bone_len": False, "geo_init_steps": 500,
    "imgs_per_gpu": 128, "iters_per_round": 200, "learning_rate": 0.0005, "load_path": "",
    "load_suffix": "", "logname": "tmp", "logroot": "logdir/", "mask_wt": 0.1, "ngpu": 1,
    "num_rounds": 20, "num_workers": 2, "pixels_per_image": 16, "profile": False,
    "reg_cam_prior_wt": 0.1, "reg_deform_cyc_wt": 0.01, "reg_delta_skin_wt": 0.005,
    "reg_eikonal_wt": 0.001, "reg_gauss_mask_wt": 0.01, "reg_gauss_skin_wt": 0.001,
    "reg_skel_prior_wt": 0.1, "reg_skin_entropy_wt": 0.0005, "reg_soft_deform_wt": 100.0,
    "reg_visibility_wt": 0.0001, "reset_steps": True, "rgb_wt": 0.1, "save_freq": 10,
    "seqname": "cat", "single_inst": True, "train_res": 256, "use_cpu": False,
    "video_shards": 1, "vis_wt": 0.01,
}


def flag_line(name: str, value) -> str:
    """One flag as absl writes it into a flagfile."""
    if isinstance(value, bool):
        return f"--{name}" if value else f"--no{name}"
    return f"--{name}={value}"


def absl_flags(opts: Dict) -> Dict:
    """Every flag of lab4d_tpu/config.py by name, with the port's value
    from `opts` (the JAX default where the port has no such option) and
    --device as use_cpu: the flat dict that config_hier.validate checks."""
    values = dict(JAX_CONFIG_FLAGS)
    values.update({k: v for k, v in opts.items() if k in JAX_CONFIG_FLAGS})
    values["use_cpu"] = opts.get("device", "cuda") == "cpu"
    return values


def validate_opts(opts: Dict):
    """Reject at startup the flags lab4d_tpu/config.py's get_config
    rejects (config_hier.validate on absl_flags(opts))."""
    from lab4d_tpu_torch.config_hier import validate

    validate(absl_flags(opts))


def opts_log_lines(opts: Dict) -> List[str]:
    """The lines of opts.log for the port's options `opts`."""
    values = absl_flags(opts)
    return [flag_line(k, values[k]) for k in sorted(values)]


def write_opts_log(path: str, opts: Dict):
    with open(path, "w") as f:
        f.writelines(line + "\n" for line in opts_log_lines(opts))


def _read_flagfile(path: str, seen=()) -> List[str]:
    path = os.path.abspath(path)
    if path in seen:
        raise ValueError(f"flagfile {path} includes itself")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            if line.startswith("--flagfile="):
                out += _read_flagfile(line.split("=", 1)[1], (*seen, path))
            else:
                out.append(line)
    return out


def _bool_value(text: str) -> bool:
    if text.lower() in ("true", "t", "1"):
        return True
    if text.lower() in ("false", "f", "0"):
        return False
    raise ValueError(f"not a boolean: {text}")


def _translate(flag: str, parser: argparse.ArgumentParser) -> List[str]:
    """An absl flag `--name[=value]` as arguments of `parser` ([] if the
    parser does not take it)."""
    body = flag[2:] if flag.startswith("--") else flag.lstrip("-")
    name, eq, value = body.partition("=")
    actions = {a.dest: a for a in parser._actions}
    if name == "use_cpu" or (name == "nouse_cpu" and not eq):
        on = _bool_value(value) if eq else name == "use_cpu"
        return ["--device=cpu"] if on and "device" in actions else []
    on = True
    if name not in actions and name.startswith("no") and name[2:] in actions and not eq:
        name, on = name[2:], False
    action = actions.get(name)
    if action is None:
        return []
    if isinstance(action, argparse.BooleanOptionalAction):
        on = _bool_value(value) if eq else on
        return [f"--{name}" if on else f"--no-{name}"]
    if isinstance(action, argparse._StoreTrueAction):
        on = _bool_value(value) if eq else on
        return [f"--{name}"] if on else []
    return [f"--{name}={value}"]


def _absl_negation(arg: str, parser: argparse.ArgumentParser) -> str:
    """absl's `--noname` of a boolean flag as argparse's `--no-name`; any
    other argument as it is."""
    name = arg[4:]
    if not arg.startswith("--no") or arg in parser._option_string_actions:
        return arg
    action = parser._option_string_actions.get(f"--{name}")
    return f"--no-{name}" if isinstance(action, argparse.BooleanOptionalAction) else arg


def expand_flagfiles(argv: List[str], parser: argparse.ArgumentParser) -> List[str]:
    """argv with each `--flagfile=PATH` (or `--flagfile PATH`) replaced by
    the flags of that file that `parser` takes, and absl's `--noname` of a
    boolean flag as `--no-name`."""
    out, i = [], 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--flagfile" and i + 1 < len(argv):
            path, i = argv[i + 1], i + 2
        elif arg.startswith("--flagfile="):
            path, i = arg.split("=", 1)[1], i + 1
        else:
            out.append(_absl_negation(arg, parser))
            i += 1
            continue
        for flag in _read_flagfile(path):
            out += _translate(flag, parser)
    return out


def add_flagfile_option(parser: argparse.ArgumentParser):
    """Document `--flagfile` in parser's help; parse_opts expands it."""
    parser.add_argument("--flagfile", default=argparse.SUPPRESS,
                        help="read flags from this file (absl's format, e.g. a run's opts.log)")


def parse_opts(parser: argparse.ArgumentParser, argv=None) -> Dict:
    """The options of argv (default: the command line), flagfiles expanded."""
    argv = sys.argv[1:] if argv is None else list(argv)
    return vars(parser.parse_args(expand_flagfiles(argv, parser)))
