"""opts.log and --flagfile of the port's CLIs (lab4d_tpu_torch/flagfile.py)
against the JAX package's absl flags (lab4d_tpu/config.py).

- The port's table of the JAX flags is lab4d_tpu/config.py's.
- opts.log written by the port's train CLI replays through the JAX flag
  definitions (absl `--flagfile`) without error, to the port's values,
  and is line for line what absl writes for those values.
- A JAX-written opts.log (absl's own flags included, as the JAX train CLI
  writes it) read with the port's `--flagfile` gives the same values in
  the train and render CLIs; later arguments override it.

The JAX flags are a deep copy of lab4d_tpu.config.opts, so that no test
changes the process's global flags.
"""

import copy

import pytest

from lab4d_tpu_torch import flagfile
from lab4d_tpu_torch import render as render_cli
from lab4d_tpu_torch import train as train_cli


def _jax_flags():
    from absl import app  # noqa: F401  (the JAX train CLI's opts.log carries absl's flags too)

    from lab4d_tpu import config

    return copy.deepcopy(config.opts)


def _config_flags():
    from lab4d_tpu import config

    return config.opts.flags_by_module_dict()["lab4d_tpu.config"]


def test_jax_config_flags_table():
    """JAX_CONFIG_FLAGS lists every flag of lab4d_tpu/config.py with its
    default and type."""
    jax = {f.name: f.default for f in _config_flags()}
    assert flagfile.JAX_CONFIG_FLAGS == jax
    for name, default in jax.items():
        assert type(flagfile.JAX_CONFIG_FLAGS[name]) is type(default), name


PORT_ARGV = ["--seqname", "s", "--logname", "l", "--field_type", "bg", "--no-single_inst",
             "--freeze_bone_len", "--learning_rate", "0.001", "--mask_wt", "0.25",
             "--num_workers", "3", "--device", "cpu"]


def test_port_opts_log_replays_through_jax_flags(tmp_path):
    """The port's opts.log holds only flags lab4d_tpu defines (--device as
    --use_cpu), booleans as --flag / --noflag, and absl's --flagfile takes
    it, giving each flag the port's value (the JAX default where the port
    has no option)."""
    opts = vars(train_cli.get_parser().parse_args(PORT_ARGV + ["--logroot", str(tmp_path)]))
    train_cli.save_opts(opts)
    path = tmp_path / "s-l" / "opts.log"
    lines = path.read_text().splitlines()
    names = [ln[2:].split("=")[0] for ln in lines]
    assert len(lines) == len(flagfile.JAX_CONFIG_FLAGS)
    for name in names:
        assert name in flagfile.JAX_CONFIG_FLAGS or name[2:] in flagfile.JAX_CONFIG_FLAGS
    assert "--nosingle_inst" in lines and "--freeze_bone_len" in lines and "--use_cpu" in lines
    fv = _jax_flags()
    fv(["train.py", f"--flagfile={path}"])
    for name, default in flagfile.JAX_CONFIG_FLAGS.items():
        want = opts.get(name, default) if name != "use_cpu" else True
        assert fv[name].value == want, name
    # line for line what absl writes for the same values
    out = tmp_path / "jax_opts.log"
    fv.append_flags_into_file(str(out))
    config_names = {f.name for f in _config_flags()}
    jax_lines = [ln for ln in out.read_text().splitlines()
                 if ln[2:].split("=")[0] in config_names or ln[4:].split("=")[0] in config_names]
    assert lines == jax_lines


JAX_ARGV = ["--seqname=s", "--logname=l", "--field_type=bg", "--fg_motion=skel-quad",
            "--nosingle_inst", "--freeze_bone_len", "--learning_rate=0.001", "--mask_wt=0.25",
            "--num_workers=3", "--use_cpu", "--train_res=64", "--ngpu=1"]


@pytest.mark.parametrize("cli", ["train", "render"])
def test_jax_opts_log_reads_into_port(tmp_path, cli):
    """A JAX-written opts.log read with the port's --flagfile: every option
    of the port that lab4d_tpu/config.py defines takes the file's value,
    --use_cpu gives --device cpu, flags the CLI does not take (absl's, the
    render CLI's training flags) are left out, and a later argument
    overrides the file."""
    fv = _jax_flags()
    fv(["train.py"] + JAX_ARGV)
    path = tmp_path / "opts.log"
    fv.append_flags_into_file(str(path))
    assert "--noonly_check_args" in path.read_text()  # absl's own flags are in the file
    parser = (train_cli if cli == "train" else render_cli).get_parser()
    opts = flagfile.parse_opts(parser, ["--flagfile", str(path)])
    shared = [k for k in opts if k in flagfile.JAX_CONFIG_FLAGS]
    assert {"seqname", "logname", "field_type", "fg_motion", "train_res"} <= set(shared)
    for k in shared:
        assert opts[k] == fv[k].value, k
    assert opts["device"] == "cpu" and "flagfile" not in opts
    later = flagfile.parse_opts(parser, [f"--flagfile={path}", "--seqname", "other"])
    assert later["seqname"] == "other" and later["logname"] == "l"
    if cli == "train":
        assert opts["single_inst"] is False and opts["freeze_bone_len"] is True
        assert opts["learning_rate"] == 0.001 and opts["num_workers"] == 3


@pytest.mark.parametrize("cli", ["render", "export", "reanimate"])
def test_category_opts_log_replays_into_the_apps(tmp_path, cli):
    """A category run's opts.log (the port's train CLI, --nosingle_inst
    given in absl's spelling) replays into render, export and reanimate
    through --flagfile: --single_inst False builds the test-time model with
    one instance code per video; a later --single_inst overrides it."""
    import importlib

    opts = flagfile.parse_opts(train_cli.get_parser(), [
        "--seqname", "cate", "--logname", "c", "--fg_motion", "comp_skel-human_dense",
        "--nosingle_inst", "--device", "cpu", "--logroot", str(tmp_path)])
    assert opts["single_inst"] is False
    train_cli.save_opts(opts)
    path = tmp_path / "cate-c" / "opts.log"
    assert "--nosingle_inst" in path.read_text().splitlines()
    parser = importlib.import_module(f"lab4d_tpu_torch.{cli}").get_parser()
    got = flagfile.parse_opts(parser, ["--flagfile", str(path), "--inst_id", "5"])
    assert got["single_inst"] is False and got["inst_id"] == 5
    assert got["fg_motion"] == "comp_skel-human_dense" and got["device"] == "cpu"
    assert flagfile.parse_opts(parser, [f"--flagfile={path}", "--single_inst"])["single_inst"]
