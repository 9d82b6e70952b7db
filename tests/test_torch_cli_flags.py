"""The port's four CLIs take every flag of lab4d_tpu/config.py, as the JAX
package's absl apps do (train, render, export and reanimate all register
the training flags): each flag, given its JAX default on the command line
in absl's forms, parses and reads back that default. Booleans in both
forms: `--name` / `--noname`, and `--name=true|false`. `--use_cpu` is the
port's `--device cpu`.
"""

import pytest
from absl import flags

import lab4d_tpu.config  # noqa: F401  (registers the flags)
from lab4d_tpu_torch import export, reanimate, render, train
from lab4d_tpu_torch.flagfile import JAX_CONFIG_FLAGS, parse_opts

CLIS = {"train": train, "render": render, "export": export, "reanimate": reanimate}
JAX_FLAGS = {f.name: f.default for f in flags.FLAGS.get_flags_for_module("lab4d_tpu.config")}


def test_the_flag_table_is_jaxs():
    assert len(JAX_FLAGS) > 40
    assert JAX_FLAGS == JAX_CONFIG_FLAGS


def _forms(name, default):
    if isinstance(default, bool):
        return [[f"--{name}" if default else f"--no{name}"], [f"--{name}={str(default).lower()}"]]
    return [[f"--{name}={default}"], [f"--{name}", str(default)]]


@pytest.mark.parametrize("name", sorted(JAX_FLAGS))
@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_takes_the_flag_with_its_jax_default(cli, name):
    default = JAX_FLAGS[name]
    for argv in _forms(name, default):
        opts = parse_opts(CLIS[cli].get_parser(), argv)
        assert opts[name] == default, (argv, opts[name])
        assert type(opts[name]) is type(default), argv


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_use_cpu_is_device_cpu(cli):
    parser = CLIS[cli].get_parser()
    assert parse_opts(parser, ["--use_cpu"])["device"] == "cpu"
    assert parse_opts(parser, ["--use_cpu=true"])["device"] == "cpu"
    opts = parse_opts(parser, ["--device", "cpu"])
    assert opts["use_cpu"] is True
    opts = parse_opts(parser, [])
    assert opts["device"] == "cuda" and opts["use_cpu"] is False


def test_a_non_default_value_reaches_the_options():
    opts = parse_opts(train.get_parser(), ["--ngpu", "4", "--video_shards=2", "--nosingle_inst",
                                           "--load_suffix", "latest", "--reset_steps=false"])
    assert (opts["ngpu"], opts["video_shards"], opts["single_inst"], opts["load_suffix"],
            opts["reset_steps"]) == (4, 2, False, "latest", False)
    opts = parse_opts(render.get_parser(), ["--imgs_per_gpu=8", "--mask_wt", "0.5"])
    assert (opts["imgs_per_gpu"], opts["mask_wt"]) == (8, 0.5)
