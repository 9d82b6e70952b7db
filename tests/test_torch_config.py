"""Flag validation at startup: the port's config_hier.validate against
lab4d_tpu/config_hier.py's, and the CLIs that call it.

- a table of flat flag dicts (valid, a missing key, wrong types, an int
  for a float, a bad field_type, unknown warps, each non-positive count):
  the port accepts exactly what the JAX package accepts and raises the
  same exception type where it raises;
- flagfile.absl_flags of the train parser's defaults is the flat dict of
  the JAX flags' defaults, and validates;
- `python -m lab4d_tpu_torch.train --imgs_per_gpu 0 --device cpu` fails
  before it writes anything; render, export and reanimate refuse a bad
  warp before they read a checkpoint;
- `--profile` cuts a round to 10 iterations and writes one Chrome trace
  per round, which holds the step's spans, and the round's
  metrics.jsonl step records are the JAX trainer's: the loss dict with
  "total" and "grad_norm", keys sorted, every 10th step.
"""

import json
import os
import subprocess
import sys

import pytest

from lab4d_tpu import config_hier as jax_config
from lab4d_tpu_torch import config_hier, flagfile
from lab4d_tpu_torch import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = ("num_rounds", "iters_per_round", "imgs_per_gpu", "pixels_per_image", "ngpu",
          "video_shards", "train_res")


def _valid():
    return jax_config.Config().to_opts()


def _case(**changes):
    flat = _valid()
    for k, v in changes.items():
        if v is KeyError:
            del flat[k]
        else:
            flat[k] = v
    return flat


CASES = {
    "valid": _case(),
    "valid-comp": _case(field_type="comp", fg_motion="comp_skel-human_dense"),
    "valid-skel-prefix": _case(fg_motion="skel-dog"),
    "missing-seqname": _case(seqname=KeyError),
    "missing-profile": _case(profile=KeyError),
    "missing-reg_eikonal_wt": _case(reg_eikonal_wt=KeyError),
    "str-for-int": _case(num_rounds="3"),
    "float-for-int": _case(imgs_per_gpu=4.0),
    "int-for-float": _case(learning_rate=1),
    "str-for-bool": _case(single_inst="yes"),
    "int-for-str": _case(seqname=3),
    "bad-field_type": _case(field_type="fgbg"),
    "unknown-fg_motion": _case(fg_motion="wiggle"),
    "unknown-comp-prefix": _case(fg_motion="compose"),
    **{f"{k}={v}": _case(**{k: v}) for k in COUNTS for v in (0, -1)},
}


def _outcome(validate, flat):
    try:
        validate(dict(flat))
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("name", sorted(CASES))
def test_validate_matches_jax(name):
    flat = CASES[name]
    want = _outcome(jax_config.validate, flat)
    assert _outcome(config_hier.validate, flat) is want
    accepted = name.startswith("valid") or name == "int-for-float"
    assert (want is None) == accepted


def test_schema_defaults_match_jax():
    assert config_hier.Config().to_opts() == jax_config.Config().to_opts()


def test_absl_flags_of_the_train_defaults_validate():
    opts = vars(train_cli.get_parser().parse_args([]))
    flat = flagfile.absl_flags(opts)
    assert flat == {**flagfile.JAX_CONFIG_FLAGS, "use_cpu": False}
    assert set(flat) == set(_valid())
    config_hier.validate(flat)
    jax_config.validate(flat)


def test_check_opts_rejects_what_jax_rejects():
    parse = train_cli.get_parser().parse_args
    for argv in (["--imgs_per_gpu", "0"], ["--num_rounds", "-1"], ["--train_res", "0"],
                 ["--field_type", "fgbg"], ["--fg_motion", "wiggle"]):
        with pytest.raises(ValueError):
            train_cli.check_opts(vars(parse(argv)))


def test_train_cli_fails_at_startup(tmp_path):
    logroot = tmp_path / "logdir"
    res = subprocess.run(
        [sys.executable, "-m", "lab4d_tpu_torch.train", "--imgs_per_gpu", "0", "--device", "cpu",
         "--logroot", str(logroot), "--database_root", str(tmp_path / "none")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "imgs_per_gpu must be positive" in res.stderr
    assert not logroot.exists()  # refused before opts.log or the data


@pytest.mark.parametrize("app", ["render", "export", "reanimate"])
def test_apps_refuse_a_bad_warp(app, tmp_path):
    import importlib

    main = importlib.import_module(f"lab4d_tpu_torch.{app}").main
    with pytest.raises(ValueError, match="fg_motion"):
        main(["--fg_motion", "wiggle", "--device", "cpu", "--logroot", str(tmp_path)])


@pytest.fixture(scope="module")
def profile_run(tmp_path_factory):
    from lab4d_tpu_torch.tools.synthetic_scene import make_synthetic_dataset

    root = tmp_path_factory.mktemp("profile")
    make_synthetic_dataset(str(root / "database"), seqname="prof", num_frames=8, res=16)
    trainer = train_cli.main([
        "--field_type", "bg", "--seqname", "prof", "--logname", "p", "--train_res", "16",
        "--num_rounds", "2", "--iters_per_round", "3", "--imgs_per_gpu", "2",
        "--pixels_per_image", "4", "--geo_init_steps", "2", "--save_freq", "1",
        "--eval_res", "4", "--profile", "--device", "cpu",
        "--database_root", str(root / "database"), "--logroot", str(root / "logdir")])
    return trainer, root / "logdir" / "prof-p"


def test_profile_runs_ten_iterations_per_round(profile_run):
    trainer, _ = profile_run
    assert trainer.opts["iters_per_round"] == 10
    assert trainer.current_steps == 20
    assert trainer.total_steps == 2 * 10  # the schedule's horizon too, as in JAX


def test_metrics_step_records_are_jax_trainers(profile_run):
    trainer, run_dir = profile_run
    records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    steps = [r for r in records if "total" in r]
    assert [r["step"] for r in steps] == [0, 10]
    for r in steps:
        keys = [k for k in r if k != "step"]
        assert keys == sorted(keys) and "grad_norm" in keys
        assert list(r)[0] == "step"
    evals = [r for r in records if "eval/psnr" in r]
    assert [r["step"] for r in evals] == [0, 1]


def test_profile_writes_a_trace_per_round(profile_run):
    _, run_dir = profile_run
    for n in range(2):
        trace = json.loads((run_dir / f"trace_round_{n:03d}.json").read_text())
        names = [e.get("name") for e in trace["traceEvents"]]
        assert names.count("train.forward") == 10
        assert {"train.backward", "train.optimizer", "train.draws"} <= set(names)
