"""The readers of the program's own spans (benchmark/metrics/program.py):
the window's slice of the program's step and frame records, None where
there is nothing to read, and a tiny traced CPU run of each loop."""

import os

import pytest

from benchmark import run as run_mod
from benchmark.spans import load_file
from benchmark.tests.conftest import ROOT, TINY
from lab4d_tpu_torch.utils import profile

SEED = 2**31 + 4242
TRAIN = ("train.to_device_ms", "train.forward_host_ms", "train.draws_host_ms",
         "train.backward_host_ms", "train.optimizer_host_ms", "train.readback_ms")
RENDER = ("render.prepare_host_ms", "render.evaluate_host_ms", "render.readback_ms")


def _reader(name):
    return load_file(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"), f"p_{name}").read


def _push(kind, records):
    for values in records:
        profile.begin_unit(kind).update(values)
        profile.end_unit(kind)


def _run(window, segment_units):
    run = run_mod.Run({"name": "x"}, {}, {}, 1, 1.0, 1, None)
    run.window = window
    run.segment_units = segment_units
    return run


@pytest.fixture
def rings(monkeypatch):
    monkeypatch.setattr(profile, "_rings", {})


def test_window_slice_on_synthetic_records(rings):
    """Set-up, a window of N = 4 steps, then the two traced segments of U = 2."""
    _push("step", [{"train.forward": 1.0, "train.readback": 1.0}] * 3)  # set-up
    _push("step", [{"train.forward": f, "train.to_device": 0.002} for f in (0.010, 0.020, 0.030)])
    _push("step", [{"train.forward": 0.040, "train.to_device": 0.002, "train.readback": 0.008}])
    _push("step", [{"train.forward": 9.0, "train.draws": 9.0, "train.readback": 9.0}] * 4)
    run = _run({"steps": 4, "elapsed": 1.0}, 2)
    assert _reader("train.forward_host_ms")(run) == pytest.approx(25.0)
    assert _reader("train.to_device_ms")(run) == pytest.approx(2.0)
    assert _reader("train.readback_ms")(run) == pytest.approx(2.0)  # absent counts as 0
    assert _reader("train.draws_host_ms")(run) is None  # in no record of the window
    _push("frame", [{"render.prepare": 0.5}] + [{"render.prepare": 0.004,
                                                 "render.evaluate": 0.1}] * 2
          + [{"render.prepare": 7.0, "render.readback": 7.0}] * 2)
    run = _run({"frames": 2, "elapsed": 1.0}, 1)
    assert _reader("render.prepare_host_ms")(run) == pytest.approx(4.0)
    assert _reader("render.evaluate_host_ms")(run) == pytest.approx(100.0)
    assert _reader("render.readback_ms")(run) is None


def test_none_when_untraced_or_too_few_records(rings, monkeypatch):
    _push("step", [{"train.forward": 0.01}] * 5)
    _push("frame", [{"render.prepare": 0.01}] * 5)
    assert _reader("train.forward_host_ms")(_run({"steps": 3}, None)) is None  # untraced
    assert _reader("train.forward_host_ms")(_run({"steps": 4}, 1)) is None  # 6 > 5 records
    assert _reader("train.forward_host_ms")(_run({"steps": 3}, 1)) == pytest.approx(10.0)
    assert _reader("render.prepare_host_ms")(_run({"frames": 2}, 2)) is None
    assert _reader("render.prepare_host_ms")(_run({}, 1)) is None  # a window of no frames
    monkeypatch.delattr(profile, "records")  # a program without the records
    assert _reader("train.forward_host_ms")(_run({"steps": 3}, 1)) is None


@pytest.mark.parametrize("cell,names", [("dense.train", TRAIN), ("dense.render-topk", RENDER)])
def test_traced_cpu_run_reports_the_spans(cell, names, torch_threads):
    args = run_mod.parse_args(["--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
                               "--trace", "1"])
    res = run_mod.run_cell(args, device="cpu", overrides=TINY[cell.split(".")[1].split("-")[0]])
    assert res["correct"]
    for name in names:
        assert res["metrics"][name]["value"] > 0, name
        assert res["metrics"][name]["unit"] == "ms"
    if cell == "dense.train":
        m = {k: v["value"] for k, v in res["metrics"].items()}
        parts = m["train.forward_host_ms"] + m["train.backward_host_ms"] + m[
            "train.optimizer_host_ms"]
        assert parts <= m["train.host_issue_ms"] * 1.001  # the three partition train_step
        assert m["train.draws_host_ms"] < m["train.forward_host_ms"]
