"""The trace reduction and every metric reader on a synthetic trace."""

import os

import pytest

from benchmark import run as run_mod
from benchmark import trace as trace_mod
from benchmark.peaks import ceiling_s
from benchmark.spans import Recorder, load_file
from benchmark.tests.conftest import ROOT


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def synthetic_trace():
    """Main thread 1: a train_step span around a k3f span; backward thread
    2: a k3b span. Kernels: k3f's (correlation 1), k3b's (2), a plain one
    launched inside train_step (3), one in next_batch (4), one
    overlapping kernel on another stream (5)."""
    ev = [
        _x("bench:train_step", "user_annotation", 0, 1000),
        _x("bench:k3f", "user_annotation", 100, 100),
        _x("bench:k3b", "user_annotation", 300, 100, tid=2),
        _x("bench:next_batch", "user_annotation", 1100, 380),
        _x("aten::addmm", "cpu_op", 500, 10, **{"Input Dims": [[64], [1000, 32], [32, 64]]}),
        _x("aten::mm", "cpu_op", 120, 10, **{"Input Dims": [[10, 10], [10, 10]]}),
        _x("aten::linear", "cpu_op", 499, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 350, 5, tid=2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 600, 5, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", 1200, 5, correlation=4),
        _x("cudaLaunchKernel", "cuda_runtime", 610, 5, correlation=5),
        _x("rw_kernel", "kernel", 200, 400, tid=7, correlation=1),
        _x("rw_dw_kernel", "kernel", 700, 200, tid=7, correlation=2),
        _x("elementwise", "kernel", 900, 100, tid=7, correlation=3),
        _x("elementwise", "kernel", 1500, 100, tid=7, correlation=4),
        _x("copy", "gpu_memcpy", 950, 100, tid=8, correlation=5),
    ]
    return {"traceEvents": ev}


def test_analyse_synthetic():
    a = trace_mod.analyse(synthetic_trace(), window_s=2000e-6)
    assert a["busy_s"] == pytest.approx((400 + 350 + 100) * 1e-6)
    assert a["device_s"] == pytest.approx((400 + 200 + 100 + 100 + 100) * 1e-6)
    sd = a["span_device_s"]
    assert sd["k3f"] == pytest.approx(400e-6) and sd["k3b"] == pytest.approx(200e-6)
    assert sd["train_step"] == pytest.approx(200e-6) and sd["next_batch"] == pytest.approx(100e-6)
    assert a["mm_flops"] == {"train_step": 2.0 * 1000 * 32 * 64, "k3f": 2000.0}
    assert a["device_ops"][0] == ["rw_kernel", pytest.approx(400e-6)]
    gaps = dict((k, v) for k, v in a["idle_gaps"])
    assert gaps == {"bench:next_batch": pytest.approx(450e-6),
                    "bench:train_step": pytest.approx(100e-6)}


def test_mm_flops_shapes():
    assert trace_mod.mm_flops("aten::bmm", [[4, 2, 3], [4, 3, 5]]) == 2.0 * 4 * 2 * 3 * 5
    assert trace_mod.mm_flops("aten::baddbmm", [[4, 2, 5], [4, 2, 3], [4, 3, 5]]) == 240.0
    assert trace_mod.mm_flops("aten::mm", [[]]) == 0.0


def _reader(name):
    return load_file(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"), f"t_{name}").read


def test_every_metric_has_a_reader():
    import json

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(_reader(m["name"]))


def test_readers_on_synthetic_run():
    run = run_mod.Run({"name": "x"}, {}, {}, 1, 1.0, 1, None)
    run.setup_s = 12.5
    run.window = {"elapsed": 2.0, "rays": 8192, "frames": 4, "steps": 2}
    run.counters = {"step_ms": [float(i) for i in range(1, 101)]}
    rec = Recorder()
    rec.seconds["train_step"] = [0.010, 0.030]
    rec.seconds["next_batch"] = [0.001, 0.003]
    rec.work["k3f"] = [(1e9, 1e6)]
    rec.work["k3b"] = [(2e9, 2e6)]
    run.spans = rec
    run.segment = trace_mod.analyse(synthetic_trace(), window_s=2000e-6)
    run.light = dict(run.segment, busy_s=1500e-6, window_s=2000e-6)
    run.segment_units = 2
    assert _reader("train_rays_per_s")(run) == 4096.0
    assert _reader("render_frames_per_s")(run) == 2.0
    assert _reader("setup_s")(run) == 12.5
    assert _reader("train.step_p95_ms")(run) == pytest.approx(95.95)
    assert _reader("train.host_issue_ms")(run) == pytest.approx(20.0)
    assert _reader("train.loader_wait_ms")(run) == pytest.approx(2.0)
    plain = (900e-6 - 600e-6) / 2 * 1e3
    assert _reader("train.plain_device_ms")(run) == pytest.approx(plain)
    assert _reader("render.plain_device_ms")(run) == pytest.approx(plain)
    k3 = (ceiling_s(1e9, 1e6) + ceiling_s(2e9, 2e6)) / 600e-6 * 100
    assert _reader("k3_roofline.train")(run) == pytest.approx(k3)
    assert _reader("k3_roofline.render")(run) == pytest.approx(ceiling_s(1e9, 1e6) / 400e-6 * 100)
    assert _reader("heads_roofline.train")(run) is None  # no K1 / K2 call: nothing to read
    assert _reader("idle_share.train")(run) == pytest.approx(25.0)
    assert _reader("idle_share.render")(run) == pytest.approx(25.0)
    flops = 3e9 + 2.0 * 1000 * 32 * 64  # the k3 calls', and the product outside them
    mfu = flops / (495e12 / 3 * 2000e-6) * 100
    assert _reader("mfu.train")(run) == pytest.approx(mfu)
    assert _reader("mfu.render")(run) == pytest.approx(mfu)


def test_readers_on_untraced_run_return_none():
    run = run_mod.Run({"name": "x"}, {}, {}, 1, 1.0, 0, None)
    for name in ("train.host_issue_ms", "train.plain_device_ms", "k3_roofline.train",
                 "idle_share.train", "mfu.train", "train.step_p95_ms"):
        assert _reader(name)(run) is None
