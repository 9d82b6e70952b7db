"""The command line, the contract's last line, the whole-name import check
and a cell added as new files alone."""

import json
import os
import shutil

import pytest

from benchmark import run as run_mod
from benchmark.tests.conftest import ROOT, TINY

SEED = 2**31 + 12345


def test_args_parse():
    args = run_mod.parse_args(["--workload", "dense.train", "--seed", str(2**33 + 1),
                               "--seconds", "10", "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == ("dense.train", 2**33 + 1,
                                                                     10.0, 1)
    for bad in (["--workload", "x", "--seed", "1", "--seconds", "0"],
                ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
                ["--seed", "1", "--seconds", "1"]):
        with pytest.raises(SystemExit):
            run_mod.parse_args(bad)


def test_forbidden_modules_whole_names():
    mods = {"lab4d_tpu_torch": 1, "lab4d_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen": 1,
            "lab4d_tpu": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "numpy": 1}
    assert run_mod.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib.xla", "lab4d_tpu"]
    assert run_mod.forbidden_modules({"lab4d_tpu_torch": 1, "jaxtyping": 1}) == []


def test_main_without_a_card_prints_nothing(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "dense.train", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_harness_imports_no_reference_package():
    """Neither the harness nor the reference imports JAX or the JAX package,
    and the reference imports nothing of the program."""
    import ast

    here = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(here):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] not in run_mod.FORBIDDEN, (path, m)
                    if os.sep + "reference" + os.sep in path:
                        assert m.split(".")[0] != "lab4d_tpu_torch", (path, m)


def _last_line_keys(result):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_contract_last_line_train(torch_threads):
    args = run_mod.parse_args(["--workload", "dense.train", "--seed", str(SEED),
                               "--seconds", "1", "--trace", "0"])
    res = run_mod.run_cell(args, device="cpu", overrides=TINY["train"])
    _last_line_keys(res)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert res["device"]["count"] == 1


def test_contract_last_line_render_traced(torch_threads):
    args = run_mod.parse_args(["--workload", "dense.render-topk", "--seed", str(SEED),
                               "--seconds", "0.5", "--trace", "1"])
    res = run_mod.run_cell(args, device="cpu", overrides=TINY["render"])
    _last_line_keys(res)
    assert res["correct"]
    assert {"render.plain_device_ms", "mfu.render"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_cell_added_as_new_files_alone(tmp_path, torch_threads):
    """A new cell (here the exact eval of the flagship) needs only a traffic
    file, a limits file and entries in BENCHMARK.json; a new per-layer
    metric only its reader."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(root / "benchmark") for p in fs}
    traffic = json.load(open(root / "benchmark" / "traffic" / "render-topk.json"))
    traffic["topk"] = None
    json.dump(traffic, open(root / "benchmark" / "traffic" / "render-exact.json", "w"))
    json.dump({"frame_p99": {"limit": 1e-3}, "frame_mean": {"limit": 1e-3}},
              open(root / "benchmark" / "limits" / "skel-quad.render-exact.json", "w"))
    (root / "benchmark" / "metrics" / "render.frames_done.py").write_text(
        "def read(run):\n    return float(run.window['frames'])\n")
    bench["workloads"].append({"name": "skel-quad.render-exact", "config": "skel-quad",
                               "traffic": "render-exact", "chips": 1, "why": "exact eval"})
    bench["end_to_end"][1]["workloads"].append("skel-quad.render-exact")
    bench["per_layer"].append({"name": "render.frames_done", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "render loop", "moves": "render_frames_per_s",
                               "workloads": ["skel-quad.render-exact"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(root / "benchmark") for p in fs}
    assert all(after[p] == b for p, b in before.items())  # no file edited
    for trace in (0, 1):
        args = run_mod.parse_args(["--workload", "skel-quad.render-exact", "--seed", str(SEED),
                                   "--seconds", "0.2", "--trace", str(trace)])
        res = run_mod.run_cell(args, device="cpu", overrides=TINY["render"], root=str(root))
        assert res["correct"]
        if trace:
            assert res["metrics"]["render.frames_done"]["value"] >= 1
        else:
            assert "render_frames_per_s" in res["metrics"]
