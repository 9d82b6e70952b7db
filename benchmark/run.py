"""One run of one cell of the benchmark of lab4d_tpu_torch.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(benchmark/configs/<config>.json) and its traffic
(benchmark/traffic/<traffic>.json), whose "loop" names the loop that runs
it (benchmark/loops/<loop>.py); each metric is read by
benchmark/metrics/<metric>.py. The run makes its inputs and weights from
the seed, sets up and warms the program, measures a window of --seconds,
with --trace 1 traces a fixed segment after it, then checks what the
window produced against the plain reference (benchmark/reference/), and
prints one JSON line last on standard output. It needs as many CUDA cards as
the cell asks for and exits with another code than 0, printing no result,
without them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "lab4d_tpu")


def cache_env(root: str = ROOT):
    """Build and kernel caches at fixed paths inside the checkout; a library
    that would load JAX by itself is kept from it."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "bench", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "build", "bench", "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def forbidden_modules(modules=None):
    """Loaded modules whose whole top-level name is a forbidden one."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_cell(bench: dict, name: str, root: str = ROOT):
    """(cell, configuration entry, its file's dict, traffic dict)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, cfg_entry, cfg, traffic


def cell_metrics(bench: dict, cell: str, trace: int):
    """The metrics a run of the cell reports: its end-to-end ones untraced,
    its per-layer ones traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


class Run:
    """What a metric's reader reads: the run's set-up and window, the
    loop's counters, the spans and the device trace."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device, root=ROOT):
        self.root = root
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.setup_s = None
        self.window = {}  # the loop's window: "elapsed" and its counts
        self.counters = {}  # the loop's counters (per-step device ms, ...)
        self.spans = None  # spans.Recorder in traced runs
        self.light = None  # trace.analyse() of the traced segment, the device alone
        self.segment = None  # trace.analyse() of the segment again, host ops and spans
        self.segment_units = None  # steps or frames of the traced segment


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(args, device: str = "cuda", overrides=None, root: str = ROOT, faults=()):
    """Run one cell; returns the result dict (correct, ..., checks).

    device: "cuda" on the card; tests pass "cpu", which skips the look for a
    card. overrides: entries replacing the traffic's (tests shrink it).
    faults: names of faults the loop plants in the timed path (tests).
    root: the checkout whose BENCHMARK.json and benchmark/ files define
    the cell."""
    import torch

    from benchmark import spans as spans_mod
    from benchmark import trace as trace_mod
    from benchmark.spans import load_file

    here = os.path.join(root, "benchmark")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, _, cfg, traffic = load_cell(bench, args.workload, root)
    traffic = dict(traffic, **(overrides or {}))
    dev = torch.device(device)
    run = Run(cell, cfg, traffic, args.seed, args.seconds, args.trace, dev, root)
    loop = load_file(os.path.join(here, "loops", f"{traffic['loop']}.py"),
                     f"bench_loop_{traffic['loop']}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"[setup] imports {time.perf_counter() - T_START:.2f} s", flush=True)
    state = loop.setup(run, faults=faults)
    sync()
    run.setup_s = time.perf_counter() - T_START
    uninstall = None
    if args.trace:
        run.spans = spans_mod.Recorder()
        uninstall = spans_mod.install(run.spans)
    run.window = loop.window(run, state)
    if args.trace:
        # the spans' host seconds are the window's: the segments run under
        # the profiler, whose cost to the host would count too
        window_seconds, run.spans.seconds = run.spans.seconds, defaultdict(list)
        # the same fixed segment twice: the device alone (busy and idle
        # times), then with the host's ops and the spans (attribution)
        run.segment_units = traffic["trace_units"]
        run.light = trace_mod.profile(lambda: loop.segment(run, state), sync, light=True)
        run.spans.work_on = True
        run.segment = trace_mod.profile(lambda: loop.segment(run, state), sync)
        run.spans.work_on = False
        run.spans.seconds = window_seconds
        uninstall()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counts = loop.counts(run, state)
    loop.release(run, state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = loop.check(run)
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and counts["failed"] == 0

    metrics = {}
    for m in cell_metrics(bench, cell["name"], args.trace):
        reader = load_file(os.path.join(here, "metrics", f"{m['name']}.py"),
                           f"bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    if dev.type == "cuda":
        dev_info["power"] = power_limit()
    result = {"correct": bool(correct), "attempted": counts["attempted"],
              "failed": counts["failed"], "metrics": metrics, "device": dev_info}
    if run.light is not None:
        dev_info["busy_s"] = run.light["busy_s"] / max(1, int(cell["chips"]))
        dev_info["window_s"] = run.light["window_s"]
        result["breakdown"] = {"device_ops": run.light["device_ops"],
                               "idle_gaps": run.segment["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_env()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = {w["name"]: w["chips"] for w in json.load(f)["workloads"]}.get(args.workload)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import lab4d_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (lab4d_tpu_torch) does not import: {e}", file=sys.stderr)
        return 4
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(args)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
