"""The device trace of a traced run: torch.profiler over a fixed segment,
reduced to what the per-layer metrics read.

`analyse` takes the profiler's Chrome-trace JSON and returns:
- busy_s: the union of the device's busy intervals (kernels, copies,
  sets), so that overlapping work counts once; window_s: the segment's
  length on the host clock;
- span_device_s: device seconds by benchmark span, each kernel attributed
  to the innermost "bench:" range open on the thread that launched it
  (the launch found by the kernel's correlation id), "" for none;
- mm_flops: the operations of the matrix products PyTorch ran (aten::mm,
  addmm, bmm, baddbmm, from their recorded input shapes), by the innermost
  benchmark span they ran in;
- device_ops / idle_gaps: the device operations that took most time, and
  the idle gaps between busy intervals summed by what the host's main
  thread was doing then (the innermost benchmark span or, outside one,
  the outermost PyTorch op), seconds, ten of each.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench:"
_warm = False  # whether this process has started the profiler once


def _dims(arg) -> List[List[int]]:
    return [list(d) if isinstance(d, (list, tuple)) else [] for d in (arg or [])]


def mm_flops(name: str, dims: List[List[int]]) -> float:
    """Operations of one matrix product from its input shapes (0 if unknown)."""
    try:
        if name == "aten::mm":
            (m, k), (_, n) = dims[0], dims[1]
            return 2.0 * m * k * n
        if name == "aten::addmm":
            (m, k), (_, n) = dims[1], dims[2]
            return 2.0 * m * k * n
        if name == "aten::bmm":
            (b, m, k), (_, _, n) = dims[0], dims[1]
            return 2.0 * b * m * k * n
        if name == "aten::baddbmm":
            (b, m, k), (_, _, n) = dims[1], dims[2]
            return 2.0 * b * m * k * n
    except (ValueError, IndexError, TypeError):
        return 0.0
    return 0.0


def union_seconds(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, merged intervals) of (start, end) intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


class _Ranges:
    """Closed ranges of one thread, for the innermost one around a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)  # (start, end, name)
        self.starts = [r[0] for r in self.ranges]

    def innermost(self, t):
        i = bisect.bisect_right(self.starts, t)
        for s, e, name in reversed(self.ranges[max(0, i - 128):i]):
            if s <= t <= e:  # the latest-opened range around t is the innermost
                return name
        return None

    def outermost(self, t):
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, name in self.ranges[max(0, i - 4096):i]:
            if s <= t <= e and (best is None or s < best[0]):
                best = (s, e, name)
        return None if best is None else best[2]


def analyse(trace: Dict, window_s: float, top: int = 10) -> Dict:
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    device, launches = [], {}
    spans, ops = defaultdict(list), defaultdict(list)
    products = []  # (tid, ts, flops) of each matrix product
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", ""), args.get("correlation")))
        elif cat in LAUNCH_CATS:
            if args.get("correlation") is not None:
                launches[args["correlation"]] = (ts, ev.get("tid"))
        elif cat == "user_annotation" and ev.get("name", "").startswith(PREFIX):
            spans[ev.get("tid")].append((ts, ts + dur, ev["name"][len(PREFIX):]))
        elif cat == "cpu_op":
            name = ev.get("name", "")
            ops[ev.get("tid")].append((ts, ts + dur, name))
            if name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"):
                products.append((ev.get("tid"), ts, mm_flops(name, _dims(args.get("Input Dims")))))
    span_ranges = {tid: _Ranges(r) for tid, r in spans.items()}
    mm_by_span = defaultdict(float)
    for tid, ts, f in products:
        label = span_ranges[tid].innermost(ts) if tid in span_ranges else None
        mm_by_span[label or ""] += f
    span_device = defaultdict(float)
    by_name = defaultdict(float)
    for s, e, name, corr in device:
        by_name[name] += (e - s) * 1e-6
        launch = launches.get(corr)
        label = ""
        if launch is not None and launch[1] in span_ranges:
            label = span_ranges[launch[1]].innermost(launch[0]) or ""
        span_device[label] += (e - s) * 1e-6
    busy_us, merged = union_seconds([(s, e) for s, e, _, _ in device])
    # the main thread: the one with the most benchmark spans, else the most ops
    main = max(spans, key=lambda t: len(spans[t])) if spans else (
        max(ops, key=lambda t: len(ops[t])) if ops else None)
    main_spans = span_ranges.get(main)
    main_ops = _Ranges(ops.get(main, []))
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = (main_spans.innermost(mid) if main_spans else None)
        label = PREFIX + label if label else (main_ops.outermost(mid) or "host")
        gaps[label] += (s1 - e0) * 1e-6
    first_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "device_s": sum(by_name.values()),
        "span_device_s": dict(span_device),
        "mm_flops": dict(mm_by_span),
        "device_ops": [[n, v] for n, v in first_ops],
        "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        "n_device_events": len(device),
    }


def profile(fn: Callable[[], None], sync: Callable[[], None], light: bool = False) -> Dict:
    """Run fn under torch.profiler and analyse its trace. light: the device
    alone (kernels, copies and the launches' runtime calls), whose cost to
    the host is small, for the busy and idle times; else the host's ops
    too, with their input shapes and the benchmark's spans, for the
    attribution of device time and the products, at several times the
    host's cost. The trace goes through a temporary file under TMPDIR,
    removed after."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    acts = cuda if light and cuda else [ProfilerActivity.CPU] + cuda
    global _warm
    if not _warm:
        # the profiler's first start in a process starts its tracer
        # (CUPTI on the card): a throwaway one keeps that out of window_s
        with torch_profile(activities=acts):
            torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
            sync()
        _warm = True
    with torch_profile(activities=acts, record_shapes=not light) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return analyse(trace, window_s)
