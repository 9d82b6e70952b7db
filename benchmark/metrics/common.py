"""What the metric readers share. A reader's read(run) returns the metric's
value, or None where the run holds nothing to read it from."""

from __future__ import annotations

import statistics

from benchmark.peaks import PEAK_FP32_PRODUCTS, ceiling_s
from benchmark.spans import KERNEL_SPANS


def rate(run, key):
    w = run.window
    if key not in w or not w.get("elapsed"):
        return None
    return w[key] / w["elapsed"]


def mean_ms(run, span):
    if run.spans is None or not run.spans.seconds.get(span):
        return None
    return statistics.fmean(run.spans.seconds[span]) * 1e3


def plain_device_ms(run):
    """Device ms per unit (step or frame) of the traced segment outside the
    kernel entries' calls."""
    seg = run.segment
    if seg is None or not run.segment_units:
        return None
    in_kernels = sum(seg["span_device_s"].get(s, 0.0) for s in KERNEL_SPANS)
    return (seg["device_s"] - in_kernels) / run.segment_units * 1e3


def roofline(run, spans):
    """The share of their ceiling (benchmark/peaks.py) that the calls of
    these spans reached in the traced segment, %."""
    seg = run.segment
    if seg is None or run.spans is None:
        return None
    calls = [w for s in spans for w in run.spans.work.get(s, [])]
    device = sum(seg["span_device_s"].get(s, 0.0) for s in spans)
    if not calls or device <= 0:
        return None
    return sum(ceiling_s(f, b) for f, b in calls) / device * 100.0


def idle_share(run):
    """From the device-only trace of the segment, %."""
    seg = run.light
    if seg is None or seg["window_s"] <= 0 or seg["busy_s"] <= 0:
        return None
    return (1.0 - seg["busy_s"] / seg["window_s"]) * 100.0


def mfu(run):
    """Every MLP product of the traced segment (the kernel entries' from
    their shapes, PyTorch's own matrix products outside them from the
    trace with the host's ops) over the segment's time in the device-only
    trace, whose host runs at its untraced pace, at the fp32 product rate, %."""
    seg, light = run.segment, run.light
    if seg is None or light is None or run.spans is None or light["window_s"] <= 0:
        return None
    flops = sum(f for s in KERNEL_SPANS for f, _ in run.spans.work.get(s, []))
    flops += sum(f for s, f in seg["mm_flops"].items() if s not in KERNEL_SPANS)
    if flops <= 0:
        return None
    return flops / (PEAK_FP32_PRODUCTS * light["window_s"]) * 100.0


def p95(values):
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[18]
