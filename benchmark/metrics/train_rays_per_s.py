"""Rays trained in the window over the window's seconds (host clock, the
window ending in a synchronise)."""
from benchmark.metrics.common import rate


def read(run):
    return rate(run, "rays")
