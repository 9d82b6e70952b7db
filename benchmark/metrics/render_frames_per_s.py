"""Frames finished in the window over the window's seconds (host clock;
each frame's channels are on the host when render_batch returns)."""
from benchmark.metrics.common import rate


def read(run):
    return rate(run, "frames")
