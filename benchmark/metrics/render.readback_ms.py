"""Host ms per frame copying the frame's channels to the host (the program's
span render.readback: cat, reshape, .cpu()), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "frame", "render.readback")
