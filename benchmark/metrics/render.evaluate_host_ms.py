"""Host ms per frame in the frame's evaluate_rays calls (the program's span
render.evaluate), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "frame", "render.evaluate")
