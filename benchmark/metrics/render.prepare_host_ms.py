"""Host ms per frame in prepare_eval_samples (the program's span
render.prepare), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "frame", "render.prepare")
