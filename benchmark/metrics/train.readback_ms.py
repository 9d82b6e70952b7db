"""Host ms per step reading losses and norms back (the program's span
train.readback: every 10th step's drain and the round-end synchronise),
over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "step", "train.readback")
