"""Host ms per step issuing the backward (the program's span train.backward:
the loss sum, zero_grad, backward()), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "step", "train.backward")
