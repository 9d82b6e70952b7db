"""Host ms per step issuing the update (the program's span train.optimizer:
untouched gradients zero-filled, the clip, AdamW), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "step", "train.optimizer")
