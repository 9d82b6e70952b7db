"""Host ms per step in Trainer.batch_to_device (the program's span
train.to_device), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "step", "train.to_device")
