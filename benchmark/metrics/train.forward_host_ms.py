"""Host ms per step issuing the training forward (the program's span
train.forward: the model's call in Trainer.train_step), over the window."""
from benchmark.metrics.program import mean_ms


def read(run):
    return mean_ms(run, "step", "train.forward")
