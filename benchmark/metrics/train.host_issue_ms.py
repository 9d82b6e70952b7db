"""Host ms per step inside Trainer.train_step (its span), over the window."""
from benchmark.metrics.common import mean_ms


def read(run):
    return mean_ms(run, "train_step")
