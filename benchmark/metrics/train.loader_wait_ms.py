"""Host ms per step blocked in TrainBatchLoader.next_batch (its span), over
the window."""
from benchmark.metrics.common import mean_ms


def read(run):
    return mean_ms(run, "next_batch")
