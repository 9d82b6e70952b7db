"""The share of the traced segment of training in which the device ran
nothing (1 - the union of its busy intervals over the segment)."""
from benchmark.metrics.common import idle_share


def read(run):
    return idle_share(run)
