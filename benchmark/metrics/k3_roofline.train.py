"""K3f + K3b (fused_relu_mlp and its backward): the share of their ceiling
reached in the traced segment of training."""
from benchmark.metrics.common import roofline


def read(run):
    return roofline(run, ("k3f", "k3b"))
