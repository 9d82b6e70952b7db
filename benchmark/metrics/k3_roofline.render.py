"""K3f (fused_relu_mlp): the share of its ceiling reached in the traced
frames."""
from benchmark.metrics.common import roofline


def read(run):
    return roofline(run, ("k3f",))
