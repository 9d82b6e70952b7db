"""K1 + K2 (fused_nerf_heads and its backward): the share of their ceiling
reached in the traced segment of training."""
from benchmark.metrics.common import roofline


def read(run):
    return roofline(run, ("k1", "k2"))
