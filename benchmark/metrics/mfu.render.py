"""Every MLP product of the traced frames over their time at the
fp32 product rate (3xTF32), %."""
from benchmark.metrics.common import mfu


def read(run):
    return mfu(run)
