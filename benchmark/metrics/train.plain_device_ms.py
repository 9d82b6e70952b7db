"""Device ms per step of the traced segment outside the kernel entries."""
from benchmark.metrics.common import plain_device_ms


def read(run):
    return plain_device_ms(run)
