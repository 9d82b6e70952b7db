"""The 95th percentile of the window's per-step times that the trainer
keeps (Trainer.step_ms: CUDA events around each train_step)."""
from benchmark.metrics.common import p95


def read(run):
    return p95(run.counters.get("step_ms", []))
