"""The benchmark's spans and counters around the calls into the program's
layers, installed in traced runs only.

Each target is a function or method of the program, replaced for the run by
a wrapper that opens a `torch.profiler.record_function` range named
"bench:<span>" (so the device trace can attribute the work a call
launched), adds the call's host seconds to `Recorder.seconds[span]` and,
while `Recorder.work_on` is set, the call's operations and bytes from its
shapes (benchmark/work/<entry>.py) to `Recorder.work[span]`.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import os
import time
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX = "bench:"

# (module, attribute path, span, work function's file or None). The kernel
# entries: K3f / K3b (fused_relu_mlp), K4f / K4b (fused_pe_mlp), K1 / K2
# (fused_nerf_heads; feature.py holds its own name for the forward).
KERNEL_SPANS = {
    "k3f": "fused_relu_mlp", "k3b": "fused_relu_mlp_backward",
    "k4f": "fused_pe_mlp", "k4b": "fused_pe_mlp_backward",
    "k1": "fused_nerf_heads", "k2": "fused_nerf_heads_backward",
}
TARGETS = (
    ("lab4d_tpu_torch.engine.trainer", "Trainer.train_step", "train_step", None),
    ("lab4d_tpu_torch.engine.trainer", "Trainer.batch_to_device", "batch_to_device", None),
    ("lab4d_tpu_torch.dataloader.data_utils", "TrainBatchLoader.next_batch", "next_batch", None),
    ("lab4d_tpu_torch.render", "render_batch", "render_batch", None),
    ("lab4d_tpu_torch.ops.mlp_kernel", "fused_relu_mlp", "k3f", "fused_relu_mlp"),
    ("lab4d_tpu_torch.ops.mlp_kernel", "fused_relu_mlp_backward", "k3b", "fused_relu_mlp_backward"),
    ("lab4d_tpu_torch.ops.mlp_kernel", "fused_pe_mlp", "k4f", "fused_pe_mlp"),
    ("lab4d_tpu_torch.ops.mlp_kernel", "fused_pe_mlp_backward", "k4b", "fused_pe_mlp_backward"),
    ("lab4d_tpu_torch.ops.field_kernel", "fused_nerf_heads", "k1", "fused_nerf_heads"),
    ("lab4d_tpu_torch.nnutils.feature", "fused_nerf_heads", "k1", "fused_nerf_heads"),
    ("lab4d_tpu_torch.ops.field_kernel", "fused_nerf_heads_backward", "k2",
     "fused_nerf_heads_backward"),
)


def load_file(path: str, name: str):
    """A module from a file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def work_function(entry: str) -> Callable:
    """work(args, kwargs) -> (flops, bytes) of one call of a kernel entry."""
    return load_file(os.path.join(HERE, "work", f"{entry}.py"), f"bench_work_{entry}").work


def print_marks(marks: List[Tuple[str, float]]):
    """One line of the seconds of each phase of a set-up, from
    [(phase, perf_counter() at its end)] after a ("start", t) entry."""
    print("[setup] " + ", ".join(f"{name} {t - marks[i][1]:.2f} s"
                                 for i, (name, t) in enumerate(marks[1:])), flush=True)


class Recorder:
    def __init__(self):
        self.seconds = defaultdict(list)  # span -> host seconds of each call
        self.work = defaultdict(list)  # span -> (flops, bytes) of each call while work_on
        self.work_on = False


def _wrap(fn, span: str, work: Optional[Callable], rec: Recorder):
    label = PREFIX + span

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        with torch.profiler.record_function(label):
            out = fn(*args, **kwargs)
        rec.seconds[span].append(time.perf_counter() - t)
        if work is not None and rec.work_on:
            rec.work[span].append(work(args, kwargs))
        return out

    return wrapper


def install(rec: Recorder, targets=TARGETS) -> Callable[[], None]:
    """Wrap every target that imports; returns the function that unwraps them."""
    undo: List[Tuple[object, str, object]] = []
    for module, path, span, work in targets:
        owner = importlib.import_module(module)
        *owners, attr = path.split(".")
        for name in owners:
            owner = getattr(owner, name)
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        fn = _wrap(orig, span, work_function(work) if work else None, rec)
        setattr(owner, attr, fn)
        undo.append((owner, attr, orig))

    def uninstall():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)

    return uninstall
