"""The program's spans, its per-unit records of them, and Chrome traces.
The port's counterpart of lab4d_tpu/utils/profile.py.

A span (`span(name)`, or `record_function(name)` on a function) adds the
host seconds of its block (time.perf_counter) to the record of the unit
of work that the calling thread has open: one record per training step
(kind "step", engine/trainer.py), per rendered frame ("frame",
render.py) and per training round ("round"). A record is a dict {span:
host seconds}; a span that runs several times in a unit adds up, and
nested spans each record their own time. Units of one thread nest, and a
span goes to the innermost one open when it starts. A span on a thread
with no open unit (a loader worker, autograd's backward thread) records
nothing. Each kind keeps its last RING closed records (`records`).

The recorder is always on. A span reads no flag, synchronises nothing and
touches no device: untraced it costs two clock reads and a dict add.
While a torch profiler is active it also opens a
torch.profiler.record_function range of its name, so that a trace shows
the span beside the host ops and kernels it launched, on the profiler's
clock. `cuda_profile` writes such a trace (the train CLI's --profile, one
per round).

Parity: lab4d/utils/profile_utils.py, whose record_function wraps
functions in profiler ranges and whose torch_profile dumps a Chrome trace
per round (profile_utils.py:12-51, 113-161). Spans are placed by hand
here; nothing decorates a whole class or module.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 4096  # closed records kept per kind

_rings: Dict[str, deque] = {}
_clock = time.perf_counter


class _Units(threading.local):
    def __init__(self):
        self.units: List[tuple] = []  # the thread's open (kind, record), innermost last


_local = _Units()


class span:
    """Context manager: the block's host seconds go to the calling thread's
    innermost open unit, under `name`."""

    __slots__ = ("name", "record", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        units = _local.units
        self.record = units[-1][1] if units else None
        self.range = None
        self.t0 = _clock()
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.record is not None:
            self.record[self.name] = self.record.get(self.name, 0.0) + _clock() - self.t0
        return False


def record_function(name: str):
    """Decorator: each call of the function is a span named `name`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def begin_unit(kind: str) -> Dict[str, float]:
    """Open the calling thread's next record of `kind`. Where its innermost
    open unit is of the same kind, that one is closed first (consecutive
    steps); else the new unit nests inside it. Returns the new record."""
    units = _local.units
    if units and units[-1][0] == kind:
        end_unit(kind)
    record: Dict[str, float] = {}
    units.append((kind, record))
    return record


def end_unit(kind: str) -> Optional[Dict[str, float]]:
    """Close the calling thread's innermost open unit if it is of `kind`;
    returns its record (None where it is not)."""
    units = _local.units
    if not units or units[-1][0] != kind:
        return None
    _, record = units.pop()
    _rings.setdefault(kind, deque(maxlen=RING)).append(record)
    return record


@contextlib.contextmanager
def unit(kind: str):
    """A unit of `kind` around the block; yields its record."""
    record = begin_unit(kind)
    try:
        yield record
    finally:
        end_unit(kind)


def records(kind: str, n: Optional[int] = None) -> List[Dict[str, float]]:
    """The last `n` closed records of `kind` (all that are kept: None),
    oldest first."""
    ring = list(_rings.get(kind, ()))
    return ring if n is None else ring[max(0, len(ring) - n):]


@contextlib.contextmanager
def cuda_profile(save_dir: str, tag: str, enabled: bool = True):
    """Context manager dumping a Chrome trace (chrome://tracing, Perfetto)
    of the host, its spans and, where there is one, the CUDA device to
    <save_dir>/trace_<tag>.json (parity: torch_profile,
    profile_utils.py:113-161)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"trace_{tag}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")
