"""Tracing / profiling utilities. The port's counterpart of
lab4d_tpu/utils/profile.py.

Parity: lab4d/utils/profile_utils.py — the reference wraps
torch.profiler.record_function around every function in the package
(lab4d/__init__.py:34-63) and dumps Chrome traces per round
(profile_utils.py:113-161). Here the spans are
torch.profiler.record_function ranges (in a torch.profiler trace, on the
CPU and the card alike), and `cuda_profile` dumps a Chrome trace of the
host and the card.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import types
from typing import Optional

import torch


def record_function(name: str):
    """Decorator adding a named profiler span around a function, so it
    shows up in profiler traces (parity: profile_utils.py:12-51)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def record_class(cls):
    """Decorate every public method of a class (profile_utils.py:54-90)."""
    for attr_name, attr in list(vars(cls).items()):
        if attr_name.startswith("__"):
            continue
        if isinstance(attr, types.FunctionType):
            setattr(cls, attr_name, record_function(f"{cls.__name__}.{attr_name}")(attr))
    return cls


def decorate_module(module, recurse: bool = False):
    """Wrap all functions/classes of a module in named spans
    (profile_utils.py:93-110)."""
    for attr_name in dir(module):
        if attr_name.startswith("__"):
            continue
        attr = getattr(module, attr_name)
        if isinstance(attr, types.FunctionType) and attr.__module__ == module.__name__:
            setattr(module, attr_name, record_function(attr_name)(attr))
        elif inspect.isclass(attr) and attr.__module__ == module.__name__:
            record_class(attr)
    return module


@contextlib.contextmanager
def cuda_profile(save_dir: str, tag: str, enabled: bool = True):
    """Context manager dumping a Chrome trace (chrome://tracing, Perfetto)
    of the host and, where there is one, the CUDA device to
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


def annotate(name: Optional[str] = None):
    """Lightweight span annotation for hot functions."""

    def deco(fn):
        scope = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(scope):
                return fn(*args, **kwargs)

        return wrapper

    return deco
