"""The program's own span records (lab4d_tpu_torch/utils/profile.py) over
the window: one record per training step ("step") or rendered frame
("frame"), each {span: host seconds}.

run.py runs the window, then the traced segment twice (the device alone,
then with the host's ops), each of run.segment_units units, and no
program code after them; so the window's records are the N + 2U last but
the 2U last, N the window's steps or frames. A program without the
records gives None, as does an untraced run, a ring holding fewer
records, or a span that no record of the window holds.
"""

from __future__ import annotations

WINDOW_COUNT = {"step": "steps", "frame": "frames"}


def window_records(run, kind):
    """The window's records of `kind`, oldest first, or None."""
    units = run.segment_units
    n = run.window.get(WINDOW_COUNT[kind])
    if units is None or not n:
        return None
    try:
        from lab4d_tpu_torch.utils import profile
        records = profile.records(kind, n + 2 * units)
    except (ImportError, AttributeError):
        return None
    if len(records) < n + 2 * units:
        return None
    return records[: len(records) - 2 * units]


def mean_ms(run, kind, span):
    """The span's host ms per unit of the window (0 in a unit without it)."""
    records = window_records(run, kind)
    if not records or not any(span in r for r in records):
        return None
    return sum(r.get(span, 0.0) for r in records) / len(records) * 1e3
