"""utils/profile.py's recorder: spans add their host seconds to the
calling thread's innermost open unit record, each kind keeps a bounded
ring of closed records, and a span opens a profiler range only while a
profiler runs."""

import threading
import time

import torch

from lab4d_tpu_torch.utils import profile


def test_nested_spans_record_their_own_time():
    with profile.unit("test-nested") as record:
        with profile.span("outer"):
            time.sleep(0.02)
            with profile.span("inner"):
                time.sleep(0.03)
        with profile.span("inner"):  # a second call adds up
            time.sleep(0.01)
    assert profile.records("test-nested", 1) == [record]
    assert set(record) == {"outer", "inner"}
    assert record["inner"] >= 0.04
    assert record["outer"] >= 0.05
    assert record["outer"] < 0.05 + record["inner"]  # not the second inner call


def test_ring_holds_at_most_4096_records():
    assert profile.RING == 4096
    for i in range(profile.RING + 10):
        with profile.unit("test-ring"):
            with profile.span("i"):
                pass
    recs = profile.records("test-ring")
    assert len(recs) == profile.RING
    assert len(profile.records("test-ring", 5)) == 5
    assert profile.records("test-ring", 5) == recs[-5:]
    assert profile.records("test-no-such-kind", 3) == []


def test_consecutive_units_and_nesting():
    """begin_unit closes the thread's open unit of the same kind; a unit of
    another kind nests, and a span goes to the innermost unit open when it
    starts."""
    first = profile.begin_unit("test-step")
    with profile.span("a"):
        pass
    second = profile.begin_unit("test-step")
    assert profile.records("test-step", 1)[0] is first
    with profile.unit("test-frame") as frame:
        with profile.span("b"):
            pass
    with profile.span("c"):
        pass
    assert profile.end_unit("test-step") is second
    assert profile.end_unit("test-step") is None
    assert set(first) == {"a"} and set(frame) == {"b"} and set(second) == {"c"}


def test_spans_on_other_threads_are_not_added():
    def work():
        with profile.span("elsewhere"):
            pass

    with profile.unit("test-thread") as record:
        t = threading.Thread(target=work)
        t.start()
        t.join()
        with profile.span("here"):
            pass
    assert set(record) == {"here"}
    work()  # no open unit on this thread: nothing is recorded, nothing raises


def test_span_in_a_cpu_trace_only_under_the_profiler():
    with profile.span("lab4d_outside_the_profiler"):
        torch.ones(2) + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profile.span("lab4d_under_the_profiler"):
            torch.ones(2) + 1
    names = {e.key for e in prof.key_averages()}
    assert "lab4d_under_the_profiler" in names
    assert "lab4d_outside_the_profiler" not in names
