"""The trace reader on a CPU profile, through this torch's events and
through events without the fields that older torch versions lack."""
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cbench import tracing


class OlderEvent:
    """A profiler event with neither ``activity_type``, ``start_ns`` nor
    ``is_user_annotation``."""

    def __init__(self, e):
        self._e = e

    def __getattr__(self, name):
        if name in ("activity_type", "start_ns", "end_ns", "duration_ns",
                    "is_user_annotation"):
            raise AttributeError(name)
        return getattr(self._e, name)

    def start_us(self):
        return self._e.start_ns() / 1000

    def duration_us(self):
        return self._e.duration_ns() / 1000


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_trace_reader_with_and_without_activity_types():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(tracing.STEP_RANGE):
                with record_function("fleet.fwd"):
                    torch.randn(64, 64) @ torch.randn(64, 64)
                time.sleep(0.005)
    new = tracing.read(prof, 2, [])
    events = [OlderEvent(e) for e in prof.profiler.kineto_results.events()]
    old = tracing.read(_Prof(events), 2, [])
    assert new.stretch_s >= 0.01 and new.busy_s == 0 and new.kernel_s == 0
    assert abs(new.stretch_s - old.stretch_s) < 1e-6
    assert [n for n, _ in new.idle_gaps] == [n for n, _ in old.idle_gaps]
    # no device work on the CPU: one idle gap, the whole stretch
    assert abs(sum(v for _, v in new.idle_gaps) - new.stretch_s) < 1e-9
