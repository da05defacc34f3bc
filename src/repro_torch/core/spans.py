"""Host-clock spans and counters: the one way the port opens a named
range.

``with span(name):`` adds the span's *self time* (its ``perf_counter``
duration less the time of the spans opened inside it) under ``name`` to
the current :class:`Tally`, and opens ``torch.profiler.record_function``
only while a profiler is recording, so a trace shows every span on the
profiler's clock.  ``count(name, n)`` adds to the current tally's
counters.  With no tally open a span keeps only its nesting, and costs
two clock reads.

Spans nest along a *chain*.  The thread that steps a session and
autograd's device threads, which run its backward while it waits, share
one chain, so a fleet GEMM's span in the backward is a child of the
step's ``ps.backward``.  A thread that tallies beside them (the deferred
Freivalds worker, the dataflow dispatch's workers) opens its own with
``collect(own=True)``.

``collect()`` opens a tally on the current chain; spans and counts land
in the innermost one, and a nested tally adds itself to the one around
it when it closes: a GEMM's report holds its own, the step's holds them
all.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

import torch


class Tally:
    """Self seconds by span name and counts by counter name."""
    __slots__ = ("spans", "counters")

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}


def fold(spans: Dict[str, float], counters: Dict[str, int],
         tally: Tally) -> None:
    """Add ``tally`` into a report's ``spans`` and ``counters``."""
    for k, v in tally.spans.items():
        spans[k] = spans.get(k, 0.0) + v
    for k, v in tally.counters.items():
        counters[k] = counters.get(k, 0) + v


class _Chain:
    __slots__ = ("tally", "top")

    def __init__(self):
        self.tally: Optional[Tally] = None
        self.top: Optional[span] = None


class _Own(threading.local):
    chain: Optional[_Chain] = None      # a class default: no lookup fails


_shared = _Chain()
_own = _Own()


def _chain() -> _Chain:
    return _own.chain or _shared


class span:
    """``with span("fleet.plan"):`` -- see the module docstring."""
    __slots__ = ("name", "_chain", "_parent", "_child", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        c = self._chain = _chain()
        self._parent, c.top = c.top, self
        self._child = 0.0
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        c = self._chain
        c.top = self._parent
        if self._parent is not None:
            self._parent._child += dt
        t = c.tally
        if t is not None:
            t.spans[self.name] = t.spans.get(self.name, 0.0) + dt \
                - self._child


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current tally's counter ``name``."""
    t = _chain().tally
    if t is not None:
        t.counters[name] = t.counters.get(name, 0) + n


@contextlib.contextmanager
def collect(own: bool = False) -> Iterator[Tally]:
    """Open a tally for the extent of the block and yield it.  With
    ``own`` the block runs on a chain of this thread's own, and the tally
    is added to no other: the caller joins it."""
    if own:
        prev_own = _own.chain
        c = _own.chain = _Chain()
    else:
        c = _chain()
    outer = c.tally
    t = c.tally = Tally()
    try:
        yield t
    finally:
        if own:
            _own.chain = prev_own
        else:
            c.tally = outer
            if outer is not None:
                fold(outer.spans, outer.counters, t)


def merge(tally: Tally) -> None:
    """Add a tally collected on another chain to the current one."""
    t = _chain().tally
    if t is not None:
        fold(t.spans, t.counters, tally)
