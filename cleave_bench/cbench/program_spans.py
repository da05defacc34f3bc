"""Per-step means of the program's host-clock spans and counters: the
``spans`` (self seconds by name) and ``counters`` of each report of the
window (the port's ``FleetStepReport``).  A program whose reports carry
neither gives ``None``, so the metrics that read them fall silent."""
from __future__ import annotations

from typing import Callable, Optional


def per_step(ctx, field: str, keep: Callable[[str], bool]) -> Optional[float]:
    """The mean over the window's reports of the sum of the entries of
    ``field`` (``"spans"`` or ``"counters"``) whose names ``keep``
    accepts; a name a report lacks counts 0."""
    tallies = [getattr(r, field, None) for r in ctx.reports]
    if not tallies or any(t is None for t in tallies):
        return None
    return sum(v for t in tallies for k, v in t.items() if keep(k)) \
        / len(tallies)


def span_ms(ctx, *names: str) -> Optional[float]:
    """Milliseconds a step of the self times of ``names``."""
    s = per_step(ctx, "spans", names.__contains__)
    return None if s is None else 1e3 * s


def count(ctx, *names: str) -> Optional[float]:
    """Counts a step of the counters ``names``."""
    return per_step(ctx, "counters", names.__contains__)
