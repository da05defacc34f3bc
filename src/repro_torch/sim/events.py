"""Timeline-event vocabulary for the discrete-event fleet engine.

The paper's temporal claims are all *events on a shared timeline*: a device
disappearing mid-batch (§4.2 churn), a joiner folded in at the next round
(§3.2), foreground activity silently degrading a device (App. C.5), and the
PS link saturating at fleet scale (§6).  This module defines the injectable
event types and the :class:`TimelineReport` every simulation backend returns,
so callers build scenarios declaratively::

    from repro_torch.sim import events as ev
    report = rt.simulate(128, 1024, backend="event",
                         events=[ev.fail(2.0, device_id=7),
                                 ev.slowdown(5.0, device_id=3, factor=8.0),
                                 ev.join(9.0, device=new_device)])

See ``docs/SIMULATION.md`` for the event → paper-section mapping.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Union

from repro_torch.core.cost_model import Device


# ------------------------------------------------------------ event types --

@dataclass(frozen=True)
class FailEvent:
    """Device ``device_id`` vanishes at time ``t`` (mid-batch churn, §4.2).
    Its unfinished work is orphaned and re-dispatched to survivors."""
    t: float
    device_id: int


@dataclass(frozen=True)
class JoinEvent:
    """``device`` registers at time ``t`` and is folded into the fleet at
    the next level boundary — no pause of in-flight work (§3.2)."""
    t: float
    device: Device


@dataclass(frozen=True)
class SlowdownEvent:
    """Device ``device_id``'s stage times multiply by ``factor`` for work
    starting after ``t`` (hidden foreground activity, App. C.5).  A factor
    below 1 models recovery back to nominal speed."""
    t: float
    device_id: int
    factor: float


TimelineEvent = Union[FailEvent, JoinEvent, SlowdownEvent]


def fail(t: float, device_id: int) -> FailEvent:
    return FailEvent(t=float(t), device_id=int(device_id))


def join(t: float, device: Device) -> JoinEvent:
    return JoinEvent(t=float(t), device=device)


def slowdown(t: float, device_id: int, factor: float) -> SlowdownEvent:
    if factor <= 0:
        raise ValueError(f"slowdown factor must be positive, got {factor}")
    return SlowdownEvent(t=float(t), device_id=int(device_id),
                         factor=float(factor))


def validate_events(events: Sequence[TimelineEvent],
                    device_ids: Optional[Set[int]] = None
                    ) -> List[TimelineEvent]:
    """Type/time check an event list and return it sorted by time (stable,
    so same-time events keep their injection order).

    Rejections (all before any simulation starts, so a bad scenario fails
    loudly instead of deep inside the replay loop):

    * non-event objects (``TypeError``),
    * negative event times,
    * two ``FailEvent``\\ s for the same device at the same instant — the
      second can never fire (the device is already dead) and almost always
      indicates a scenario-construction bug,
    * with ``device_ids`` (the fleet known to the engine): a fail/slowdown
      targeting a device that is neither in the fleet nor introduced by a
      ``JoinEvent`` in the same script.
    """
    known = None
    if device_ids is not None:
        known = set(device_ids) | {e.device.device_id for e in events
                                   if isinstance(e, JoinEvent)}
    seen_fails: Set[tuple] = set()
    for e in events:
        if not isinstance(e, (FailEvent, JoinEvent, SlowdownEvent)):
            raise TypeError(
                f"not a timeline event: {e!r}; build events with "
                "sim.events.fail/join/slowdown")
        if e.t < 0:
            raise ValueError(f"event time must be >= 0, got {e!r}")
        if isinstance(e, FailEvent):
            key = (e.t, e.device_id)
            if key in seen_fails:
                raise ValueError(
                    f"duplicate simultaneous fail for device {e.device_id} "
                    f"at t={e.t}: a device can only fail once per instant")
            seen_fails.add(key)
        if known is not None and isinstance(e, (FailEvent, SlowdownEvent)) \
                and e.device_id not in known:
            raise ValueError(
                f"{e!r} targets unknown device {e.device_id}: not in the "
                f"engine fleet and not introduced by any join event")
    return sorted(events, key=lambda e: e.t)


# ---------------------------------------------------------------- report --

@dataclass
class TimelineReport:
    """What a simulation backend hands back — same shape whether the batch
    was priced analytically (Eq. 1/9') or replayed event-by-event."""
    backend: str                # "analytic" | "event"
    makespan: float             # batch time incl. optimizer tail (s)
    gemm_time: float = 0.0
    opt_tail: float = 0.0
    level_times: List[float] = field(default_factory=list)
    n_events: int = 0           # engine events processed (0 for analytic)
    n_items: int = 0            # work items simulated
    n_failures: int = 0
    n_joins: int = 0
    n_slowdowns: int = 0
    recovery_latency: float = 0.0   # worst failure -> patch-complete lag
    recomputed_fraction: float = 0.0
    device_busy: Dict[int, float] = field(default_factory=dict)
    ps_egress_wait: float = 0.0     # total seconds transfers queued on the
    ps_ingress_wait: float = 0.0    # shared PS link (0 = no contention)
    ps_egress_busy: float = 0.0     # integral of granted egress rate (bytes)
    ps_ingress_busy: float = 0.0
    chain_completions: Dict[int, float] = field(default_factory=dict)
    wall_time: float = 0.0          # host seconds spent simulating
    trace: Optional[List[tuple]] = None

    @property
    def events_per_sec(self) -> float:
        """Simulated-event throughput (the BENCH_core.json tracker)."""
        return self.n_events / max(self.wall_time, 1e-12)

    def utilization(self, device_id: int) -> float:
        """Busy share of the timeline for one device.  Can exceed 1 when a
        device runs concurrent chains (level-mates overlap by design)."""
        return self.device_busy.get(device_id, 0.0) / max(self.makespan,
                                                          1e-12)
