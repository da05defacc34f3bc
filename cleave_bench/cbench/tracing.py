"""Reads a ``torch.profiler`` run of whole steps from the profiler's raw
events (no event tree is built, so a trace of a million events reads in
seconds): the device's busy time (the union of its kernel, copy and set
intervals), kernel time by the host ranges that launched it, the kernels
that took most time, and the longest idle gaps by what the host was
doing.

The range rule is the port's ``launch/profile_train.py``'s, copied here
so that it does not move with the program: a kernel counts in every
range open on the thread that launched it, at the time it was launched
(the port's ctypes-launched kernels are tied to the innermost range or
op open then).  A range's own span on the device timeline is not device
work."""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

STEP_RANGE = "bench.step"
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    steps: int
    stretch_s: float                 # first traced step's start to last end
    busy_s: float                    # union of device intervals in it
    kernel_s: float                  # sum of device intervals in it
    range_kernel_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    records: list = field(default_factory=list)   # the steps' GemmRecords


def merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals, as (starts, ends) of disjoint blocks."""
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.flatnonzero(s[1:] > e[:-1]) + 1
    first = np.concatenate(([0], new))
    last = np.concatenate((new - 1, [len(s) - 1]))
    return s[first], e[last]


def gaps(bs: np.ndarray, be: np.ndarray, t0: float, t1: float):
    """The idle stretches of [t0, t1] around the disjoint blocks."""
    lo = np.concatenate(([t0], be))
    hi = np.concatenate((bs, [t1]))
    keep = hi > lo
    return lo[keep], hi[keep]


def _innermost(events, points) -> List[str]:
    """For each time in ``points`` (ascending), the name of the event of
    ``events`` ((start, end, name), any thread) that opened last among
    those open then; "" where none is."""
    evs = sorted(events)
    heap: list = []
    out, i = [], 0
    for t in points:
        while i < len(evs) and evs[i][0] <= t:
            s, e, name = evs[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "")
    return out


def _kind(e) -> str:
    """The event's activity type; from its device, annotation flag and
    name where this torch's events do not carry the type."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if hasattr(e, "is_user_annotation"):
        note = bool(e.is_user_annotation())
    else:                       # a record_function range: "fleet.fwd"
        note = "." in name and "::" not in name
    if "cuda" in str(e.device_type()).lower():
        return "gpu_user_annotation" if note else "kernel"
    if note:
        return "user_annotation"
    if name.startswith("cu") and "::" not in name:
        return "cuda_runtime"
    return "cpu_op"


def _span(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = e.start_us() * 1000
    return s, s + e.duration_us() * 1000


def read(prof, n_steps: int, records, top: int = 10) -> Trace:
    raw = prof.profiler.kineto_results.events()
    launch: Dict[int, Tuple[int, int]] = {}     # ops and ranges
    runtime: Dict[int, Tuple[int, int]] = {}    # launch calls
    ranges = defaultdict(list)           # name -> [(start, end, thread)]
    host: List[Tuple[int, int, str]] = []
    annotations: List[Tuple[int, int, str]] = []
    dev = []                              # (start, end, name, linked corr)
    for e in raw:
        kind = _kind(e)
        s, t = _span(e)
        if kind in DEVICE_WORK:
            dev.append((s, t, e.name(), e.linked_correlation_id()))
        elif kind in HOST:
            name, tid = e.name(), e.start_thread_id()
            (runtime if kind.startswith("cuda") else launch)[
                e.correlation_id()] = (s, tid)
            host.append((s, t, name))
            if kind == "user_annotation":
                ranges[name].append((s, t, tid))
                annotations.append((s, t, name))
    steps = ranges[STEP_RANGE]
    if not steps:
        raise ValueError(f"the trace holds no {STEP_RANGE!r} range")
    t0 = min(s for s, _, _ in steps)
    t1 = max(t for _, t, _ in steps)
    dev = [d for d in dev if d[1] > t0 and d[0] < t1]
    # times from t0, as integers first: ns since the epoch overflow the
    # exact range of a float64
    ds = np.array([max(d[0], t0) - t0 for d in dev], dtype=np.float64)
    de = np.array([min(d[1], t1) - t0 for d in dev], dtype=np.float64)
    dur = de - ds
    bs, be = merge(ds, de)
    by_name: Dict[str, float] = defaultdict(float)
    for d, x in zip(dev, dur):
        by_name[d[2]] += x
    # each kernel's launch: when and on which thread
    at = [launch.get(d[3]) or runtime.get(d[3]) or (t0 - 1, -1) for d in dev]
    when = np.array([a[0] - t0 for a in at], dtype=np.float64)
    thread = np.array([a[1] for a in at])
    range_ns: Dict[str, float] = {}
    for name, spans in ranges.items():
        inside = np.zeros(len(dev), dtype=bool)
        for tid in {tid for _, _, tid in spans}:
            iv = sorted((s - t0, t - t0) for s, t, th in spans if th == tid)
            rs = np.array([s for s, _ in iv], dtype=np.float64)
            re = np.maximum.accumulate(np.array([t for _, t in iv],
                                                dtype=np.float64))
            k = np.searchsorted(rs, when, side="right") - 1
            hit = (k >= 0) & (thread == tid) & (when >= 0)
            hit[hit] &= when[hit] < re[k[hit]]
            inside |= hit
        range_ns[name] = float(dur[inside].sum())
    gs, ge = gaps(bs, be, 0.0, float(t1 - t0))
    mids = [t0 + int(m) for m in (gs + ge) / 2]
    ops = _innermost(host, mids)
    rngs = _innermost(annotations, mids)
    idle_by: Dict[str, float] = defaultdict(float)
    for a, b, op, rng in zip(gs, ge, ops, rngs):
        label = op[:48] if (not rng or rng == op) \
            else f"{rng[:24]} > {op[:40]}"
        idle_by[label or "host idle"] += float(b - a)
    ns = 1e-9
    return Trace(
        steps=n_steps, stretch_s=(t1 - t0) * ns,
        busy_s=float((be - bs).sum()) * ns, kernel_s=float(dur.sum()) * ns,
        range_kernel_s={k: v * ns for k, v in range_ns.items()},
        device_ops=[(n[:64], v * ns) for n, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[(n[:64], v * ns) for n, v in
                   sorted(idle_by.items(), key=lambda kv: -kv[1])[:top]],
        records=list(records))
