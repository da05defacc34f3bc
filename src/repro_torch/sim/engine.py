"""Discrete-event fleet timeline engine: one simulation substrate for
streaming, contention, mitigation, and mid-batch churn.

The closed-form accountings (Eq. 2's overlapped ``max``, Eq. 9' streaming,
the §4.2 churn patch makespans) each describe a *projection* of the same
underlying timeline: the PS and every device are queued resources processing
download / compute / upload stages.  This engine simulates that timeline
directly:

* every device runs *chains* of :class:`WorkItem`\\ s — a chain serializes
  its items, distinct chains on one device overlap (the §3.2 streaming
  overlap that justifies Eq. 2's ``max``);
* ``overlapped`` items complete in ``max(T_DL + L_d, T_comp, T_UL + L_u)``
  (Eq. 2-4); ``pipeline`` items run ``k`` quanta through a three-stage
  one-in-flight-per-stage pipeline (Eq. 9');
* downloads share their parameter server's egress link and uploads its
  ingress link: transfers acquire bandwidth FIFO, so a fleet whose
  aggregate link rate exceeds the PS capacity queues (§6 single-PS
  envelope) — with infinite capacity (the default) the engine reproduces
  the closed forms exactly.  A ``ps_of`` device→shard map splits the
  fleet across K independent PS link pairs (§6 multi-PS scale-out: each
  island contends only on its own server), and ``price_outer_sync``
  prices the island-sync round (the DiLoCo reduce+gather of sharded
  outer state) on the same timeline;
* :mod:`repro_torch.sim.events` events are injected on the same heap:
  ``fail`` orphans a device's unfinished items and re-dispatches them via a
  pluggable ``repair`` hook (the schedule driver below uses
  ``churn.recover``, §4.2), ``join`` folds a device in at the next level
  boundary (§3.2), ``slowdown`` scales stage times (App. C.5);
* per-stage Pareto(α) jitter reproduces the Appendix C latency model.

``simulate_schedule`` replays a solved :class:`SchedulePlan` level-by-level
(the DAG barrier is Eq. 1's sum-of-level-maxima); ``price_plan`` prices one
GEMM plan deterministically (shared by ``sim.simulator._evaluate_on``);
``replay_speculative`` / ``replay_coded`` replay the Appendix C.4
mitigations as duplicate / erasure chains instead of order-statistic
formulas.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import churn, cost_model as cm, tail
from repro_torch.sim.events import (FailEvent, JoinEvent, SlowdownEvent,
                              TimelineEvent, TimelineReport, validate_events)


# ------------------------------------------------------------- work items --

@dataclass(frozen=True)
class WorkItem:
    """One unit of PS→device→PS work.

    ``overlapped`` mode (default) models a streamed transfer whose DL,
    compute, and UL fully overlap: completion after
    ``setup + max(t_dl + dl_lat, t_comp, t_ul + ul_lat)`` — Eq. 2 with
    Eq. 3/4 stage times.  ``pipeline`` mode streams the item as ``k`` equal
    quanta through a three-stage pipeline with one quantum in flight per
    stage — Eq. 9' exactly in the deterministic case."""
    dl_bytes: float
    flops: float
    ul_bytes: float
    mode: str = "overlapped"        # "overlapped" | "pipeline"
    k: int = 1                      # quanta (pipeline mode)
    dl_lat: float = 0.0             # per-transfer fixed overheads L_d / L_u
    ul_lat: float = 0.0
    setup: float = 0.0              # one-time offset before the item starts
    level: int = 0                  # DAG level barrier this item belongs to
    tag: object = None              # builder payload (drives churn repair)


class _Dev:
    __slots__ = ("device", "factor", "alive", "load")

    def __init__(self, device: cm.Device):
        self.device = device
        self.factor = 1.0           # stage-time multiplier (slowdown events)
        self.alive = True
        self.load = 0.0             # nominal committed seconds (repair greedy)


class _Chain:
    __slots__ = ("cid", "device_id", "level", "items", "current", "epoch",
                 "started", "done", "start_t", "pstate", "is_repair",
                 "deps_left", "dependents")

    def __init__(self, cid, device_id, level, items):
        self.cid = cid
        self.device_id = device_id
        self.level = level
        self.items: deque = deque(items)
        self.current: Optional[WorkItem] = None
        self.epoch = 0              # bumped to cancel scheduled callbacks
        self.started = False
        self.done = False
        self.start_t = 0.0
        self.pstate = None          # pipeline-mode progress
        self.is_repair = False
        self.deps_left = 0          # unfinished producer chains gating start
        self.dependents: List[int] = []


class _Link:
    """Shared PS link: FIFO bandwidth-token admission.  ``capacity=None``
    means infinite (no contention; transfers start immediately)."""
    __slots__ = ("capacity", "in_use", "queue", "wait", "busy_bytes")

    def __init__(self, capacity: Optional[float]):
        self.capacity = capacity
        self.in_use = 0.0
        self.queue: deque = deque()     # (req_t, rate, dur, cb)
        self.wait = 0.0                 # total queued seconds
        self.busy_bytes = 0.0           # granted rate x duration


# ------------------------------------------------------------------ engine --

class TimelineEngine:
    """Event-heap simulation of a device fleet around a parameter server.

    Construct, ``add_chain`` work, then ``run()``.  Injected
    :mod:`repro_torch.sim.events` interleave with work events on the same heap.
    ``repair(engine, t, device_id, lost_items) -> [(device_id, item), ...]``
    decides where a failed device's unfinished items go (default: greedy
    least-loaded); ``on_join(engine, t, device)`` may rebuild future-level
    chains (default: the joiner idles until someone assigns it work)."""

    def __init__(self, devices: Sequence[cm.Device], *,
                 ps_egress_bps: Optional[float] = None,
                 ps_ingress_bps: Optional[float] = None,
                 ps_of: Optional[Dict[int, int]] = None,
                 events: Sequence[TimelineEvent] = (),
                 jitter_alpha: float = 0.0,
                 rng: Optional[np.random.Generator] = None,
                 repair: Optional[Callable] = None,
                 on_join: Optional[Callable] = None,
                 trace: bool = False):
        if jitter_alpha > 0.0 and jitter_alpha <= 1.0:
            raise ValueError(
                f"jitter_alpha must be > 1 for a finite-mean Pareto tail "
                f"(got {jitter_alpha}); pass 0 to disable jitter")
        self._devs: Dict[int, _Dev] = {d.device_id: _Dev(d) for d in devices}
        # one egress/ingress link pair per parameter server: ``ps_of`` maps
        # device_id -> PS shard index (absent devices — and joiners — fall
        # back to shard 0, the single-PS default).  Every shard's links get
        # the same capacity; None capacity = infinite (no contention).
        self._ps_of: Dict[int, int] = dict(ps_of or {})
        n_ps = max(self._ps_of.values(), default=0) + 1
        self._egress: Dict[int, _Link] = {p: _Link(ps_egress_bps)
                                          for p in range(n_ps)}
        self._ingress: Dict[int, _Link] = {p: _Link(ps_ingress_bps)
                                           for p in range(n_ps)}
        self._events = validate_events(list(events),
                                       device_ids=set(self._devs))
        self.jitter_alpha = float(jitter_alpha)
        self.rng = rng
        self._repair = repair
        self._on_join_hook = on_join
        self._trace: Optional[List[tuple]] = [] if trace else None

        self._heap: List[tuple] = []
        self._seq = 0
        self.clock = 0.0
        self._chains: List[_Chain] = []
        self._by_dev: Dict[int, List[_Chain]] = {}
        self._by_level: Dict[int, List[_Chain]] = {}
        self._remaining: Dict[int, int] = {}     # open items count per level
        self._level_ends: List[Tuple[int, float]] = []
        self.current_level: Optional[int] = None
        self._grants: Dict[int, list] = {}       # gid -> [link, rate, did, on]
        self._gid = 0
        self._busy: Dict[int, float] = {}
        self._completions: Dict[int, float] = {}
        self._n_events = 0
        self._n_items = 0
        self._n_fail = self._n_join = self._n_slow = 0
        self._recovery: List[list] = []          # [t_fail, [repair cids]]
        self.recomputed_fraction = 0.0           # set by churn-aware repair

    # ------------------------------------------------------------- set-up --

    def add_chain(self, device_id: int, items: Sequence[WorkItem],
                  level: Optional[int] = None,
                  deps: Sequence[int] = ()) -> int:
        """Register a serialized chain of items on a device.  ``level``
        overrides the items' own level for barrier bookkeeping.

        ``deps`` lists producer chain ids that must finish before this
        chain may start — the dataflow (ready-set) dispatch model: within
        its level the chain is held back until its last dependency
        completes instead of launching at the level barrier.  Dependencies
        must live in the same or an earlier level."""
        if device_id not in self._devs:
            raise KeyError(f"unknown device {device_id}")
        lv = level if level is not None else (items[0].level if items else 0)
        ch = _Chain(len(self._chains), device_id, lv, items)
        for cid in deps:
            dep = self._chains[cid]
            if not dep.done:
                ch.deps_left += 1
                dep.dependents.append(ch.cid)
        self._chains.append(ch)
        self._by_dev.setdefault(device_id, []).append(ch)
        self._by_level.setdefault(lv, []).append(ch)
        self._remaining[lv] = self._remaining.get(lv, 0) + 1
        dev = self._devs[device_id]
        dev.load += sum(self._nominal(it, dev.device) for it in items)
        self._n_items += len(items)
        if (self.current_level is not None and lv == self.current_level
                and ch.deps_left == 0):
            self._start_chain(ch, self.clock)      # hot-added mid-level
        return ch.cid

    def alive_devices(self) -> List[cm.Device]:
        return [d.device for d in self._devs.values() if d.alive]

    # ---------------------------------------------------------------- run --

    def run(self, opt_tail: float = 0.0) -> TimelineReport:
        wall0 = time.perf_counter()
        for e in self._events:
            self._schedule(e.t, self._make_inject(e))
        first = min(self._remaining) if self._remaining else None
        if first is not None:
            self._open_level(first, 0.0)
        while self._heap:
            t, _, cb = heapq.heappop(self._heap)
            self.clock = t
            self._n_events += 1
            cb(t)
        gemm_end = self._level_ends[-1][1] if self._level_ends else 0.0
        level_times, prev = [], 0.0
        for _, end in self._level_ends:
            level_times.append(end - prev)
            prev = end
        recovery = 0.0
        for t_fail, cids in self._recovery:
            ends = [self._completions[c] for c in cids
                    if c in self._completions]
            if ends:
                recovery = max(recovery, max(ends) - t_fail)
        return TimelineReport(
            backend="event", makespan=gemm_end + opt_tail,
            gemm_time=gemm_end, opt_tail=opt_tail, level_times=level_times,
            n_events=self._n_events, n_items=self._n_items,
            n_failures=self._n_fail, n_joins=self._n_join,
            n_slowdowns=self._n_slow, recovery_latency=recovery,
            recomputed_fraction=self.recomputed_fraction,
            device_busy=dict(self._busy),
            # aggregates over the per-PS links (single-PS: the one link)
            ps_egress_wait=sum(l.wait for l in self._egress.values()),
            ps_ingress_wait=sum(l.wait for l in self._ingress.values()),
            ps_egress_busy=sum(l.busy_bytes for l in self._egress.values()),
            ps_ingress_busy=sum(l.busy_bytes
                                for l in self._ingress.values()),
            chain_completions=dict(self._completions),
            wall_time=time.perf_counter() - wall0, trace=self._trace)

    # ------------------------------------------------------------ plumbing --

    def _schedule(self, t: float, cb: Callable) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, cb))

    def _log(self, t, kind, info):
        if self._trace is not None and len(self._trace) < 10_000:
            self._trace.append((t, kind, info))

    def _draw(self, base: float) -> float:
        """Multiply a stage time by a mean-normalized Pareto(α) sample."""
        if base <= 0 or self.jitter_alpha <= 1.0 or self.rng is None:
            return base
        a = self.jitter_alpha
        return base * tail.pareto_sample(self.rng, 1.0, a, None) \
            / (a / (a - 1.0))

    def _nominal(self, it: WorkItem, d: cm.Device) -> float:
        t_dl = it.dl_bytes / d.dl_bw
        t_ul = it.ul_bytes / d.ul_bw
        t_c = it.flops / d.flops
        if it.mode == "pipeline" and it.k > 1:
            steady = max(t_dl, t_c, t_ul) / it.k
            return it.dl_lat + (t_dl + t_c + t_ul) / it.k \
                + (it.k - 1) * steady + it.ul_lat
        return it.setup + max(t_dl + it.dl_lat, t_c, t_ul + it.ul_lat)

    # --------------------------------------------------------- link tokens --

    def _egress_of(self, device_id: int) -> _Link:
        p = self._ps_of.get(device_id, 0)
        return self._egress[p if p in self._egress else 0]

    def _ingress_of(self, device_id: int) -> _Link:
        p = self._ps_of.get(device_id, 0)
        return self._ingress[p if p in self._ingress else 0]

    def _acquire(self, link: _Link, t: float, rate: float, dur: float,
                 device_id: int, cb: Callable) -> None:
        """FIFO bandwidth admission; ``cb(grant_time)`` runs when granted."""
        if link.capacity is None or rate <= 0 or dur <= 0:
            cb(t)
            return
        link.queue.append((t, rate, dur, device_id, cb))
        self._pump(link, t)

    def _pump(self, link: _Link, t: float) -> None:
        while link.queue:
            req_t, rate, dur, did, cb = link.queue[0]
            if link.in_use > 0 and link.in_use + rate > link.capacity * \
                    (1 + 1e-12):
                return                      # head-of-line blocks (FIFO)
            link.queue.popleft()
            link.in_use += rate
            link.wait += t - req_t
            link.busy_bytes += rate * dur
            self._gid += 1
            gid = self._gid
            self._grants[gid] = [link, rate, did, True]
            self._schedule(t + dur, lambda now, g=gid: self._release(g, now))
            cb(t)

    def _release(self, gid: int, t: float) -> None:
        g = self._grants.get(gid)
        if g is None or not g[3]:
            return
        g[3] = False
        g[0].in_use -= g[1]
        self._pump(g[0], t)

    def _drop_grants(self, device_id: int, t: float) -> None:
        for g in self._grants.values():
            if g[3] and g[2] == device_id:
                g[3] = False
                g[0].in_use -= g[1]
        for link in (*self._egress.values(), *self._ingress.values()):
            link.queue = deque(q for q in link.queue if q[3] != device_id)
            self._pump(link, t)

    # ------------------------------------------------------- level barrier --

    def _open_level(self, lv: int, t: float) -> None:
        self.current_level = lv
        self._log(t, "level", lv)
        for ch in list(self._by_level.get(lv, ())):
            if not ch.started and not ch.done and ch.deps_left == 0:
                self._start_chain(ch, t)
        if self._remaining.get(lv, 0) == 0:     # an emptied level
            self._advance_level(t)

    def _advance_level(self, t: float) -> None:
        lv = self.current_level
        self._level_ends.append((lv, t))
        self._remaining.pop(lv, None)
        nxt = [x for x in self._remaining if x > lv]
        if nxt:
            self._open_level(min(nxt), t)
        else:
            self.current_level = None

    def _finish_chain(self, ch: _Chain, t: float,
                      completed: bool = True) -> None:
        if ch.done:
            return
        ch.done = True
        if completed:
            self._completions[ch.cid] = t
        # release dependents even on an uncompleted finish (device failure):
        # their data dependency is repaired elsewhere, and holding them
        # forever would deadlock the ready set
        for cid in ch.dependents:
            dep = self._chains[cid]
            dep.deps_left -= 1
            if (dep.deps_left == 0 and not dep.started and not dep.done
                    and dep.level == self.current_level):
                self._start_chain(dep, t)
        lv = ch.level
        self._remaining[lv] = self._remaining.get(lv, 1) - 1
        if lv == self.current_level and self._remaining[lv] <= 0:
            self._advance_level(t)

    # ------------------------------------------------------ item execution --

    def _start_chain(self, ch: _Chain, t: float) -> None:
        ch.started = True
        ch.start_t = t
        self._next_item(ch, t)

    def _next_item(self, ch: _Chain, t: float) -> None:
        if not self._devs[ch.device_id].alive or ch.done:
            return
        if not ch.items:
            self._finish_chain(ch, t)
            return
        ch.current = self._items_pop(ch)
        it = ch.current
        start = t + it.setup
        if it.mode == "pipeline" and it.k >= 1:
            self._exec_pipeline(ch, it, start)
        else:
            self._exec_overlapped(ch, it, start)

    def _items_pop(self, ch: _Chain) -> WorkItem:
        return ch.items.popleft()

    def _item_done(self, ch: _Chain, epoch: int, start: float,
                   t: float) -> None:
        if ch.epoch != epoch or ch.done:
            return
        dev = self._devs[ch.device_id]
        if not dev.alive:
            return
        self._busy[ch.device_id] = self._busy.get(ch.device_id, 0.0) \
            + (t - start)
        dev.load = max(dev.load - self._nominal(ch.current, dev.device), 0.0)
        ch.current = None
        ch.pstate = None
        self._next_item(ch, t)

    # --- overlapped (Eq. 2): DL/compute/UL fully overlap within the item ---

    def _exec_overlapped(self, ch: _Chain, it: WorkItem, s: float) -> None:
        dev = self._devs[ch.device_id]
        d, f = dev.device, dev.factor
        egress = self._egress_of(ch.device_id)
        ingress = self._ingress_of(ch.device_id)
        epoch = ch.epoch
        t_dl = self._draw(it.dl_bytes / d.dl_bw * f)
        t_c = self._draw(it.flops / d.flops * f)
        t_ul = self._draw(it.ul_bytes / d.ul_bw * f)

        def after_dl_grant(g):
            if ch.epoch != epoch or not dev.alive:
                return
            c0 = g + max(t_dl + it.dl_lat, t_c, t_ul + it.ul_lat)
            if it.ul_bytes > 0 and ingress.capacity is not None:
                # the upload burst is modeled at the tail of the window
                u0 = max(c0 - t_ul - it.ul_lat, g)
                self._schedule(u0, lambda now: self._acquire(
                    ingress, now, it.ul_bytes / max(t_ul, 1e-18),
                    t_ul, ch.device_id,
                    lambda gu: self._schedule(
                        gu + t_ul + it.ul_lat,
                        lambda now2: self._item_done(ch, epoch, g, now2))))
            else:
                self._schedule(c0,
                               lambda now: self._item_done(ch, epoch, g, now))

        if it.dl_bytes > 0 and egress.capacity is not None:
            rate = it.dl_bytes / max(t_dl, 1e-18)
            if s > self.clock:      # honor setup delay before queueing
                self._schedule(s, lambda now: self._acquire(
                    egress, now, rate, t_dl, ch.device_id,
                    after_dl_grant))
            else:
                self._acquire(egress, s, rate, t_dl, ch.device_id,
                              after_dl_grant)
        else:
            after_dl_grant(s)

    # --- pipeline (Eq. 9'): k quanta, one in flight per stage --------------

    def _exec_pipeline(self, ch: _Chain, it: WorkItem, s: float) -> None:
        dev = self._devs[ch.device_id]
        st = {"dl_free": s + it.dl_lat, "comp_free": s, "ul_free": s,
              "next_dl": 0, "ul_ready": deque(), "ul_busy": False,
              "uploaded": 0, "start": s}
        ch.pstate = st
        self._issue_dl(ch, it, ch.epoch)

    def _q(self, it: WorkItem, d: cm.Device, stage: str, f: float) -> float:
        per = {"dl": it.dl_bytes / it.k / d.dl_bw,
               "comp": it.flops / it.k / d.flops,
               "ul": it.ul_bytes / it.k / d.ul_bw}[stage]
        return self._draw(per * f)

    def _issue_dl(self, ch: _Chain, it: WorkItem, epoch: int) -> None:
        st = ch.pstate
        if ch.epoch != epoch or st is None or st["next_dl"] >= it.k:
            return
        st["next_dl"] += 1
        dev = self._devs[ch.device_id]
        t_dl = self._q(it, dev.device, "dl", dev.factor)

        def granted(g):
            if ch.epoch != epoch or not dev.alive:
                return
            self._schedule(g + t_dl, dl_done)

        def dl_done(now):
            if ch.epoch != epoch or not dev.alive:
                return
            st["dl_free"] = now
            t_c = self._q(it, dev.device, "comp", dev.factor)
            comp_end = max(st["comp_free"], now) + t_c
            st["comp_free"] = comp_end
            self._schedule(comp_end, comp_done)
            self._issue_dl(ch, it, epoch)       # next quantum's download

        def comp_done(now):
            if ch.epoch != epoch or not dev.alive:
                return
            st["ul_ready"].append(now)
            self._pump_ul(ch, it, epoch)

        rate = it.dl_bytes / it.k / max(t_dl, 1e-18)
        self._schedule(st["dl_free"], lambda now: self._acquire(
            self._egress_of(ch.device_id), now, rate, t_dl, ch.device_id,
            granted))

    def _pump_ul(self, ch: _Chain, it: WorkItem, epoch: int) -> None:
        st = ch.pstate
        if ch.epoch != epoch or st is None or st["ul_busy"] \
                or not st["ul_ready"]:
            return
        st["ul_ready"].popleft()
        st["ul_busy"] = True
        dev = self._devs[ch.device_id]
        t_ul = self._q(it, dev.device, "ul", dev.factor)
        rate = it.ul_bytes / it.k / max(t_ul, 1e-18)

        def granted(gu):
            if ch.epoch != epoch or not dev.alive:
                return
            self._schedule(gu + t_ul, ul_done)

        def ul_done(now):
            if ch.epoch != epoch or not dev.alive:
                return
            st["ul_free"] = now
            st["ul_busy"] = False
            st["uploaded"] += 1
            if st["uploaded"] >= it.k:
                self._schedule(now + it.ul_lat, lambda n2: self._item_done(
                    ch, epoch, st["start"], n2))
            else:
                self._pump_ul(ch, it, epoch)

        self._acquire(self._ingress_of(ch.device_id),
                      max(st["ul_free"], self.clock), rate,
                      t_ul, ch.device_id, granted)

    # ---------------------------------------------------- injected events --

    def _make_inject(self, e: TimelineEvent) -> Callable:
        if isinstance(e, FailEvent):
            return lambda t: self._on_fail(e.device_id, t)
        if isinstance(e, JoinEvent):
            return lambda t: self._on_join(e.device, t)
        return lambda t: self._on_slowdown(e.device_id, e.factor, t)

    def _on_slowdown(self, device_id: int, factor: float, t: float) -> None:
        dev = self._devs.get(device_id)
        if dev is None or not dev.alive:
            return
        dev.factor *= factor
        self._n_slow += 1
        self._log(t, "slowdown", (device_id, factor))

    def _on_join(self, device: cm.Device, t: float) -> None:
        did = device.device_id
        if did in self._devs:
            did = max(self._devs) + 1
            device = replace(device, device_id=did)
        self._devs[did] = _Dev(device)
        self._n_join += 1
        self._log(t, "join", did)
        if self._on_join_hook is not None:
            self._on_join_hook(self, t, device)

    def _on_fail(self, device_id: int, t: float) -> None:
        dev = self._devs.get(device_id)
        if dev is None or not dev.alive:
            return
        dev.alive = False
        self._n_fail += 1
        self._log(t, "fail", device_id)
        self._drop_grants(device_id, t)
        lost: List[WorkItem] = []
        dead_chains: List[_Chain] = []
        for ch in self._by_dev.get(device_id, []):
            if ch.done:
                continue
            ch.epoch += 1                       # cancel scheduled callbacks
            if ch.current is not None:
                it = ch.current
                if it.mode == "pipeline" and ch.pstate is not None:
                    k_rem = it.k - ch.pstate["uploaded"]
                    if k_rem > 0:
                        frac = k_rem / it.k
                        lost.append(replace(
                            it, dl_bytes=it.dl_bytes * frac,
                            flops=it.flops * frac,
                            ul_bytes=it.ul_bytes * frac, k=k_rem,
                            level=ch.level))
                else:
                    lost.append(replace(it, level=ch.level))
                ch.current = None
                ch.pstate = None
            lost.extend(replace(i, level=ch.level) for i in ch.items)
            ch.items.clear()
            dead_chains.append(ch)
        if lost:
            if not any(d.alive for d in self._devs.values()):
                raise RuntimeError("no surviving devices")
            if self._repair is not None:
                placements = self._repair(self, t, device_id, lost)
            else:
                placements = self._default_repair(lost)
            cur_cids = self._place_repairs(placements, t)
            self._recovery.append([t, cur_cids])
        for ch in dead_chains:                  # after repairs are counted
            self._finish_chain(ch, t, completed=False)

    def _default_repair(self, lost: Sequence[WorkItem]
                        ) -> List[Tuple[int, WorkItem]]:
        """Greedy least-loaded redistribution of orphaned items."""
        alive = [d for d in self._devs.values() if d.alive]
        out = []
        for it in sorted(lost, key=lambda i: -(i.dl_bytes + i.flops)):
            best = min(alive, key=lambda d: d.load)
            best.load += self._nominal(it, best.device)
            out.append((best.device.device_id, it))
        return out

    def _place_repairs(self, placements: Sequence[Tuple[int, WorkItem]],
                       t: float) -> List[int]:
        """Group repaired items into per-(device, level) chains; returns the
        chain ids landing in the level currently in flight (the recovery
        front the report's ``recovery_latency`` tracks)."""
        grouped: Dict[Tuple[int, int], List[WorkItem]] = {}
        for did, it in placements:
            grouped.setdefault((did, it.level), []).append(it)
        cur = []
        for (did, lv), items in sorted(grouped.items()):
            cid = self.add_chain(did, items, level=lv)
            self._chains[cid].is_repair = True
            if lv == self.current_level:
                cur.append(cid)
        return cur

    def replace_future_chains(
            self, specs: Sequence[Tuple[int, int, Sequence[WorkItem]]]
    ) -> None:
        """Drop every not-yet-started chain in levels after the current one
        and install ``(level, device_id, items)`` replacements — the §3.2
        next-round re-plan when the fleet changes mid-batch."""
        cur = self.current_level if self.current_level is not None \
            else float("inf")
        for ch in self._chains:
            if ch.level > cur and not ch.started and not ch.done:
                ch.epoch += 1
                dev = self._devs.get(ch.device_id)
                if dev is not None:
                    dev.load = max(dev.load - sum(
                        self._nominal(i, dev.device) for i in ch.items), 0.0)
                ch.items.clear()
                self._finish_chain(ch, self.clock, completed=False)
        for lv, did, items in specs:
            if lv > cur:
                self.add_chain(did, items, level=lv)


# --------------------------------------------------------- plan → chains ---

def _effective_n(n: int, n_split: int) -> int:
    """Reproduce the contraction-dim halving recursion of ``solve_gemm``."""
    s = n_split
    while s > 1:
        n = (n + 1) // 2
        s //= 2
    return n


def plan_chains(g: cm.GEMM, plan: cm.Plan, by_id: Dict[int, cm.Device],
                n_pool: int, level: int = 0, overlap: bool = False,
                reps: int = 1) -> List[Tuple[int, List[WorkItem]]]:
    """Translate one solved GEMM plan into engine chains.  One chain per
    assignment rectangle (rectangles on one device overlap, matching
    ``plan_makespan``'s max-semantics); instance-granular plans get one
    aggregated chain per device; ``n_split`` rounds, count>1 wave factors,
    and ``reps`` sequential repeats (loss chunking) become sequential items
    on the chain.

    ``overlap=True`` is the dataflow pricing mode: a chain's repeated
    rounds collapse into ONE pipeline-mode item (Eq. 9' steady-state
    quanta, ``k = rounds``) so the device streams round r+1's download
    behind round r's compute instead of paying per-round latency — the
    §3.2 quantum streaming the barrier model ignores."""
    from repro_torch.core.scheduler import _wave_factor
    out: List[Tuple[int, List[WorkItem]]] = []
    if plan.instances is not None:
        for did, wi in plan.instances.items():
            d = by_id[did]
            item = WorkItem(
                dl_bytes=reps * wi * g.in_bytes, flops=reps * wi * g.flops,
                ul_bytes=reps * wi * g.out_bytes,
                setup=max(d.dl_lat, d.ul_lat), level=level,
                tag=("instances", g, plan, did))
            if overlap and reps * wi > 1:
                item = replace(item, mode="pipeline",
                                  k=max(int(reps * wi), 1))
            out.append((did, [item]))
        return out
    rounds = plan.n_split
    if g.count > 1:
        rounds *= int(_wave_factor(g, plan, n_pool))
    rounds *= max(int(reps), 1)
    n_eff = _effective_n(g.n, plan.n_split)
    for a in plan.assignments:
        d = by_id[a.device_id]
        item = WorkItem(
            dl_bytes=(a.alpha * n_eff + n_eff * a.beta) * g.b,
            flops=2.0 * a.alpha * a.beta * n_eff,
            ul_bytes=a.alpha * a.beta * g.b,
            dl_lat=d.dl_lat, ul_lat=d.ul_lat, level=level,
            tag=("assignment", g, plan, a))
        if overlap and rounds > 1:
            item = replace(
                item, dl_bytes=item.dl_bytes * rounds,
                flops=item.flops * rounds, ul_bytes=item.ul_bytes * rounds,
                mode="pipeline", k=rounds)
            out.append((a.device_id, [item]))
        else:
            out.append((a.device_id, [item] * rounds))
    return out


def price_plan(g: cm.GEMM, plan: cm.Plan, devices: Sequence[cm.Device],
               n_pool: Optional[int] = None, overlap: bool = False,
               engine_cls: type = None) -> float:
    """Deterministically price one plan's makespan through the engine (the
    single replacement for the per-level closed forms that used to be
    duplicated across ``simulator``, ``streaming``, and ``mitigation``).
    ``overlap=True`` prices the dataflow dispatch of the same plan:
    repeated rounds stream as pipeline quanta instead of serialized
    latency-paying items (see :func:`plan_chains`).  ``engine_cls`` swaps
    the simulation backend (default: this module's scalar oracle;
    ``sim.engine_array.ArrayTimelineEngine`` is the vectorized twin)."""
    by_id = {d.device_id: d for d in devices}
    eng = (engine_cls or TimelineEngine)(devices)
    for did, items in plan_chains(g, plan, by_id, n_pool or len(devices),
                                  overlap=overlap):
        eng.add_chain(did, items, level=0)
    return eng.run().makespan


def price_dataflow(nodes: Sequence[tuple], devices: Sequence[cm.Device],
                   *, deps: Optional[Sequence[Sequence[int]]] = None,
                   n_pool: Optional[int] = None,
                   engine_cls: type = None) -> float:
    """Critical-path makespan of dependent GEMMs under dataflow dispatch —
    the ready-set replacement for Eq. 1's sum-of-level-maxima.

    ``nodes`` is a topologically-ordered sequence of ``(gemm, plan)`` or
    ``(gemm, plan, reps)`` (``reps`` = sequential loss-chunk repeats);
    ``deps[i]`` lists the producer node indices of node *i*.  Each
    assignment rectangle becomes one engine chain whose start is gated on
    (a) its own weight-prefetch chain — the B operand downloads as soon as
    the device is known, double-buffered behind whatever the device is
    computing — and (b) the producer chains whose output rows overlap the
    rectangle's input rows (proportional row mapping; a producer feeds a
    consumer through PS-side glue, so only the overlapping band gates it).
    The A-operand download, compute, and upload then execute on the shared
    timeline, so the result is the critical path through the ready set:
    independent branches overlap, rounds stream as pipeline quanta, and a
    slow producer only delays its own consumers instead of the whole
    level."""
    by_id = {d.device_id: d for d in devices}
    pool = n_pool or len(devices)
    eng = (engine_cls or TimelineEngine)(devices)
    # topological order via Kahn's algorithm: callers hand nodes in model
    # order, which need not resolve dependencies left-to-right (a DAG's
    # backward mirrors are appended in forward order with descending levels)
    n = len(nodes)
    dep_lists = [list(deps[i]) if deps else [] for i in range(n)]
    indeg = [len(d) for d in dep_lists]
    out_edges: List[List[int]] = [[] for _ in range(n)]
    for i, ds in enumerate(dep_lists):
        for j in ds:
            out_edges[j].append(i)
    topo = [i for i in range(n) if indeg[i] == 0]
    for i in topo:
        for j in out_edges[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                topo.append(j)
    if len(topo) != n:
        raise ValueError("price_dataflow: dependency cycle")
    # (cid, r0, r1, m) per chain; r0 None = coarse chain (gates everything)
    node_chains: Dict[int, List[tuple]] = {}
    for i in topo:
        node = nodes[i]
        g, plan = node[0], node[1]
        reps = int(node[2]) if len(node) > 2 else 1
        my_deps = dep_lists[i]

        def producer_cids(r0=None, r1=None, m=1):
            cids = []
            for j in my_deps:
                for (cid, pr0, pr1, pm_) in node_chains[j]:
                    if r0 is None or pr0 is None:
                        cids.append(cid)
                        continue
                    lo = r0 / m * pm_
                    hi = r1 / m * pm_
                    if pr0 < hi and pr1 > lo:
                        cids.append(cid)
            return cids

        chains_here: List[tuple] = []
        coarse = (plan.instances is not None or g.count > 1
                  or plan.n_split > 1 or not plan.assignments)
        if coarse:
            dep_cids = producer_cids()
            for did, items in plan_chains(g, plan, by_id, pool,
                                          overlap=True, reps=reps):
                cid = eng.add_chain(did, items, level=0, deps=dep_cids)
                chains_here.append((cid, None, None, g.m))
        else:
            n_eff = g.n
            for a in plan.assignments:
                d = by_id[a.device_id]
                # weight prefetch: B columns stream down independently of
                # the producers (double-buffered staging)
                pre = eng.add_chain(a.device_id, [WorkItem(
                    dl_bytes=n_eff * a.beta * g.b, flops=0.0, ul_bytes=0.0,
                    dl_lat=d.dl_lat)], level=0)
                main = WorkItem(
                    dl_bytes=a.alpha * n_eff * g.b,
                    flops=2.0 * a.alpha * a.beta * n_eff,
                    ul_bytes=a.alpha * a.beta * g.b,
                    dl_lat=d.dl_lat, ul_lat=d.ul_lat)
                if reps > 1:
                    main = replace(
                        main, dl_bytes=main.dl_bytes * reps,
                        flops=main.flops * reps,
                        ul_bytes=main.ul_bytes * reps,
                        mode="pipeline", k=reps)
                dep_cids = producer_cids(a.r0, a.r1, g.m) + [pre]
                cid = eng.add_chain(a.device_id, [main], level=0,
                                    deps=dep_cids)
                chains_here.append((cid, a.r0, a.r1, g.m))
        node_chains[i] = chains_here
    return eng.run().makespan


def price_outer_sync(shard_bytes: Sequence[float], *,
                     ps_net_bps: float = 25e9,
                     backbone_bps: Optional[float] = None,
                     latency: float = 0.0,
                     engine_cls: type = None) -> float:
    """Price one DiLoCo island-sync round (the cross-PS event at an outer
    boundary) on the engine timeline: each of the K parameter servers is a
    pseudo-device that simultaneously streams its reduce+gather traffic —
    ``(K-1)·P_k + (T-P_k)`` bytes each way for the shard partition
    ``shard_bytes`` (``diloco.sync_traffic``).

    With per-PS links of ``ps_net_bps`` (the default: each server's own
    NIC), the round costs the slowest server's transfer; a finite
    ``backbone_bps`` instead funnels every transfer through one shared
    inter-PS backbone link, so the round queues FIFO exactly like §6 PS
    saturation.  K=1 (or an empty partition) is free — there is nothing to
    sync."""
    k = len(shard_bytes)
    if k <= 1:
        return 0.0
    total = float(sum(shard_bytes))
    devs = [cm.Device(flops=1e30, dl_bw=ps_net_bps, ul_bw=ps_net_bps,
                      dl_lat=latency, ul_lat=latency, device_id=i)
            for i in range(k)]
    # backbone contention: map every PS pseudo-device onto ONE shared link
    # pair; otherwise each PS gets its own infinite link (NIC-bound).
    eng = (engine_cls or TimelineEngine)(
        devs, ps_egress_bps=backbone_bps, ps_ingress_bps=backbone_bps,
        ps_of={i: 0 for i in range(k)})
    for i, p in enumerate(shard_bytes):
        xfer = (k - 1) * float(p) + (total - float(p))
        eng.add_chain(i, [WorkItem(dl_bytes=xfer, flops=0.0, ul_bytes=xfer,
                                   dl_lat=latency, ul_lat=latency)])
    return float(eng.run().makespan)


# ------------------------------------------------------ schedule simulation --

def simulate_schedule(sp, devices: Optional[Sequence[cm.Device]] = None, *,
                      events: Sequence[TimelineEvent] = (),
                      ps_egress_bps: Optional[float] = None,
                      ps_ingress_bps: Optional[float] = None,
                      jitter_alpha: float = 0.0,
                      rng: Optional[np.random.Generator] = None,
                      opt_tail: Optional[float] = None,
                      heterogeneity_aware: bool = True,
                      trace: bool = False,
                      engine_cls: type = None) -> TimelineReport:
    """Replay a solved :class:`~repro_torch.core.scheduler.SchedulePlan` on the
    event timeline.  With no events, no jitter, and infinite PS links this
    reproduces the analytic ``sp.batch_time`` exactly (asserted in tests);
    injected events unlock what the closed form cannot price: mid-batch
    failure (repaired via ``churn.recover``, §4.2), joiners folded in at
    the next level (§3.2), hidden slowdowns (App. C.5), and PS saturation
    under finite egress/ingress capacity (§6)."""
    from repro_torch.core.scheduler import (_homogenize, plan_shape_key,
                                      solve_level_gemm)
    devices = list(devices if devices is not None else sp.devices)
    by_id = {d.device_id: d for d in devices}
    n_pool = len(devices)
    levels = sp.dag.levels()

    patched: Dict[tuple, churn.RecoveryResult] = {}  # (plan, dead) -> rec
    state = {"recomputed": 0.0}

    def _repair(eng: TimelineEngine, t: float, dead_id: int,
                lost: Sequence[WorkItem]):
        survivors = eng.alive_devices()
        sur_by_id = {d.device_id: d for d in survivors}
        placements: List[Tuple[int, WorkItem]] = []
        plain: List[WorkItem] = []
        for it in lost:
            if not (isinstance(it.tag, tuple) and it.tag
                    and it.tag[0] == "assignment"):
                plain.append(it)
                continue
            _, g, plan, a = it.tag
            key = (id(plan), dead_id)
            if key not in patched:
                ev = churn.FailureEvent(gemm=plan.gemm, failed_ids=[dead_id],
                                        plan=plan)
                patched[key] = churn.recover(ev, survivors)
                state["recomputed"] = max(state["recomputed"],
                                          patched[key].recomputed_fraction)
            rec = patched[key]
            # the (rect, patch) pairs are alignment-safe even when recover()
            # skipped degenerate orphans
            for rect, patch in rec.patches:
                if (rect.r0, rect.c0) != (a.r0, a.c0):
                    continue
                for did2, items in plan_chains(patch.gemm, patch, sur_by_id,
                                               len(survivors),
                                               level=it.level):
                    if did2 in sur_by_id:
                        placements.extend((did2, x) for x in items)
        if plain:
            placements.extend(eng._default_repair(plain))
        eng.recomputed_fraction = state["recomputed"]
        return placements

    def _on_join(eng: TimelineEngine, t: float, device: cm.Device) -> None:
        # §3.2: the joiner is folded in at the next round — remaining levels
        # re-solve over the enlarged fleet, one solve per unique shape
        if eng.current_level is None:
            return
        fleet = eng.alive_devices()
        # het=False sessions re-solve on the homogenized fleet, exactly like
        # scheduler.schedule; chains are still priced on the real devices.
        # One DeviceTable per join event feeds every shape re-solve (the
        # vectorized planner's fast path).
        solve_fleet = cm.DeviceTable.from_devices(
            fleet if heterogeneity_aware else _homogenize(fleet))
        cache: Dict[tuple, cm.Plan] = {}
        specs: List[Tuple[int, int, List[WorkItem]]] = []
        cur = eng.current_level
        f_by_id = {d.device_id: d for d in fleet}
        for li, level in enumerate(levels):
            if li <= cur:
                continue
            seen = set()
            for g in level:
                k = plan_shape_key(g) + (g.count,)
                if k in seen:
                    continue
                seen.add(k)
                if k not in cache:
                    cache[k] = solve_level_gemm(g, solve_fleet)
                for did, items in plan_chains(g, cache[k], f_by_id,
                                              len(fleet), level=li):
                    if did in f_by_id:
                        specs.append((li, did, list(items)))
        eng.replace_future_chains(specs)

    eng = (engine_cls or TimelineEngine)(
        devices, ps_egress_bps=ps_egress_bps,
        ps_ingress_bps=ps_ingress_bps, events=events,
        jitter_alpha=jitter_alpha, rng=rng,
        repair=_repair, on_join=_on_join, trace=trace)
    for li, level in enumerate(levels):
        # same-shape GEMMs at one level share a plan and stream as one pass
        # (the analytic level time is the max over unique shapes, Eq. 1)
        seen = set()
        for g in level:
            key = plan_shape_key(g) + (g.count,)
            if key in seen:
                continue
            seen.add(key)
            for did, items in plan_chains(g, sp.plans_by_shape[key], by_id,
                                          n_pool, level=li):
                eng.add_chain(did, items, level=li)
    return eng.run(opt_tail=sp.opt_tail if opt_tail is None else opt_tail)


# ------------------------------------------------- mitigation replays (C.4) --

def replay_speculative(base_latency: float, pareto_alpha: float, r: int,
                       rng: np.random.Generator,
                       n_trials: int = 200) -> float:
    """Replay Eq. 26 as duplicate events: every trial races ``r`` replica
    chains with Pareto(α) jitter; the first response wins.  Converges to
    the exact min-of-r order statistic x_m·rα/(rα−1)/mean (repro note: the
    paper's printed Eq. 26 carries an extra r^{−1/α} factor beyond what a
    physical race of r identical duplicates can deliver — the replay is
    the physical race; tested against the exact law)."""
    tail.require_alpha_gt1(pareto_alpha, "replay_speculative")
    if r < 1:
        raise ValueError(f"replication r must be >= 1, got {r}")
    devs = [cm.Device(flops=1.0, dl_bw=1.0, ul_bw=1.0, dl_lat=0.0,
                      ul_lat=0.0, device_id=i) for i in range(r)]
    out = []
    for _ in range(n_trials):
        eng = TimelineEngine(devs, jitter_alpha=pareto_alpha, rng=rng)
        for i in range(r):
            eng.add_chain(i, [WorkItem(dl_bytes=0.0, flops=base_latency,
                                       ul_bytes=0.0)])
        rep = eng.run()
        out.append(min(rep.chain_completions.values()))
    return float(np.mean(out))


def replay_coded(base_latency: float, pareto_alpha: float, k: int, n: int,
                 rng: np.random.Generator, n_trials: int = 200) -> float:
    """Replay Eq. 28 as erasure events: each trial runs ``n`` coded chains;
    the group completes at the k-th response (any k of n reconstruct)."""
    tail.require_alpha_gt1(pareto_alpha, "replay_coded")
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k} n={n}")
    devs = [cm.Device(flops=1.0, dl_bw=1.0, ul_bw=1.0, dl_lat=0.0,
                      ul_lat=0.0, device_id=i) for i in range(n)]
    out = []
    for _ in range(n_trials):
        eng = TimelineEngine(devs, jitter_alpha=pareto_alpha, rng=rng)
        for i in range(n):
            eng.add_chain(i, [WorkItem(dl_bytes=0.0, flops=base_latency,
                                       ul_bytes=0.0)])
        rep = eng.run()
        out.append(sorted(rep.chain_completions.values())[k - 1])
    return float(np.mean(out))
