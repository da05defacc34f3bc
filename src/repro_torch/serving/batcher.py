"""Continuous batching for fleet-backed decode.

A fixed bank of batch slots decodes every step; between steps the batcher
**retires** finished requests (their pages return to the pool) and
**admits** queued ones whose arrival time has passed and whose full budget
(prompt + max_new pages) fits — so the decode batch is always as full as
the arrival process allows, and every step's projection GEMMs keep the
same (B_slots, d) shapes (warm plan cache on the fleet, every step).

Timestamps are in the session's **virtual clock** (each step advances it by
the engine-priced fleet makespan) with measured wall-clock twins recorded
alongside — the latency report carries both.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One decode stream: a prompt, a generation budget, and its timeline."""
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new: int
    arrival: float = 0.0                # virtual-clock arrival
    tokens: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)   # virtual clock
    token_walls: List[float] = field(default_factory=list)   # wall clock
    admit_time: float = -1.0
    finish_time: float = -1.0
    admit_wall: float = -1.0
    finish_wall: float = -1.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def budget(self) -> int:
        """Total cache tokens this request may ever hold."""
        return self.prompt_len + self.max_new

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new

    @property
    def next_pos(self) -> int:
        """Absolute position of the next token to decode (the incoming
        token sits at prompt_len - 1 + n_generated)."""
        return self.prompt_len - 1 + len(self.tokens)


class ContinuousBatcher:
    """Admission/retirement over a fixed slot bank (module docstring)."""

    def __init__(self, n_slots: int, kv_cache):
        self.n_slots = int(n_slots)
        self.kv = kv_cache
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        self._pending: List[Tuple[float, int, Request]] = []   # arrival heap
        self._ids = itertools.count()
        self.finished: List[Request] = []
        self.n_admitted = 0

    # ------------------------------------------------------------- queueing --

    def submit(self, prompt, max_new: int, arrival: float = 0.0,
               rid: Optional[int] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if rid is None:
            rid = next(self._ids)
        req = Request(rid=int(rid), prompt=prompt, max_new=int(max_new),
                      arrival=float(arrival))
        heapq.heappush(self._pending, (req.arrival, req.rid, req))
        return req

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self._pending and not self.active

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    # ------------------------------------------------------ admit / retire --

    def admit(self, now: float, wall: float) -> List[Request]:
        """Fill free slots with arrived requests whose page budget fits.
        Admission order is arrival order (FIFO); a request that does not fit
        the page pool blocks the queue (no starvation of large requests)."""
        admitted = []
        for b in range(self.n_slots):
            if self.slots[b] is not None:
                continue
            if not self._pending or self._pending[0][0] > now:
                break
            req = self._pending[0][2]
            if not self.kv.can_alloc(req.budget):
                break
            heapq.heappop(self._pending)
            self.kv.alloc(req.rid, req.budget)
            req.admit_time, req.admit_wall = now, wall
            self.slots[b] = req
            admitted.append(req)
            self.n_admitted += 1
        return admitted

    def retire(self, now: float, wall: float) -> List[Request]:
        """Release finished requests' slots and pages."""
        retired = []
        for b, req in enumerate(self.slots):
            if req is not None and req.done:
                req.finish_time, req.finish_wall = now, wall
                self.kv.free(req.rid)
                self.slots[b] = None
                self.finished.append(req)
                retired.append(req)
        return retired

    def evict(self, rid: int) -> None:
        """Drop a live request without finishing it (its pages free)."""
        for b, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self.kv.free(rid)
                self.slots[b] = None
                return
        raise KeyError(f"request {rid} is not active")
