"""Struct-of-arrays event engine: the vectorized twin of ``sim.engine``.

``TimelineEngine`` replays one heap callback per stage transition —
faithful, but ~50k events/s of pure Python, far short of the 10k–1M-device
fleets the paper's edge-scale claims live at (ROADMAP item 5).  This module
rewrites the hot loop as an array program over numpy columns:

* chains live in consolidated struct-of-arrays columns (one row per
  :class:`~repro_torch.sim.engine.WorkItem`); a DAG level is priced as a handful
  of vectorized *wave folds* over item position instead of ~4 heap pops per
  item, so a level with one chain per device costs O(max-chain-length)
  numpy passes whatever the fleet size;
* injected fail/join/slowdown events cut the fold at their timestamp: items
  strictly before the cut commit, the handler mutates fleet state exactly
  like the scalar engine (same repair grouping, same load bookkeeping, same
  strict ``<`` commit rule that scalar event seq-ordering implies), and only
  the affected device's chains re-fold;
* finite PS links run in *proven-uncontended* mode: the fold assumes every
  FIFO bandwidth request is granted immediately, records each grant's
  ``[start, duration, rate]`` interval, and then proves the assumption — a
  cheap per-island rate-sum bound first, an exact concurrent-rate sweep of
  the recorded intervals when the bound is tight.  If any island would have
  queued, the run is replayed on the scalar oracle (bit-identical result,
  scalar speed) rather than approximated.

Anything the array fold cannot reproduce bit-for-bit is delegated the same
way: pipeline-mode items, dependency-gated chains (``price_dataflow``), and
Pareto jitter (whose draws are consumed through :class:`_BlockRNG`, a
bit-identical block-buffered uniform stream, so vectorized draw batching
never perturbs the sample sequence).  Delegation rebuilds the scalar engine
from the recorded construction calls, so ``ArrayTimelineEngine`` is a
drop-in ``engine_cls`` everywhere ``TimelineEngine`` is accepted and its
``TimelineReport`` matches the oracle to <=1e-9 on every scenario —
``tests/test_engine_array.py`` pins that differentially.  ``n_events`` and
``wall_time`` are backend metadata (the array engine does not pop per-stage
callbacks; it reports the equivalent scalar event count from a closed
form) and are excluded from the differential contract.
"""
from __future__ import annotations

import math
import time
from collections import deque
from collections.abc import Mapping
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.sim.engine import TimelineEngine, WorkItem
from repro_torch.sim.events import (FailEvent, JoinEvent, SlowdownEvent,
                              TimelineEvent, TimelineReport, validate_events)

_TINY = 1e-18
_FUZZ = 1.0 + 1e-12


class _NeedScalar(Exception):
    """Raised mid-fold when the no-queueing assumption breaks: the run is
    replayed on the scalar oracle instead of approximated."""


class _BlockRNG:
    """Bit-identical block-buffered view of a numpy Generator's scalar
    ``uniform()`` stream.  ``Generator.uniform(size=n)`` consumes exactly
    the same underlying doubles as n scalar draws, so serving scalar
    requests out of a vectorized block changes nothing downstream — the
    delegated jitter path draws through this so Pareto sampling is batched
    without perturbing the sequence."""

    def __init__(self, rng: np.random.Generator, block: int = 4096):
        self._rng = rng
        self._block = block
        self._buf = np.empty(0)
        self._i = 0

    def uniform(self, low=0.0, high=1.0, size=None):
        if size is not None or low != 0.0 or high != 1.0:
            return self._rng.uniform(low, high, size)
        if self._i >= self._buf.shape[0]:
            self._buf = self._rng.uniform(size=self._block)
            self._i = 0
        v = self._buf[self._i]
        self._i += 1
        return float(v)

    def __getattr__(self, name):
        return getattr(self._rng, name)


class _Dyn:
    """A chain added mid-run (repair re-dispatch, join re-plan): folded by
    the scalar helper — hot adds are rare, so python-loop cost is noise."""
    __slots__ = ("cid", "did", "level", "items", "wit", "started", "done",
                 "completed", "start_t", "finish_t", "exec_t", "s_t",
                 "done_t", "tdl", "tul", "u0l", "ncommit")

    def __init__(self, cid, did, level, items, wit):
        self.cid = cid
        self.did = did
        self.level = level
        self.items = items          # [(dl, fl, ul, dl_lat, ul_lat, setup)]
        self.wit = wit              # original WorkItems (tags for repair)
        self.started = False
        self.done = False
        self.completed = False
        self.start_t = 0.0
        self.finish_t = 0.0
        self.exec_t: List[float] = []
        self.s_t: List[float] = []
        self.done_t: List[float] = []
        self.tdl: List[float] = []
        self.tul: List[float] = []
        self.u0l: List[float] = []
        self.ncommit = 0            # items committed so far


def _cols_of(items: Sequence[WorkItem]) -> List[tuple]:
    return [(float(i.dl_bytes), float(i.flops), float(i.ul_bytes),
             float(i.dl_lat), float(i.ul_lat), float(i.setup))
            for i in items]


class ArrayTimelineEngine:
    """Drop-in :class:`~repro_torch.sim.engine.TimelineEngine` replacement with a
    vectorized deterministic hot loop.  Same constructor, ``add_chain``,
    ``run`` contract; plus :meth:`add_chains_bulk` for building 10k–1M-chain
    fleets without a python loop per item."""

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
        self._devices = list(devices)
        self._e_cap = ps_egress_bps
        self._i_cap = ps_ingress_bps
        self._ps_of = dict(ps_of or {})
        self._events = validate_events(
            list(events), device_ids={d.device_id for d in self._devices})
        self.jitter_alpha = float(jitter_alpha)
        self.rng = rng
        self._repair = repair
        self._on_join_hook = on_join
        self._trace: Optional[List[tuple]] = [] if trace else None

        # --- device state: dense-index arrays + id maps -------------------
        self._dev_idx: Dict[int, int] = {}
        self._dev_obj: List[cm.Device] = []
        self._d_flops: List[float] = []
        self._d_dlbw: List[float] = []
        self._d_ulbw: List[float] = []
        self._d_factor: List[float] = []
        self._d_alive: List[bool] = []
        self._d_load: List[float] = []
        self._d_isl: List[int] = []
        for d in self._devices:
            self._add_device(d)

        # --- staged chain construction (consolidated at run()) ------------
        self._stage_cols: List[tuple] = []      # per-item tuples
        self._stage_meta: List[tuple] = []      # (did, level, n_items)
        self._bulk: List[tuple] = []            # (dids, level, col-arrays)
        self._added: List[tuple] = []           # replay log for delegation
        self._n_chains = 0
        self._n_items = 0
        self._has_deps = False
        self._has_pipeline = False

        # --- run state ----------------------------------------------------
        self.clock = 0.0
        self.current_level: Optional[int] = None
        self.recomputed_fraction = 0.0
        self._remaining: Dict[int, int] = {}
        self._level_ends: List[Tuple[int, float]] = []
        self._completions: Dict[int, float] = {}
        self._recovery: List[list] = []
        self._dyn: Dict[int, _Dyn] = {}         # cid -> dynamic chain
        self._dyn_by_level: Dict[int, List[_Dyn]] = {}
        self._n_fail = self._n_join = self._n_slow = 0
        self._running = False
        self._frozen = False

    # ------------------------------------------------------------ set-up --

    def _add_device(self, d: cm.Device) -> None:
        self._dev_idx[d.device_id] = len(self._dev_obj)
        self._dev_obj.append(d)
        self._d_flops.append(float(d.flops))
        self._d_dlbw.append(float(d.dl_bw))
        self._d_ulbw.append(float(d.ul_bw))
        self._d_factor.append(1.0)
        self._d_alive.append(True)
        self._d_load.append(0.0)
        self._d_isl.append(int(self._ps_of.get(d.device_id, 0)))

    def _nominal_cols(self, c: tuple, di: int) -> float:
        dl, fl, ul, dll, ull, setup = c
        d = self._dev_obj[di]
        return setup + max(dl / d.dl_bw + dll, fl / d.flops,
                           ul / d.ul_bw + ull)

    def _nominal(self, it: WorkItem, d: cm.Device) -> float:
        t_dl = it.dl_bytes / d.dl_bw
        t_ul = it.ul_bytes / d.ul_bw
        t_c = it.flops / d.flops
        if it.mode == "pipeline" and it.k > 1:
            steady = max(t_dl, t_c, t_ul) / it.k
            return it.dl_lat + (t_dl + t_c + t_ul) / it.k \
                + (it.k - 1) * steady + it.ul_lat
        return it.setup + max(t_dl + it.dl_lat, t_c, t_ul + it.ul_lat)

    def add_chain(self, device_id: int, items: Sequence[WorkItem],
                  level: Optional[int] = None,
                  deps: Sequence[int] = ()) -> int:
        if device_id not in self._dev_idx:
            raise KeyError(f"unknown device {device_id}")
        lv = level if level is not None else (items[0].level if items else 0)
        cid = self._n_chains
        self._n_chains += 1
        self._n_items += len(items)
        self._added.append((device_id, tuple(items), lv, tuple(deps)))
        if deps:
            self._has_deps = True
        if any(i.mode == "pipeline" for i in items):
            self._has_pipeline = True
        di = self._dev_idx[device_id]
        d = self._dev_obj[di]
        self._d_load[di] += sum(self._nominal(i, d) for i in items)
        self._remaining[lv] = self._remaining.get(lv, 0) + 1
        if not self._running:
            self._stage_meta.append((device_id, lv, len(items)))
            self._stage_cols.extend(_cols_of(items))
        else:
            ch = _Dyn(cid, device_id, lv, _cols_of(items), tuple(items))
            self._dyn[cid] = ch
            self._dyn_by_level.setdefault(lv, []).append(ch)
            if lv == self.current_level:
                self._start_dyn(ch, self.clock)     # hot-added mid-level
        return cid

    def add_chains_bulk(self, device_ids, dl_bytes, flops, ul_bytes, *,
                        level: int = 0, dl_lat=0.0, ul_lat=0.0, setup=0.0,
                        items_per_chain: int = 1) -> range:
        """Vector construction: one chain per entry of ``device_ids``, each
        of ``items_per_chain`` identical ``overlapped`` items described by
        the (broadcastable) per-chain columns.  Equivalent to a loop of
        :meth:`add_chain` — including cid assignment order and device-load
        bookkeeping — at array speed."""
        if self._running:
            raise RuntimeError("add_chains_bulk only before run()")
        dids = np.asarray(device_ids, dtype=np.int64)
        n = dids.shape[0]
        cols = [np.broadcast_to(np.asarray(c, dtype=np.float64),
                                (n,)).astype(np.float64)
                for c in (dl_bytes, flops, ul_bytes, dl_lat, ul_lat, setup)]
        if not np.all(np.isin(dids, np.fromiter(self._dev_idx.keys(),
                                                dtype=np.int64, count=len(
                                                    self._dev_idx)))):
            bad = dids[~np.isin(dids, list(self._dev_idx))][0]
            raise KeyError(f"unknown device {int(bad)}")
        c0 = self._n_chains
        self._n_chains += n
        self._n_items += n * items_per_chain
        self._bulk.append((dids, int(level), cols, int(items_per_chain)))
        self._added.append(("__bulk__", len(self._bulk) - 1, level, ()))
        self._remaining[level] = self._remaining.get(level, 0) \
            + int(n)
        di = np.fromiter((self._dev_idx[int(x)] for x in dids),
                         dtype=np.int64, count=n)
        nom = cols[5] + np.maximum(
            np.maximum(cols[0] / np.asarray(self._d_dlbw)[di] + cols[3],
                       cols[1] / np.asarray(self._d_flops)[di]),
            cols[2] / np.asarray(self._d_ulbw)[di] + cols[4])
        loads = np.asarray(self._d_load)
        np.add.at(loads, di, nom * items_per_chain)
        self._d_load = loads.tolist()
        return range(c0, c0 + n)

    def alive_devices(self) -> List[cm.Device]:
        return [self._dev_obj[i] for i in range(len(self._dev_obj))
                if self._d_alive[i]]

    # ------------------------------------------------------- consolidate --

    def _consolidate(self) -> None:
        # staged add_chain calls and bulk blocks may interleave: replay the
        # _added log so row order == cid order
        did_parts, lv_parts, n_parts, col_blocks = [], [], [], []
        for rec in self._added:
            if rec[0] == "__bulk__":
                dids, lv, cols, ipc = self._bulk[rec[1]]
                did_parts.append(np.fromiter(
                    (self._dev_idx[int(x)] for x in dids), dtype=np.int64,
                    count=dids.shape[0]))
                lv_parts.append(np.full(dids.shape[0], lv, dtype=np.int64))
                n_parts.append(np.full(dids.shape[0], ipc, dtype=np.int64))
                block = np.stack(cols, axis=1)
                if ipc > 1:
                    block = np.repeat(block, ipc, axis=0)
                col_blocks.append(block)
            else:
                did, items, lv, _ = rec
                did_parts.append(np.asarray([self._dev_idx[did]],
                                            dtype=np.int64))
                lv_parts.append(np.asarray([lv], dtype=np.int64))
                n_parts.append(np.asarray([len(items)], dtype=np.int64))
                if items:
                    col_blocks.append(np.asarray(_cols_of(items),
                                                 dtype=np.float64))
        self.ch_did = np.concatenate(did_parts) if did_parts else \
            np.empty(0, dtype=np.int64)
        self.ch_lv = np.concatenate(lv_parts) if lv_parts else \
            np.empty(0, dtype=np.int64)
        self.ch_n = np.concatenate(n_parts) if n_parts else \
            np.empty(0, dtype=np.int64)
        cols = np.concatenate(col_blocks, axis=0) if col_blocks else \
            np.empty((0, 6))
        self.it_dl = np.ascontiguousarray(cols[:, 0])
        self.it_fl = np.ascontiguousarray(cols[:, 1])
        self.it_ul = np.ascontiguousarray(cols[:, 2])
        self.it_dllat = np.ascontiguousarray(cols[:, 3])
        self.it_ullat = np.ascontiguousarray(cols[:, 4])
        self.it_setup = np.ascontiguousarray(cols[:, 5])
        self.ch_first = np.zeros(self.ch_n.shape[0], dtype=np.int64)
        if self.ch_n.shape[0]:
            np.cumsum(self.ch_n[:-1], out=self.ch_first[1:])
        ni = self.it_dl.shape[0]
        self.it_exec = np.full(ni, np.nan)
        self.it_s = np.full(ni, np.nan)
        self.it_done = np.full(ni, np.nan)
        self.it_comm = np.zeros(ni, dtype=bool)     # committed
        self.it_popped = np.zeros(ni, dtype=bool)
        self.it_ulgrant = np.zeros(ni, dtype=bool)  # ul burst scheduled
        nc = self.ch_n.shape[0]
        self.ch_state = np.zeros(nc, dtype=np.int8)  # 0 open, 1 done
        self.ch_completed = np.zeros(nc, dtype=bool)
        self.ch_finish = np.full(nc, np.nan)
        self.ch_start = np.full(nc, np.nan)
        self._lv_static: Dict[int, np.ndarray] = {}
        if nc:
            order = np.argsort(self.ch_lv, kind="stable")
            lvs, starts = np.unique(self.ch_lv[order], return_index=True)
            for k, lv in enumerate(lvs):
                hi = starts[k + 1] if k + 1 < len(starts) else nc
                self._lv_static[int(lv)] = np.sort(order[starts[k]:hi])

        nc2 = self.ch_n.shape[0]
        self.it_ch = np.repeat(np.arange(nc2, dtype=np.int64), self.ch_n)
        self.it_di = self.ch_did[self.it_ch] if nc2 else \
            np.empty(0, dtype=np.int64)
        self.it_tdl = np.full(ni, np.nan)
        self.it_tul = np.full(ni, np.nan)
        self.it_u0 = np.full(ni, np.nan)
        dlbw = np.asarray(self._d_dlbw)[self.it_di] if ni else np.empty(0)
        ulbw = np.asarray(self._d_ulbw)[self.it_di] if ni else np.empty(0)
        flps = np.asarray(self._d_flops)[self.it_di] if ni else np.empty(0)
        self.it_nom = self.it_setup + np.maximum(
            np.maximum(self.it_dl / dlbw + self.it_dllat,
                       self.it_fl / flps),
            self.it_ul / ulbw + self.it_ullat) if ni else np.empty(0)
        self._chain_items: List[Optional[tuple]] = []
        for rec in self._added:
            if rec[0] == "__bulk__":
                self._chain_items.extend(
                    [None] * self._bulk[rec[1]][0].shape[0])
            else:
                self._chain_items.append(rec[1])

    # ---------------------------------------------------------------- run --

    def _log(self, t, kind, info):
        if self._trace is not None and len(self._trace) < 10_000:
            self._trace.append((t, kind, info))

    def run(self, opt_tail: float = 0.0) -> TimelineReport:
        wall0 = time.perf_counter()
        self._n_ctor_added = len(self._added)
        if self._has_deps or self._has_pipeline or (
                self.jitter_alpha > 1.0 and self.rng is not None):
            return self._delegate(wall0, opt_tail)
        self._running = True
        try:
            return self._run_batched(opt_tail, wall0)
        except _NeedScalar:
            return self._delegate(wall0, opt_tail)

    # ------------------------------------------------------- batched path --

    def _run_batched(self, opt_tail, wall0):
        self._consolidate()
        ev_q = deque(self._events)
        self._carry: Dict[tuple, list] = {}     # (link, island) -> orphans
        self._orph_dl: List[int] = []           # orphaned popped item rows
        self._orph_ul: List[int] = []
        self._dyn_tally: List[tuple] = []       # (di, busy) from dyn commits
        self._dyn_bytes_e = 0.0                 # dyn link-busy bytes
        self._dyn_bytes_i = 0.0
        self._dyn_ivl: List[tuple] = []         # ('e'|'i', isl, s, dur, rate)
        self._extra_pops = 0
        stuck = False
        lv = min(self._remaining) if self._remaining else None
        while lv is not None:
            self.current_level = lv
            self._log(self.clock, "level", lv)
            st = self._open_fold(lv, self.clock)
            while True:
                lv_end = self._level_end(st)
                if ev_q and (lv_end is None or ev_q[0].t <= lv_end):
                    e = ev_q.popleft()
                    self._commit_before(st, e.t)
                    self._verify(st, e.t)
                    self.clock = e.t
                    self._apply_event(e, st)
                    if self._remaining.get(lv, 0) <= 0:
                        self._close_level(st, e.t)
                        break
                elif lv_end is None:
                    self._commit_before(st, math.inf)
                    self._verify(st, math.inf)
                    stuck = True
                    break
                else:
                    self._commit_before(st, math.inf)
                    self._close_level(st, lv_end)
                    break
            if stuck:
                break
            lv = self._next_level(lv)
        self.current_level = None
        while ev_q:                      # events after the last level
            e = ev_q.popleft()
            self.clock = e.t
            self._apply_event(e, None)
        return self._report(opt_tail, wall0)

    def _next_level(self, lv):
        nxt = [x for x in self._remaining if x > lv]
        return min(nxt) if nxt else None

    # --- fold: vectorized wave over item position ------------------------

    def _open_fold(self, lv, t0):
        idx = self._lv_static.get(lv, np.empty(0, dtype=np.int64))
        idx = idx[self.ch_state[idx] == 0]
        alive = np.asarray(self._d_alive)[self.ch_did[idx]]
        live = idx[alive]
        st = {"lv": lv, "t0": t0, "live": live,
              "dead_pending": idx[~alive],
              "dyn": self._dyn_by_level.setdefault(lv, []),
              "orph_rows": [], "orph_ul_rows": []}
        # synchronous zero-item finishes (scalar finishes them inside the
        # open callback, before any same-time event pops)
        zero = live[self.ch_n[live] == 0]
        if zero.shape[0]:
            self.ch_finish[zero] = t0
            self.ch_state[zero] = 1
            self.ch_completed[zero] = True
            self._remaining[lv] = self._remaining.get(lv, 0) \
                - int(zero.shape[0])
            st["live"] = live = live[self.ch_n[live] > 0]
        self._fold_static(st, live, np.full(live.shape[0], t0))
        for ch in list(st["dyn"]):
            if not ch.started and not ch.done:
                self._start_dyn(ch, t0)
        if zero.shape[0] and self._remaining.get(lv, 0) <= 0:
            # a level emptied by synchronous zero-item finishes at open
            # time trips the scalar oracle's double-advance (_finish_chain
            # advances, then _open_level's trailing emptiness check
            # advances AGAIN, closing the next level at its open instant);
            # real planners never emit all-zero levels, so replay this
            # degenerate control flow on the oracle instead of mirroring it
            raise _NeedScalar()
        return st

    def _fold_static(self, st, cids, starts, from_j: int = 0):
        """(Re)fold ``cids`` from item position ``from_j``; ``starts`` is
        the exec time of item ``from_j`` per chain.  Expression trees mirror
        the scalar ``_exec_overlapped`` exactly, so commit decisions at
        event boundaries bit-match the oracle."""
        if cids.shape[0] == 0:
            return
        e_fin = self._e_cap is not None
        i_fin = self._i_cap is not None
        factor = np.asarray(self._d_factor)
        cur = np.asarray(starts, dtype=np.float64).copy()
        n = self.ch_n[cids]
        first = self.ch_first[cids]
        maxn = int(n.max()) if n.shape[0] else 0
        self.ch_start[cids] = np.where(np.isnan(self.ch_start[cids]),
                                       cur, self.ch_start[cids])
        for j in range(from_j, maxn):
            m = n > j
            rows = first[m] + j
            ex = cur[m]
            f = factor[self.it_di[rows]]
            d_dl = np.asarray(self._d_dlbw)[self.it_di[rows]]
            d_ul = np.asarray(self._d_ulbw)[self.it_di[rows]]
            d_fl = np.asarray(self._d_flops)[self.it_di[rows]]
            t_dl = self.it_dl[rows] / d_dl * f
            t_c = self.it_fl[rows] / d_fl * f
            t_ul = self.it_ul[rows] / d_ul * f
            s = ex + self.it_setup[rows]
            c0 = s + np.maximum(np.maximum(t_dl + self.it_dllat[rows], t_c),
                                t_ul + self.it_ullat[rows])
            if i_fin:
                ulb = self.it_ul[rows] > 0
                u0 = np.maximum(c0 - t_ul - self.it_ullat[rows], s)
                done = np.where(ulb, u0 + t_ul + self.it_ullat[rows], c0)
                self.it_u0[rows] = np.where(ulb, u0, np.nan)
            else:
                done = c0
            self.it_exec[rows] = ex
            self.it_s[rows] = s
            self.it_done[rows] = done
            self.it_tdl[rows] = t_dl
            self.it_tul[rows] = t_ul
            cur[m] = done
        self.ch_finish[cids] = cur

    def _refold_device(self, st, di, t_e):
        """Slowdown semantics: items whose exec pop is at/after ``t_e`` see
        the new factor; in-flight items keep their drawn stage times."""
        if st is None:
            return
        for c in st["live"]:
            if self.ch_state[c] != 0 or self.ch_did[c] != di:
                continue
            f0, nn = int(self.ch_first[c]), int(self.ch_n[c])
            for j in range(nn):
                if not self.it_comm[f0 + j] and self.it_exec[f0 + j] >= t_e:
                    self._fold_static(st, np.asarray([c]),
                                      np.asarray([self.it_exec[f0 + j]]),
                                      from_j=j)
                    break
        for ch in st["dyn"]:
            if ch.done or not ch.started or \
                    self._dev_idx[ch.did] != di:
                continue
            for j in range(len(ch.items)):
                if j >= ch.ncommit and ch.exec_t[j] >= t_e:
                    self._fold_dyn(ch, j, ch.exec_t[j])
                    break

    # --- dynamic (hot-added) chains --------------------------------------

    def _start_dyn(self, ch: _Dyn, t: float) -> None:
        ch.started = True
        ch.start_t = t
        if not ch.items:
            ch.done = ch.completed = True
            ch.finish_t = t
            self._completions[ch.cid] = t
            self._remaining[ch.level] = self._remaining.get(ch.level, 1) - 1
            return
        self._fold_dyn(ch, 0, t)

    def _fold_dyn(self, ch: _Dyn, from_j: int, start: float) -> None:
        i_fin = self._i_cap is not None
        di = self._dev_idx[ch.did]
        f = self._d_factor[di]
        d = self._dev_obj[di]
        cur = start
        del ch.exec_t[from_j:], ch.s_t[from_j:], ch.done_t[from_j:]
        del ch.tdl[from_j:], ch.tul[from_j:], ch.u0l[from_j:]
        for j in range(from_j, len(ch.items)):
            dl, fl, ul, dll, ull, setup = ch.items[j]
            t_dl = dl / d.dl_bw * f
            t_c = fl / d.flops * f
            t_ul = ul / d.ul_bw * f
            s = cur + setup
            c0 = s + max(t_dl + dll, t_c, t_ul + ull)
            if ul > 0 and i_fin:
                u0 = max(c0 - t_ul - ull, s)
                done = u0 + t_ul + ull
            else:
                u0 = math.nan
                done = c0
            ch.exec_t.append(cur)
            ch.s_t.append(s)
            ch.done_t.append(done)
            ch.tdl.append(t_dl)
            ch.tul.append(t_ul)
            ch.u0l.append(u0)
            cur = done
        ch.finish_t = cur

    # --- commit boundary & contention proof ------------------------------

    def _level_end(self, st) -> Optional[float]:
        """Provisional end of the open level (max unfinished finish), or
        None when unfinished chains exist that can never finish (their
        device is dead and nothing re-dispatched them — the scalar engine
        deadlocks the same way by draining its heap)."""
        best = -math.inf
        n_open = 0
        live = st["live"]
        if live.shape[0]:
            mask = self.ch_state[live] == 0
            n_open += int(mask.sum())
            if mask.any():
                best = max(best, float(self.ch_finish[live[mask]].max()))
        for ch in st["dyn"]:
            if not ch.done and ch.started:
                n_open += 1
                best = max(best, ch.finish_t)
        n_left = self._remaining.get(st["lv"], 0)
        if n_left <= 0:
            return self.clock          # emptied level closes where it stands
        if n_left > n_open:
            # unfinished chains that will never run (dead device / never
            # started): the level cannot close on its own — the scalar
            # engine drains its heap without advancing, so running chains
            # still finish but no later level opens
            return None
        return best

    def _rows_of(self, st):
        if "rows" not in st:
            live = st["live"]
            ns = self.ch_n[live]
            total = int(ns.sum())
            off = np.zeros(ns.shape[0], dtype=np.int64)
            if ns.shape[0]:
                np.cumsum(ns[:-1], out=off[1:])
            st["rows"] = np.arange(total, dtype=np.int64) \
                - np.repeat(off, ns) + np.repeat(self.ch_first[live], ns)
            st["row_ch"] = np.repeat(live, ns)
            st["bounds"] = np.concatenate(
                [[0], np.cumsum(ns)[:-1]]).astype(np.int64) \
                if ns.shape[0] else np.empty(0, dtype=np.int64)
        return st["rows"], st["row_ch"], st["bounds"]

    def _commit_before(self, st, t_e: float) -> None:
        """Commit work that the scalar engine would have popped before an
        event at ``t_e``.  Injected events are scheduled first in the
        scalar run(), so same-time completions lose the seq race: the
        commit rule is strictly ``done < t_e``."""
        rows, row_ch, _ = self._rows_of(st)
        if rows.shape[0]:
            m = (~self.it_comm[rows]) & (self.ch_state[row_ch] == 0) \
                & (self.it_done[rows] < t_e)
            sel = rows[m]
            if sel.shape[0]:
                self.it_comm[sel] = True
                loads = np.asarray(self._d_load)
                np.add.at(loads, self.it_di[sel], -self.it_nom[sel])
                self._d_load = np.maximum(loads, 0.0).tolist()
            live = st["live"]
            lasts = self.ch_first[live] + self.ch_n[live] - 1
            fin = (self.ch_state[live] == 0) & self.it_comm[lasts]
            done_c = live[fin]
            if done_c.shape[0]:
                self.ch_state[done_c] = 1
                self.ch_completed[done_c] = True
                self._remaining[st["lv"]] = \
                    self._remaining.get(st["lv"], 0) - int(done_c.shape[0])
        for ch in st["dyn"]:
            if ch.done or not ch.started:
                continue
            di = self._dev_idx[ch.did]
            while ch.ncommit < len(ch.items) and \
                    ch.done_t[ch.ncommit] < t_e:
                j = ch.ncommit
                dl, fl, ul = ch.items[j][0], ch.items[j][1], ch.items[j][2]
                self._dyn_tally.append((di, ch.done_t[j] - ch.s_t[j]))
                self._d_load[di] = max(
                    self._d_load[di] - self._nominal_cols(ch.items[j], di),
                    0.0)
                pops = 1
                if self._e_cap is not None and dl > 0:
                    self._dyn_bytes_e += dl / max(ch.tdl[j], _TINY) \
                        * ch.tdl[j]
                    pops += 1 + (1 if ch.items[j][5] > 0 else 0)
                    self._dyn_ivl.append(
                        ("e", self._d_isl[di], ch.s_t[j], ch.tdl[j],
                         dl / max(ch.tdl[j], _TINY)))
                if self._i_cap is not None and ul > 0:
                    self._dyn_bytes_i += ul / max(ch.tul[j], _TINY) \
                        * ch.tul[j]
                    pops += 2
                    self._dyn_ivl.append(
                        ("i", self._d_isl[di], ch.u0l[j], ch.tul[j],
                         ul / max(ch.tul[j], _TINY)))
                self._extra_pops += pops
                ch.ncommit += 1
            if ch.ncommit == len(ch.items) and ch.finish_t < t_e:
                ch.done = ch.completed = True
                self._completions[ch.cid] = ch.finish_t
                self._remaining[ch.level] = \
                    self._remaining.get(ch.level, 1) - 1

    def _verify(self, st, upto: float) -> None:
        """Prove the no-queueing assumption for every settled grant with
        start < ``upto``: cheap per-island bound (each chain holds at most
        one dl and one ul grant at a time), exact concurrent-rate sweep of
        the recorded intervals when the bound is inconclusive.  Raises
        :class:`_NeedScalar` on a proven violation."""
        for kind, cap in (("e", self._e_cap), ("i", self._i_cap)):
            if cap is None:
                continue
            rows, row_ch, bounds = self._rows_of(st)
            byt = self.it_dl if kind == "e" else self.it_ul
            dur = self.it_tdl if kind == "e" else self.it_tul
            beg = self.it_s if kind == "e" else self.it_u0
            extra: Dict[int, list] = {}
            for k2, isl, s0, d0, r0 in self._dyn_ivl:
                if k2 == kind and s0 < upto and d0 > 0:
                    extra.setdefault(isl, []).append((s0, d0, r0))
            for (k2, isl), lst in self._carry.items():
                if k2 == kind:
                    extra.setdefault(isl, []).extend(
                        x for x in lst if x[0] < upto)
            if rows.shape[0] == 0 and not extra:
                continue
            if rows.shape[0]:
                rate = byt[rows] / np.maximum(dur[rows], _TINY)
                rate = np.where((byt[rows] > 0) & (dur[rows] > 0)
                                & ~np.isnan(dur[rows]), rate, 0.0)
                ch_max = np.maximum.reduceat(rate, bounds) \
                    if bounds.shape[0] else np.empty(0)
                isl_ch = np.asarray(self._d_isl)[self.ch_did[st["live"]]]
                n_isl = max(max(self._d_isl), 0) + 1
                acc = np.bincount(isl_ch, weights=ch_max, minlength=n_isl)
            else:
                n_isl = max(max(self._d_isl), 0) + 1
                acc = np.zeros(n_isl)
            for isl, lst in extra.items():
                if isl < n_isl:
                    acc[isl] += sum(x[2] for x in lst)
                else:
                    acc = np.concatenate([acc, np.zeros(isl + 1 - len(acc))])
                    acc[isl] += sum(x[2] for x in lst)
            for isl in np.nonzero(acc > cap * _FUZZ)[0]:
                self._sweep_island(st, int(isl), kind, cap, upto, extra,
                                   rows, row_ch, byt, dur, beg)

    def _sweep_island(self, st, isl, kind, cap, upto, extra,
                      rows, row_ch, byt, dur, beg) -> None:
        """Exact FIFO-admission feasibility sweep for one island link."""
        ivs = list(extra.get(isl, ()))
        if rows.shape[0]:
            on_isl = np.asarray(self._d_isl)[self.it_di[rows]] == isl
            settled = self.it_comm[rows] | (self.ch_state[row_ch] == 0)
            m = on_isl & settled & (byt[rows] > 0) & (dur[rows] > 0) \
                & ~np.isnan(beg[rows]) & (beg[rows] < upto)
            sel = rows[m]
            for s0, d0, b0 in zip(beg[sel], dur[sel], byt[sel]):
                ivs.append((float(s0), float(d0), float(b0 / max(d0, _TINY))))
        if not ivs:
            return
        arr = np.asarray(ivs)
        t0s, durs, rates = arr[:, 0], arr[:, 1], arr[:, 2]
        ts = np.concatenate([t0s, t0s + durs])
        deltas = np.concatenate([rates, -rates])
        is_start = np.concatenate([np.ones(len(ivs)), np.zeros(len(ivs))])
        order = np.lexsort((is_start, ts))     # releases first at ties
        running = np.cumsum(deltas[order])
        starts = is_start[order] == 1
        before = running[starts] - deltas[order][starts]
        if np.any((before > 1e-12 * cap) &
                  (running[starts] > cap * _FUZZ)):
            raise _NeedScalar()

    def _close_level(self, st, end: float) -> None:
        self._verify(st, math.inf)
        lv = st["lv"]
        # orphaned in-flight transfers can outlive the level barrier: carry
        # them into later levels' contention proofs
        for row in st["orph_rows"]:
            e0 = float(self.it_s[row] + self.it_tdl[row])
            if e0 > end and self.it_dl[row] > 0 and self.it_tdl[row] > 0:
                isl = self._d_isl[int(self.it_di[row])]
                self._carry.setdefault(("e", isl), []).append(
                    (float(self.it_s[row]), float(self.it_tdl[row]),
                     float(self.it_dl[row] / max(self.it_tdl[row], _TINY))))
        for row in st["orph_ul_rows"]:
            e0 = float(self.it_u0[row] + self.it_tul[row])
            if e0 > end and self.it_ul[row] > 0 and self.it_tul[row] > 0:
                isl = self._d_isl[int(self.it_di[row])]
                self._carry.setdefault(("i", isl), []).append(
                    (float(self.it_u0[row]), float(self.it_tul[row]),
                     float(self.it_ul[row] / max(self.it_tul[row], _TINY))))
        for key in list(self._carry):
            self._carry[key] = [x for x in self._carry[key]
                                if x[0] + x[1] > end]
        self._dyn_ivl = [x for x in self._dyn_ivl if x[2] + x[3] > end]
        self._level_ends.append((lv, end))
        self._remaining.pop(lv, None)
        self.clock = end

    # ---------------------------------------------------- injected events --

    def _apply_event(self, e: TimelineEvent, st) -> None:
        if isinstance(e, SlowdownEvent):
            di = self._dev_idx.get(e.device_id)
            if di is None or not self._d_alive[di]:
                return
            self._d_factor[di] *= e.factor
            self._n_slow += 1
            self._log(e.t, "slowdown", (e.device_id, e.factor))
            if st is not None:
                self._refold_device(st, di, e.t)
        elif isinstance(e, JoinEvent):
            device = e.device
            did = device.device_id
            if did in self._dev_idx:
                did = max(self._dev_idx) + 1
                device = replace(device, device_id=did)
            self._add_device(device)
            self._n_join += 1
            self._log(e.t, "join", did)
            if self._on_join_hook is not None:
                self._on_join_hook(self, e.t, device)
        else:
            self._ev_fail(e.device_id, e.t, st)

    def _item_of(self, cid: int, j: int, lv: int) -> WorkItem:
        orig = self._chain_items[cid] if cid < len(self._chain_items) \
            else None
        if orig is not None:
            return replace(orig[j], level=lv)
        r = self.ch_first[cid] + j
        return WorkItem(dl_bytes=float(self.it_dl[r]),
                        flops=float(self.it_fl[r]),
                        ul_bytes=float(self.it_ul[r]),
                        dl_lat=float(self.it_dllat[r]),
                        ul_lat=float(self.it_ullat[r]),
                        setup=float(self.it_setup[r]), level=lv)

    def _ev_fail(self, did: int, t: float, st) -> None:
        di = self._dev_idx.get(did)
        if di is None or not self._d_alive[di]:
            return
        self._d_alive[di] = False
        self._n_fail += 1
        self._log(t, "fail", did)
        lost: List[WorkItem] = []
        dead_static: List[int] = []
        dead_dyn: List[_Dyn] = []
        vict_s = np.where((self.ch_did == di) & (self.ch_state == 0))[0]
        vict_d = [ch for ch in self._dyn.values()
                  if ch.did == did and not ch.done]
        victims: List[tuple] = [(int(c), "s") for c in vict_s] \
            + [(ch.cid, ch) for ch in vict_d]
        victims.sort(key=lambda x: x[0])
        for cid, kind in victims:
            if kind == "s":
                lv_c = int(self.ch_lv[cid])
                f0, nn = int(self.ch_first[cid]), int(self.ch_n[cid])
                j0 = 0
                while j0 < nn and self.it_comm[f0 + j0]:
                    j0 += 1
                folded = nn > 0 and not math.isnan(self.it_exec[f0])
                if folded and j0 < nn and self.it_exec[f0 + j0] < t:
                    # in-flight item: lost whole, its transfers orphaned
                    lost.append(self._item_of(cid, j0, lv_c))
                    r = f0 + j0
                    if self._e_cap is not None and self.it_dl[r] > 0:
                        if st is not None:
                            st["orph_rows"].append(r)
                        self._orph_dl.append(r)
                    if self._i_cap is not None and self.it_ul[r] > 0 \
                            and self.it_s[r] < t:
                        if st is not None:
                            st["orph_ul_rows"].append(r)
                        self._orph_ul.append(r)
                    self._extra_pops += 2
                    j0 += 1
                for j in range(j0, nn):
                    lost.append(self._item_of(cid, j, lv_c))
                dead_static.append(cid)
            else:
                ch = kind
                j0 = ch.ncommit
                if ch.started and j0 < len(ch.items) \
                        and ch.exec_t[j0] < t:
                    lost.append(replace(ch.wit[j0], level=ch.level))
                    dl, _, ul = ch.items[j0][0], 0, ch.items[j0][2]
                    if self._e_cap is not None and dl > 0:
                        self._dyn_ivl.append(
                            ("e", self._d_isl[di], ch.s_t[j0], ch.tdl[j0],
                             dl / max(ch.tdl[j0], _TINY)))
                        self._dyn_bytes_e += dl / max(ch.tdl[j0], _TINY) \
                            * ch.tdl[j0]
                    if self._i_cap is not None and ul > 0 \
                            and ch.s_t[j0] < t:
                        self._dyn_ivl.append(
                            ("i", self._d_isl[di], ch.u0l[j0], ch.tul[j0],
                             ul / max(ch.tul[j0], _TINY)))
                        self._dyn_bytes_i += ul / max(ch.tul[j0], _TINY) \
                            * ch.tul[j0]
                    j0 += 1
                for j in range(j0, len(ch.items)):
                    lost.append(replace(ch.wit[j], level=ch.level))
                dead_dyn.append(ch)
        if lost:
            if not any(self._d_alive):
                raise RuntimeError("no surviving devices")
            if self._repair is not None:
                placements = self._repair(self, t, did, lost)
            else:
                placements = self._default_repair(lost)
            cur_cids = self._place_repairs(placements, t)
            self._recovery.append([t, cur_cids])
        for cid in dead_static:             # after repairs are counted
            self.ch_state[cid] = 1
            self.ch_completed[cid] = False
            self.ch_finish[cid] = t
            self._remaining[int(self.ch_lv[cid])] = \
                self._remaining.get(int(self.ch_lv[cid]), 1) - 1
        for ch in dead_dyn:
            ch.done = True
            ch.completed = False
            ch.finish_t = t
            self._remaining[ch.level] = \
                self._remaining.get(ch.level, 1) - 1

    def _default_repair(self, lost: Sequence[WorkItem]
                        ) -> List[Tuple[int, WorkItem]]:
        """Greedy least-loaded redistribution, bit-matching the scalar
        tie-breaks: stable sort by descending dl+flops, first-minimal-load
        device in fleet insertion order."""
        # vectorized argmin == scalar min(alive, key=load): np.argmin and
        # the scalar min both return the FIRST minimal load in fleet
        # insertion order (dense index order)
        load = np.asarray(self._d_load)
        load[~np.asarray(self._d_alive)] = np.inf
        out = []
        for it in sorted(lost, key=lambda i: -(i.dl_bytes + i.flops)):
            best = int(np.argmin(load))
            nom = self._nominal(it, self._dev_obj[best])
            load[best] += nom
            self._d_load[best] += nom
            out.append((self._dev_obj[best].device_id, it))
        return out

    def _place_repairs(self, placements: Sequence[Tuple[int, WorkItem]],
                       t: float) -> List[int]:
        grouped: Dict[Tuple[int, int], List[WorkItem]] = {}
        for did, it in placements:
            grouped.setdefault((did, it.level), []).append(it)
        cur = []
        for (did, lv), items in sorted(grouped.items()):
            cid = self.add_chain(did, items, level=lv)
            if lv == self.current_level:
                cur.append(cid)
        return cur

    def replace_future_chains(
            self, specs: Sequence[Tuple[int, int, Sequence[WorkItem]]]
    ) -> None:
        """Drop not-yet-started chains in levels after the current one and
        install ``(level, device_id, items)`` replacements — same contract
        and load bookkeeping as the scalar engine."""
        cur = self.current_level if self.current_level is not None \
            else math.inf
        if hasattr(self, "ch_lv"):
            for c in np.where((self.ch_lv > cur)
                              & (self.ch_state == 0))[0]:
                di = int(self.ch_did[c])
                f0, nn = int(self.ch_first[c]), int(self.ch_n[c])
                nom = sum(self.it_nom[f0:f0 + nn].tolist())
                self._d_load[di] = max(self._d_load[di] - nom, 0.0)
                self.ch_state[c] = 1
                self.ch_completed[c] = False
                self.ch_finish[c] = self.clock
                lv = int(self.ch_lv[c])
                self._remaining[lv] = self._remaining.get(lv, 1) - 1
        for ch in list(self._dyn.values()):
            if ch.level > cur and not ch.started and not ch.done:
                di = self._dev_idx[ch.did]
                nom = sum(self._nominal_cols(cc, di) for cc in ch.items)
                self._d_load[di] = max(self._d_load[di] - nom, 0.0)
                ch.done = True
                ch.completed = False
                ch.finish_t = self.clock
                self._remaining[ch.level] = \
                    self._remaining.get(ch.level, 1) - 1
        for lv, did, items in specs:
            if lv > cur:
                self.add_chain(did, items, level=lv)

    # -------------------------------------------------------------- report --

    def _report(self, opt_tail: float, wall0: float) -> TimelineReport:
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

        ndev = len(self._dev_obj)
        busy = np.zeros(ndev)
        cnt = np.zeros(ndev, dtype=np.int64)
        comm_rows = np.nonzero(self.it_comm)[0]
        if comm_rows.shape[0]:
            np.add.at(busy, self.it_di[comm_rows],
                      self.it_done[comm_rows] - self.it_s[comm_rows])
            cnt += np.bincount(self.it_di[comm_rows], minlength=ndev)
        for di, b in self._dyn_tally:
            busy[di] += b
            cnt[di] += 1
        used = np.nonzero(cnt > 0)[0]
        if used.shape[0] > 200_000:
            dev_busy = _LazyMap(
                np.asarray([self._dev_obj[int(i)].device_id for i in used],
                           dtype=np.int64), busy[used])
        else:
            dev_busy = {self._dev_obj[int(i)].device_id: float(busy[i])
                        for i in used}

        # link byte-integrals: rate * dur per granted transfer, mirroring
        # the scalar _acquire expression (committed rows + orphaned grants)
        e_busy = i_busy = 0.0
        if self._e_cap is not None:
            m = self.it_comm & (self.it_dl > 0) & (self.it_tdl > 0)
            e_busy = float(np.sum(
                self.it_dl[m] / np.maximum(self.it_tdl[m], _TINY)
                * self.it_tdl[m]))
            for r in self._orph_dl:
                if self.it_dl[r] > 0 and self.it_tdl[r] > 0:
                    e_busy += self.it_dl[r] / max(self.it_tdl[r], _TINY) \
                        * self.it_tdl[r]
            e_busy += self._dyn_bytes_e
        if self._i_cap is not None:
            m = self.it_comm & (self.it_ul > 0) & (self.it_tul > 0)
            i_busy = float(np.sum(
                self.it_ul[m] / np.maximum(self.it_tul[m], _TINY)
                * self.it_tul[m]))
            for r in self._orph_ul:
                if self.it_ul[r] > 0 and self.it_tul[r] > 0:
                    i_busy += self.it_ul[r] / max(self.it_tul[r], _TINY) \
                        * self.it_tul[r]
            i_busy += self._dyn_bytes_i

        # equivalent scalar heap-pop count, closed form (backend metadata,
        # excluded from the differential contract): each committed item
        # costs one completion pop, plus its link-grant callbacks
        n_events = len(self._events) + self._extra_pops
        if comm_rows.shape[0]:
            n_events += int(comm_rows.shape[0])
            if self._e_cap is not None:
                mdl = self.it_dl[comm_rows] > 0
                n_events += int(np.sum(mdl))
                n_events += int(np.sum(mdl
                                       & (self.it_setup[comm_rows] > 0)))
            if self._i_cap is not None:
                n_events += 2 * int(np.sum(self.it_ul[comm_rows] > 0))

        done_c = np.nonzero(self.ch_completed)[0]
        if done_c.shape[0] + len(self._completions) > 200_000:
            completions = _LazyMap(done_c, self.ch_finish[done_c],
                                   extra=dict(self._completions))
        else:
            completions = {int(c): float(self.ch_finish[c]) for c in done_c}
            completions.update(self._completions)

        return TimelineReport(
            backend="event-array", makespan=gemm_end + opt_tail,
            gemm_time=gemm_end, opt_tail=opt_tail, level_times=level_times,
            n_events=n_events, n_items=self._n_items,
            n_failures=self._n_fail, n_joins=self._n_join,
            n_slowdowns=self._n_slow, recovery_latency=recovery,
            recomputed_fraction=self.recomputed_fraction,
            device_busy=dev_busy,
            ps_egress_wait=0.0, ps_ingress_wait=0.0,   # proven-uncontended
            ps_egress_busy=e_busy, ps_ingress_busy=i_busy,
            chain_completions=completions,
            wall_time=time.perf_counter() - wall0, trace=self._trace)

    # ---------------------------------------------------------- delegation --

    def _delegate(self, wall0: float, opt_tail: float) -> TimelineReport:
        """Replay the recorded construction on the scalar oracle.  Used for
        everything outside the batched fold's bit-exact envelope (deps,
        pipeline items, jitter) and whenever the contention proof fails.
        Only construction-time chains are replayed — chains hot-added by
        repair/join hooks during a failed batched attempt are re-derived by
        the scalar run itself."""
        rng = self.rng
        if self.jitter_alpha > 1.0 and rng is not None:
            rng = _BlockRNG(rng)
        eng = TimelineEngine(
            self._devices,
            ps_egress_bps=self._e_cap, ps_ingress_bps=self._i_cap,
            ps_of=(self._ps_of or None), events=self._events,
            jitter_alpha=self.jitter_alpha, rng=rng, repair=self._repair,
            on_join=self._on_join_hook, trace=self._trace is not None)
        for rec in self._added[:self._n_ctor_added]:
            if rec[0] == "__bulk__":
                dids, lv, cols, ipc = self._bulk[rec[1]]
                dl, fl, ul, dll, ull, su = cols
                for j in range(dids.shape[0]):
                    it = WorkItem(dl_bytes=float(dl[j]), flops=float(fl[j]),
                                  ul_bytes=float(ul[j]),
                                  dl_lat=float(dll[j]), ul_lat=float(ull[j]),
                                  setup=float(su[j]), level=lv)
                    eng.add_chain(int(dids[j]), [it] * ipc, level=lv)
            else:
                did, items, lv, deps = rec
                eng.add_chain(did, list(items), level=lv, deps=list(deps))
        rep = eng.run(opt_tail=opt_tail)
        rep.backend = "event-array"
        rep.wall_time = time.perf_counter() - wall0
        self._oracle = eng                 # exposed for white-box tests
        return rep


class _LazyMap(Mapping):
    """Read-mostly Mapping over parallel key/value arrays: keeps report
    construction O(1)-ish at million-chain scale (building a python dict of
    1M floats costs more than the whole simulation).  Materializes an index
    only if someone actually looks a key up."""

    def __init__(self, keys, vals, extra: Optional[dict] = None):
        self._k = keys
        self._v = vals
        self._extra = extra or {}
        self._pos: Optional[Dict[int, int]] = None

    def _index(self) -> Dict[int, int]:
        if self._pos is None:
            self._pos = {int(k): i for i, k in enumerate(self._k)}
        return self._pos

    def __getitem__(self, key):
        if key in self._extra:
            return self._extra[key]
        i = self._index().get(int(key))
        if i is None:
            raise KeyError(key)
        return float(self._v[i])

    def __iter__(self):
        idx = set(self._extra)
        for k in self._k:
            if int(k) not in idx:
                yield int(k)
        yield from self._extra

    def __len__(self):
        extra_only = sum(1 for k in self._extra
                         if int(k) not in self._index())
        return int(self._k.shape[0]) + extra_only

    def values(self):
        # fast path for aggregate consumers (min/sorted over completions)
        if not self._extra:
            return self._v.tolist()
        return super().values()


__all__ = ["ArrayTimelineEngine"]
