"""CLEAVE cost model and scheduler optimization (§4.1).

Implements Eq. (1)–(7): per-device sub-GEMM cost
    C(s,p,k) = max(C_dl, C_ul, C_comp)        (overlapped, Eq. 2)
    C_dl = (α n b + n β b) / W_d + L_d        (Eq. 3)
    C_ul = (α β b) / W_u + L_u
    C_comp = 2 α β n / F                      (Eq. 4)
subject to coverage Σ αβ = m q, all-or-nothing participation (Eq. 6), and
memory (α + β) n b + α β b ≤ M (Eq. 7), plus the PS-side optimizer tail
(Eq. 5).

Solver (replaces the paper's Gurobi; DESIGN.md §4): for a candidate makespan
T, the largest output share a device can finish within T is a closed-form
monotone function s_k(T); binary-search the minimum feasible T with
Σ s_k(T) ≥ 1.  Shares are then realized as an exact rectangular grid
partition (row bands × per-band column slices) with largest-remainder integer
rounding, and the *realized* makespan of that integer plan is returned, so
reported numbers never rely on the continuous relaxation.

**Fleet-array fast path**: the solver is an array program over a
:class:`DeviceTable` — a struct-of-arrays view of the fleet (flops / link
bandwidths / latencies / memory as numpy vectors).  ``feasible(T)`` is one
fused numpy pass over the whole fleet instead of a per-device Python loop,
and the Eq. 7 memory-perimeter cap is solved in closed form (the scalar
reference solver bisected it; the two agree to ~1e-12 relative — the scalar
code survives as the test oracle in ``tests/_scalar_oracle.py``).  Every
entry point accepts either a ``DeviceTable`` or a plain device sequence.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class Device:
    """An edge device: compute + asymmetric link + memory (§2.1)."""
    flops: float           # achievable FLOP/s
    dl_bw: float           # downlink bytes/s (PS -> device)
    ul_bw: float           # uplink bytes/s (device -> PS)
    dl_lat: float = 0.01   # fixed per-transfer overhead L_d (s)
    ul_lat: float = 0.01   # L_u (s)
    memory: float = 512e6  # usable bytes
    device_id: int = 0

    def as_row(self):
        return (self.flops, self.dl_bw, self.ul_bw, self.dl_lat,
                self.ul_lat, self.memory)


class DeviceTable:
    """Struct-of-arrays fleet view: the planner's unit of vectorization.

    Column vectors (float64) over the fleet in device order, plus the
    aggregate sums Eq. 18's lower bound needs.  Built once per fleet
    signature (``Fleet.table()`` caches it; ``CleaveRuntime`` plans against
    that cached table) and shared by every solver entry point.  Construction
    is O(devices); each ``feasible(T)`` probe over it is a handful of fused
    numpy passes regardless of fleet size.
    """

    __slots__ = ("ids", "flops", "dl_bw", "ul_bw", "dl_lat", "ul_lat",
                 "memory", "lat", "flops_sum", "dl_bw_sum", "ul_bw_sum",
                 "_devices", "_id_index")

    def __init__(self, ids, flops, dl_bw, ul_bw, dl_lat, ul_lat, memory,
                 devices: Optional[tuple] = None):
        self.ids = np.asarray(ids, np.int64)
        self.flops = np.asarray(flops, np.float64)
        self.dl_bw = np.asarray(dl_bw, np.float64)
        self.ul_bw = np.asarray(ul_bw, np.float64)
        self.dl_lat = np.asarray(dl_lat, np.float64)
        self.ul_lat = np.asarray(ul_lat, np.float64)
        self.memory = np.asarray(memory, np.float64)
        self.lat = np.maximum(self.dl_lat, self.ul_lat)
        self.flops_sum = float(np.sum(self.flops))
        self.dl_bw_sum = float(np.sum(self.dl_bw))
        self.ul_bw_sum = float(np.sum(self.ul_bw))
        self._devices = devices
        self._id_index: Optional[Dict[int, int]] = None

    # ------------------------------------------------------------ builders --

    @classmethod
    def from_devices(cls, devices: Iterable[Device]) -> "DeviceTable":
        devs = tuple(devices)
        rows = np.array([d.as_row() for d in devs], np.float64) \
            if devs else np.zeros((0, 6), np.float64)
        return cls(ids=[d.device_id for d in devs],
                   flops=rows[:, 0], dl_bw=rows[:, 1], ul_bw=rows[:, 2],
                   dl_lat=rows[:, 3], ul_lat=rows[:, 4], memory=rows[:, 5],
                   devices=devs)

    @classmethod
    def ensure(cls, obj: "Fleetlike") -> "DeviceTable":
        """Coerce a ``DeviceTable`` / ``Fleet`` / device sequence: tables
        pass through, fleets return their cached table, sequences build."""
        if isinstance(obj, DeviceTable):
            return obj
        table = getattr(obj, "table", None)
        if callable(table):
            return table()
        return cls.from_devices(obj)

    def homogenized(self) -> "DeviceTable":
        """Idealized equal-capability fleet (Table 9 ablation): mean compute
        and links, min memory; per-device latencies and ids kept."""
        n = len(self)
        return DeviceTable(
            ids=self.ids,
            flops=np.full(n, np.mean(self.flops)),
            dl_bw=np.full(n, np.mean(self.dl_bw)),
            ul_bw=np.full(n, np.mean(self.ul_bw)),
            dl_lat=self.dl_lat, ul_lat=self.ul_lat,
            memory=np.full(n, np.min(self.memory)) if n else self.memory)

    # ------------------------------------------------------------- queries --

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def devices(self) -> tuple:
        """The fleet as ``Device`` objects (materialized lazily — the solver
        itself never needs them)."""
        if self._devices is None:
            self._devices = tuple(
                Device(flops=float(self.flops[i]), dl_bw=float(self.dl_bw[i]),
                       ul_bw=float(self.ul_bw[i]),
                       dl_lat=float(self.dl_lat[i]),
                       ul_lat=float(self.ul_lat[i]),
                       memory=float(self.memory[i]),
                       device_id=int(self.ids[i]))
                for i in range(len(self)))
        return self._devices

    @property
    def id_index(self) -> Dict[int, int]:
        if self._id_index is None:
            self._id_index = {int(d): i for i, d in enumerate(self.ids)}
        return self._id_index

    def rows_of(self, device_ids: Iterable[int]) -> np.ndarray:
        idx = self.id_index
        return np.fromiter((idx[int(i)] for i in device_ids), np.int64)


Fleetlike = Union[DeviceTable, Sequence[Device]]


def _as_table(devices: Fleetlike) -> DeviceTable:
    return DeviceTable.ensure(devices)


@dataclass(frozen=True)
class PSConfig:
    """Parameter-server capability (§5.1: datacenter-class coordinator)."""
    net_bw: float = 25e9          # 200 Gbps
    mem_bw: float = 150e9         # DDR5 host memory bytes/s
    opt_bytes_per_param: float = 26.0   # Adam, BF16 w/grad + FP32 moments


@dataclass(frozen=True)
class GEMM:
    """One GEMM node A(m,n) @ B(n,q); b = bytes per element."""
    m: int
    n: int
    q: int
    b: int = 2
    name: str = ""
    level: int = 0
    layer: int = -1
    count: int = 1       # identical independent GEMMs at this level

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.q

    @property
    def in_bytes(self) -> float:
        return (self.m * self.n + self.n * self.q) * self.b

    @property
    def out_bytes(self) -> float:
        return self.m * self.q * self.b


@dataclass
class Assignment:
    """Integer rectangle per device: rows [r0,r1) x cols [c0,c1)."""
    device_id: int
    r0: int
    r1: int
    c0: int
    c1: int

    @property
    def alpha(self) -> int:
        return self.r1 - self.r0

    @property
    def beta(self) -> int:
        return self.c1 - self.c0


@dataclass
class Plan:
    gemm: GEMM
    assignments: list
    makespan: float
    lower_bound: float
    excluded: list = field(default_factory=list)   # straggler device ids
    n_split: int = 1   # contraction-dim splits (beyond-paper extension: when
                       # rows/cols of a huge-n GEMM exceed device memory the
                       # PS streams n in `n_split` rounds and accumulates
                       # partial outputs host-side)
    instances: Optional[dict] = None   # device_id -> whole instances, for
                                       # batched (count>1) level scheduling


# ------------------------------------------------------------ cost helpers --

def device_cost(gemm: GEMM, dev: Device, alpha: float, beta: float,
                rows_cached: float = 0.0, cols_cached: float = 0.0):
    """Eq. (2)-(4) with cache-aware DL discount (§4.2).  Returns
    (total, dl, ul, comp).  Scalar form — the vectorized equivalents live
    in :func:`plan_makespan` / :func:`_max_share_vec`."""
    if alpha <= 0 or beta <= 0:
        return 0.0, 0.0, 0.0, 0.0
    a_dl = max(alpha - rows_cached, 0.0)
    b_dl = max(beta - cols_cached, 0.0)
    dl = (a_dl * gemm.n + gemm.n * b_dl) * gemm.b / dev.dl_bw + dev.dl_lat
    ul = alpha * beta * gemm.b / dev.ul_bw + dev.ul_lat
    comp = 2.0 * alpha * beta * gemm.n / dev.flops
    return max(dl, ul, comp), dl, ul, comp


def instance_time(gemm: GEMM, dev: Device) -> float:
    """Streamed whole-instance service time: the slowest of DL / UL /
    compute for one instance (per-transfer latency accounted once per
    level, not here).  The single definition shared by the batched solver,
    the scheduler's re-pricing, and the event engine's instance chains."""
    return max(gemm.in_bytes / dev.dl_bw, gemm.out_bytes / dev.ul_bw,
               gemm.flops / dev.flops)


def _instance_time_vec(gemm: GEMM, tab: DeviceTable) -> np.ndarray:
    return np.maximum(np.maximum(gemm.in_bytes / tab.dl_bw,
                                 gemm.out_bytes / tab.ul_bw),
                      gemm.flops / tab.flops)


def plan_makespan(gemm: GEMM, devices: Fleetlike, plan: Plan) -> float:
    """Realized makespan of an integer plan: one fused pass over the
    assignment rectangles (device parameters gathered from the table)."""
    if not plan.assignments:
        return 0.0
    tab = _as_table(devices)
    idx = tab.rows_of(a.device_id for a in plan.assignments)
    al = np.fromiter((a.r1 - a.r0 for a in plan.assignments), np.int64)
    be = np.fromiter((a.c1 - a.c0 for a in plan.assignments), np.int64)
    n, b = gemm.n, gemm.b
    dl = (al * n + n * be) * b / tab.dl_bw[idx] + tab.dl_lat[idx]
    ul = al * be * b / tab.ul_bw[idx] + tab.ul_lat[idx]
    comp = 2.0 * al * be * n / tab.flops[idx]
    total = np.maximum(np.maximum(dl, ul), comp)
    total = np.where((al > 0) & (be > 0), total, 0.0)
    return float(np.max(total))


def lower_bound(gemm: GEMM, devices: Fleetlike) -> float:
    """Appendix B Eq. (18) extended with link capacity terms."""
    tab = _as_table(devices)
    t_comp = gemm.flops / tab.flops_sum
    # aggregate input dispatch over total DL; output over total UL
    t_dl = gemm.in_bytes / tab.dl_bw_sum
    t_ul = gemm.out_bytes / tab.ul_bw_sum
    return max(t_comp, t_dl, t_ul)


# ----------------------------------------------------------------- solver --

def _mem_cap_perimeter(gemm: GEMM, M: np.ndarray) -> np.ndarray:
    """Closed-form largest perimeter P with Eq. 7 memory feasibility
    ``P·n·b + area(P)·b ≤ M``, where ``area(P)`` is the balanced-aspect
    block area ``min(m, P/2) · min(q, P − min(m, P/2))`` — piecewise
    quadratic/linear in P, so g(P) inverts exactly (the scalar oracle
    bisected this to 2^-40; agreement is ~1e-12 relative)."""
    m, n, q, b = gemm.m, gemm.n, gemm.q, gemm.b
    nb = float(n) * b
    if m <= q:
        PA_hi, PB_hi = 2.0 * m, float(m + q)
        gA_hi = nb * PA_hi + (PA_hi * PA_hi / 4.0) * b
        gB_hi = nb * PB_hi + float(m) * q * b
        P_B = (M + b * float(m) * m) / (b * (n + m))
    else:
        PA_hi, PB_hi = 2.0 * q, 2.0 * m
        gA_hi = nb * PA_hi + (PA_hi * PA_hi / 4.0) * b
        gB_hi = nb * PB_hi + float(m) * q * b
        P_B = M / (nb + b * q / 2.0)
    P_A = 2.0 * (np.sqrt(nb * nb + b * M) - nb) / b
    P_C = (M - b * float(m) * q) / nb
    return np.where(M <= gA_hi, P_A, np.where(M <= gB_hi, P_B, P_C))


def _max_share_vec(gemm: GEMM, tab: DeviceTable, T: float,
                   rows_cached: Optional[np.ndarray] = None,
                   cols_cached: Optional[np.ndarray] = None):
    """Vectorized :mod:`tests._scalar_oracle` ``max_share_ref``: the largest
    output share s = αβ/(mq) every device can finish within T, with the
    balanced-aspect block choice — one fused numpy pass over the fleet.
    Returns ``(s, alpha, beta)`` vectors."""
    m, n, q, b = gemm.m, gemm.n, gemm.q, gemm.b
    mq = float(m) * q
    rc = 0.0 if rows_cached is None else rows_cached
    cc = 0.0 if cols_cached is None else cols_cached
    # perimeter cap from DL time: (α - rc + β - cc) n b / Wd + Ld <= T
    P_dl = (T - tab.dl_lat) * tab.dl_bw / (n * b) + rc + cc
    # area caps
    A_ul = (T - tab.ul_lat) * tab.ul_bw / b
    A_comp = T * tab.flops / (2.0 * n)
    P_hi = np.minimum(P_dl, float(m + q))
    ok = (T > tab.lat) & (P_hi > 0)
    # memory: (α + β) n b + α β b <= M, closed-form perimeter cap (Eq. 7)
    P = np.minimum(P_hi, _mem_cap_perimeter(gemm, tab.memory))
    # maximize αβ s.t. α+β <= P, α <= m, β <= q
    a = np.minimum(float(m), P / 2.0)
    bb = np.minimum(float(q), P - a)
    area = np.maximum(a, 0.0) * np.maximum(bb, 0.0)
    area = np.minimum(np.minimum(np.minimum(area, A_ul), A_comp), mq)
    ok &= area > 0
    areap = np.where(ok, area, 1.0)        # dummy value keeps lanes NaN-free
    # re-balance α,β to the capped area while honoring α+β <= P
    r = np.sqrt(areap)
    a2 = np.minimum(float(m), np.maximum(r, areap / q))
    b2 = areap / a2
    over = a2 + b2 > P + 1e-9
    b2 = np.where(over, np.maximum(P - a2, 0.0), b2)
    areap = np.where(over, a2 * b2, areap)
    zero = np.zeros_like(areap)
    return (np.where(ok, areap / mq, zero), np.where(ok, a2, zero),
            np.where(ok, b2, zero))


def _cache_vectors(tab: DeviceTable, caches: Optional[dict]):
    if not caches:
        return None, None
    rc = np.zeros(len(tab))
    cc = np.zeros(len(tab))
    idx = tab.id_index
    for did, (r, c) in caches.items():
        i = idx.get(int(did))
        if i is not None:
            rc[i] = r
            cc[i] = c
    return rc, cc


def solve_gemm(gemm: GEMM, devices: Fleetlike,
               caches: Optional[dict] = None,
               tol: float = 1e-3) -> Plan:
    """Binary-search the makespan; realize shares as an exact integer grid
    partition.  `caches`: device_id -> (rows_cached, cols_cached) for the
    churn-recovery reuse (§4.2).  ``devices`` may be a :class:`DeviceTable`
    (the fast path — reused across the bisection) or any device sequence."""
    tab = _as_table(devices)
    rc, cc = _cache_vectors(tab, caches)
    lb = lower_bound(gemm, tab)
    # upper bound: best single device running the whole GEMM
    m, n, q, b = gemm.m, gemm.n, gemm.q, gemm.b
    dl = (m * n + n * q) * b / tab.dl_bw + tab.dl_lat
    ul = m * q * b / tab.ul_bw + tab.ul_lat
    comp = 2.0 * m * q * n / tab.flops
    ub = float(np.min(np.maximum(np.maximum(dl, ul), comp)))
    ub = max(ub, lb * 2, 1e-6)

    def feasible(T):
        s, _, _ = _max_share_vec(gemm, tab, T, rc, cc)
        return float(np.sum(s)) >= 1.0

    # Memory-infeasible regardless of T (Σ s_k saturates below 1 because the
    # memory constraint Eq. 7 caps every device): split the contraction dim
    # and accumulate partials on the PS (beyond-paper extension; uplink pays
    # n_split × the output volume, captured by the recursive makespan).
    if not feasible(ub * 64):
        if gemm.n < 2:
            raise RuntimeError("infeasible GEMM schedule (memory too small?)")
        half = GEMM(m=gemm.m, n=(gemm.n + 1) // 2, q=gemm.q, b=gemm.b,
                    name=gemm.name, level=gemm.level, layer=gemm.layer,
                    count=gemm.count)
        sub = solve_gemm(half, tab, caches=caches, tol=tol)
        return Plan(gemm=gemm, assignments=sub.assignments,
                    makespan=2.0 * sub.makespan, lower_bound=lb,
                    excluded=sub.excluded, n_split=2 * sub.n_split)

    while not feasible(ub):
        ub *= 2.0
        if ub > 1e9:
            raise RuntimeError("infeasible GEMM schedule (memory too small?)")
    lo, hi = lb, ub
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if feasible(mid):
            hi = mid
        else:
            lo = mid
        if hi - lo < tol * hi:
            break
    T = hi

    s, a, bshare = _max_share_vec(gemm, tab, T, rc, cc)
    total = float(np.sum(s))
    # scale shares down to exactly 1 (proportional), drop zeros (Eq. 6)
    keep = np.nonzero(s > 1e-12)[0]
    ids = tab.ids
    excluded = [int(ids[i]) for i in range(len(tab)) if s[i] <= 1e-12]
    assignments = _grid_partition(
        gemm, ids[keep], s[keep] / total)
    plan = Plan(gemm=gemm, assignments=assignments, makespan=0.0,
                lower_bound=lb, excluded=excluded)
    plan.makespan = plan_makespan(gemm, tab, plan)
    return plan


def _grid_partition(gemm: GEMM, ids: np.ndarray, shares: np.ndarray) -> list:
    """Partition the m x q output into exact integer rectangles matching the
    given shares: devices grouped into row bands (heights by band share),
    column slices within each band (widths by within-band share).  The
    greedy band balancing pops the least-loaded band from a heap —
    identical placement to an argmin scan (ties resolve to the lowest band
    index in both), O(D log D) instead of O(D · bands)."""
    import heapq
    m, q = gemm.m, gemm.q
    D = len(shares)
    # desired per-device aspect: α from solver; group devices into bands
    n_bands = int(np.clip(round(np.sqrt(D * m / max(q, 1))), 1, min(D, m)))
    order = np.argsort(-shares, kind="stable")
    bands = [[] for _ in range(n_bands)]
    heap = [(0.0, j) for j in range(n_bands)]
    for i in order:                      # greedy balance band totals
        tot, jmin = heapq.heappop(heap)
        bands[jmin].append(int(i))
        heapq.heappush(heap, (tot + shares[i], jmin))
    bands = [b for b in bands if b]
    band_tot = np.array([sum(shares[i] for i in b) for b in bands])
    heights = _largest_remainder(band_tot / band_tot.sum() * m, m)
    # drop zero-height bands, merging their devices into the largest band
    merged = []
    for b, h in zip(bands, heights):
        if h == 0:
            merged.extend(b)
    if merged:
        keep = [(b, h) for b, h in zip(bands, heights) if h > 0]
        keep[0][0].extend(merged)
        bands, heights = [b for b, _ in keep], [h for _, h in keep]

    assignments = []
    r0 = 0
    for b, h in zip(bands, heights):
        w_share = shares[b]
        widths = _largest_remainder(w_share / w_share.sum() * q, q)
        c0 = 0
        for i, w in zip(b, widths):
            if w > 0 and h > 0:
                assignments.append(Assignment(
                    device_id=int(ids[i]),
                    r0=r0, r1=r0 + h, c0=c0, c1=c0 + w))
            c0 += w
        r0 += h
    return assignments


def _largest_remainder(real_parts: np.ndarray, total: int) -> list:
    fl = np.floor(real_parts).astype(int)
    rem = int(total - fl.sum())
    order = np.argsort(-(real_parts - fl))
    for i in range(rem):
        fl[order[i % len(fl)]] += 1
    return fl.tolist()


def solve_batched(gemm: GEMM, devices: Fleetlike,
                  tol: float = 1e-3) -> Plan:
    """Instance-granular scheduling for `count`-many identical independent
    GEMMs at one level (e.g. per-(batch, head) attention GEMMs, per-expert
    MoE GEMMs).  Each device processes whole instances streamed over its
    link (one fixed latency per level, per-instance transfers pipelined);
    binary-search the level makespan T with w_k(T) instances per device —
    the capacity curve is one fused pass over the fleet table."""
    tab = _as_table(devices)
    C = gemm.count
    inst_dl = gemm.in_bytes
    inst_ul = gemm.out_bytes

    fits = np.nonzero(inst_dl + inst_ul <= tab.memory)[0]
    if len(fits) == 0:
        # fall back to sub-GEMM decomposition of single instances
        p = solve_gemm(gemm, tab, tol=tol)
        p.makespan *= C
        return p

    inst = _instance_time_vec(gemm, tab)[fits]
    lat = tab.lat[fits]

    def caps(T):
        return np.maximum(0.0, (T - lat) / inst)

    lo = 0.0
    hi = float(np.max(tab.dl_lat[fits] + tab.ul_lat[fits])) + \
        C * float(np.min(inst))
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if float(np.sum(caps(mid))) >= C:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol * hi:
            break
    T = hi
    cap_T = caps(T)
    w = _largest_remainder(cap_T / max(cap_T.sum(), 1e-12) * C, C)
    ids = tab.ids
    assignments = [Assignment(device_id=int(ids[i]), r0=0, r1=gemm.m,
                              c0=0, c1=gemm.q)
                   for i, wi in zip(fits, w) if wi > 0]
    inst_per_dev = {int(ids[i]): wi for i, wi in zip(fits, w) if wi > 0}
    warr = np.asarray(w)
    used = warr > 0
    real = float(np.max(lat[used] + warr[used] * inst[used]))
    plan = Plan(gemm=gemm, assignments=assignments, makespan=real,
                lower_bound=lower_bound(gemm, tab),
                excluded=[int(i) for i in ids if int(i) not in inst_per_dev])
    plan.instances = inst_per_dev
    return plan


# --------------------------------------------------------- optimizer tail --

def optimizer_time(gemm: GEMM, ps: PSConfig) -> float:
    """Eq. (5): PS-side Adam traffic for this GEMM's weight matrix."""
    return ps.opt_bytes_per_param * gemm.n * gemm.q / ps.mem_bw


def optimizer_tail(gemms: Sequence[GEMM], ps: PSConfig) -> float:
    """C_OPTTAIL = max over weight GEMMs (pipelined by DAG level, §4.1)."""
    ts = [optimizer_time(g, ps) for g in gemms if g.layer >= 0]
    return max(ts) if ts else 0.0


# ------------------------------------------------------ PS-shard partition --

def partition_devices(devices: Fleetlike, k: int) -> list:
    """Deterministic flops-balanced K-way fleet partition (the planner's
    PS-affinity assignment for §6 multi-PS scale-out): greedy LPT — devices
    in descending flops order land on the currently-lightest shard — so
    island compute capacities stay within one device of each other and
    inner DiLoCo steps finish in commensurate time.

    ``k=1`` is the identity (original device order preserved — the
    single-PS bit-parity path); ``k>1`` shards are returned in ascending
    ``device_id`` order within each island.  Requires ``1 <= k <= len``.
    """
    tab = _as_table(devices)
    devs = list(tab.devices)
    if not 1 <= k <= len(devs):
        raise ValueError(
            f"partition_devices: need 1 <= k <= {len(devs)}, got k={k}")
    if k == 1:
        return [devs]
    bins: list = [[] for _ in range(k)]
    loads = [0.0] * k
    for d in sorted(devs, key=lambda d: (-d.flops, d.device_id)):
        i = min(range(k), key=lambda j: (loads[j], j))
        bins[i].append(d)
        loads[i] += d.flops
    return [sorted(b, key=lambda d: d.device_id) for b in bins]
