"""CLEAVE PS scheduler (§3.2, §4.1).

Processes the GEMM DAG level-by-level.  The cost-model optimization is solved
once per *unique GEMM shape* and reused across layers/levels (the paper's
cold-start amortization, Table 7).  Outputs:

* a :class:`SchedulePlan` with per-GEMM device assignments,
* the composed batch latency C_BATCH = C_GEMM(S-1) + C_OPTTAIL (Eq. 1 + §4.1),
* per-device communication and memory accounting (Figs. 1 and 5).

Every entry point accepts a :class:`~repro_torch.core.cost_model.DeviceTable`
(the fleet-array fast path — ``CleaveRuntime`` passes its cached table), a
``Fleet``, or a plain device sequence; per-device accounting accumulates
into id-indexed arrays instead of dict-of-float loops.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, MutableMapping, Optional, Sequence

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.gemm_dag import GemmDag


@dataclass
class SchedulePlan:
    dag: GemmDag
    devices: list
    plans_by_shape: Dict[tuple, cm.Plan]
    batch_time: float
    gemm_time: float
    opt_tail: float
    level_times: list
    per_device_comm: Dict[int, float]       # bytes per batch per device
    per_device_dl: Dict[int, float]
    per_device_ul: Dict[int, float]
    per_device_mem: Dict[int, float]        # peak bytes
    excluded: set = field(default_factory=set)
    # dataflow-dispatch pricing (schedule(..., overlap=True)): critical path
    # through the ready set instead of Eq. 1's sum-of-level-maxima; None
    # when the schedule was solved barrier-only
    gemm_time_overlap: Optional[float] = None

    @property
    def batch_time_overlap(self) -> Optional[float]:
        if self.gemm_time_overlap is None:
            return None
        return self.gemm_time_overlap + self.opt_tail

    @property
    def max_per_device_comm(self) -> float:
        vals = [v for k, v in self.per_device_comm.items()
                if k not in self.excluded]
        return max(vals) if vals else 0.0

    @property
    def max_per_device_mem(self) -> float:
        vals = [v for k, v in self.per_device_mem.items()
                if k not in self.excluded]
        return max(vals) if vals else 0.0


def plan_shape_key(g: cm.GEMM) -> tuple:
    return (g.m, g.n, g.q, g.b)


def solve_level_gemm(g: cm.GEMM, devices: cm.Fleetlike) -> cm.Plan:
    """Solve one level-GEMM the way the batch scheduler would: count-many
    independent instances are scheduled whole across the pool (streamed)
    unless decomposing each instance into sub-GEMM waves is faster.  The
    single entry point for anything that inserts into a shared plan cache,
    so cached plans are identical regardless of which caller solved them."""
    table = cm.DeviceTable.ensure(devices)
    if g.count > 1:
        batched = cm.solve_batched(g, table)
        sub = cm.solve_gemm(g, table)
        waves = _wave_factor(g, sub, len(table))
        if batched.makespan <= sub.makespan * waves:
            return batched
        sub.makespan *= waves
        return sub
    return cm.solve_gemm(g, table)


def schedule(dag: GemmDag, devices: cm.Fleetlike,
             ps: Optional[cm.PSConfig] = None,
             heterogeneity_aware: bool = True,
             plan_cache: Optional[MutableMapping] = None,
             overlap: bool = False) -> SchedulePlan:
    """Solve the batch schedule.  With `heterogeneity_aware=False` every
    device gets an equal share regardless of capability (Table 9 ablation).

    ``overlap=True`` additionally prices the dataflow-dispatch makespan
    (``gemm_time_overlap``): the same plans replayed through
    ``engine.price_dataflow`` with the DAG's producer edges, so a node
    launches when its inputs complete instead of at the level barrier.
    ``gemm_time``/``batch_time`` always stay the Eq. 1 barrier numbers —
    the level-mode oracle the tests pin.

    ``devices`` may be a :class:`~repro_torch.core.cost_model.DeviceTable` or any
    device sequence; the table is the fast path (the ``CleaveRuntime``
    passes its fleet-signature-cached table, so the struct-of-arrays view
    is built once per fleet, not once per schedule).

    `plan_cache`: optional shape-keyed mapping owned by the caller (the
    `CleaveRuntime` keys it by fleet signature).  Shapes already present are
    reused instead of re-solved — cold-start amortization across repeated
    steps (Table 7).  The cache must only ever see one device fleet (and one
    `heterogeneity_aware` setting)."""
    ps = ps or cm.PSConfig()
    table = cm.DeviceTable.ensure(devices)
    # plan as if homogeneous (equal shards), but *evaluate* on the real
    # fleet: the slowest participant bounds each level (Table 9)
    solve_table = table if heterogeneity_aware else table.homogenized()

    plans: MutableMapping = plan_cache if plan_cache is not None else {}
    for g in dag.gemms:
        k = plan_shape_key(g) + (g.count,)
        if k in plans:
            continue
        plans[k] = solve_level_gemm(g, solve_table)

    dag_keys = {plan_shape_key(g) + (g.count,) for g in dag.gemms}
    if not heterogeneity_aware:
        for k in dag_keys:
            reprice_plan(plans[k], table)

    level_times = []
    for level in dag.levels():
        # GEMMs inside a level are independent; the slowest GEMM in the
        # level is the level latency (Eq. 1).  count>1 GEMMs already carry
        # their batched/wave makespan from the solve above.
        t = 0.0
        for g in level:
            t = max(t, plans[plan_shape_key(g) + (g.count,)].makespan)
        level_times.append(t)
    gemm_time = float(sum(level_times))
    opt_tail = cm.optimizer_tail(dag.gemms, ps)
    batch_time = gemm_time + opt_tail

    gemm_time_overlap = None
    if overlap:
        from repro_torch.sim.engine import price_dataflow
        nodes = [(g, plans[plan_shape_key(g) + (g.count,)])
                 for g in dag.gemms]
        gemm_time_overlap = float(price_dataflow(
            nodes, list(table.devices), deps=dag.dependencies()))

    dl, ul, mem = _accounting(dag, plans, table)
    comm = {k: dl.get(k, 0.0) + ul.get(k, 0.0) for k in dl}
    # restrict to this DAG's shapes: a shared plan_cache may hold more
    dag_plans = {k: plans[k] for k in dag_keys}
    excluded = set.intersection(*[set(p.excluded)
                                  for p in dag_plans.values()]) \
        if dag_plans else set()
    return SchedulePlan(
        dag=dag, devices=list(table.devices), plans_by_shape=dag_plans,
        batch_time=batch_time, gemm_time=gemm_time, opt_tail=opt_tail,
        level_times=level_times, per_device_comm=comm, per_device_dl=dl,
        per_device_ul=ul, per_device_mem=mem, excluded=excluded,
        gemm_time_overlap=gemm_time_overlap)


def reprice_plan(p: cm.Plan, real_devices: cm.Fleetlike) -> None:
    """Re-price a plan solved on an idealized (homogenized) fleet against
    the real heterogeneous one: the slowest real participant bounds each
    level (Table 9 ablation).  Idempotent — the makespan is recomputed from
    scratch, with the n_split rounds and count>1 wave multiplier the
    het-aware solve applies."""
    table = cm.DeviceTable.ensure(real_devices)
    if p.instances is not None:
        if p.instances:
            idx = table.rows_of(p.instances.keys())
            wi = np.fromiter(p.instances.values(), np.float64,
                             count=len(p.instances))
            t = table.lat[idx] + wi * cm._instance_time_vec(p.gemm,
                                                            table)[idx]
            p.makespan = float(np.max(t))
        else:
            p.makespan = 0.0
    else:
        p.makespan = cm.plan_makespan(p.gemm, table, p) * p.n_split
        if p.gemm.count > 1:
            p.makespan *= _wave_factor(p.gemm, p, len(table))


def _wave_factor(g: cm.GEMM, plan: cm.Plan, n_devices: int) -> float:
    """`count` independent instances of the same GEMM at one level share the
    device pool.  The solver's plan uses the full pool for one instance; the
    aggregate work of `count` instances therefore takes ~count × the
    single-instance makespan when the single instance is already
    pool-saturating, but small instances (e.g. per-head s×s attention GEMMs)
    are instead spread across the pool in parallel waves."""
    if g.count <= 1:
        return 1.0
    used = max(len(plan.assignments), 1)
    concurrent = max(n_devices // used, 1)
    return float(int(np.ceil(g.count / concurrent)))


def _homogenize(devices):
    f = np.mean([d.flops for d in devices])
    dlb = np.mean([d.dl_bw for d in devices])
    ulb = np.mean([d.ul_bw for d in devices])
    mem = np.min([d.memory for d in devices])
    return [dataclasses.replace(d, flops=f, dl_bw=dlb, ul_bw=ulb, memory=mem)
            for d in devices]


def _plan_accounting_arrays(p: cm.Plan, table: cm.DeviceTable):
    """Id-indexed gather arrays for one plan, computed once per unique plan
    and reused for every DAG occurrence of its shape."""
    if p.instances is not None:
        idx = table.rows_of(p.instances.keys()) if p.instances \
            else np.zeros(0, np.int64)
        wi = np.fromiter(p.instances.values(), np.float64,
                         count=len(p.instances))
        return ("inst", idx, wi, None)
    n_a = len(p.assignments)
    idx = table.rows_of(a.device_id for a in p.assignments) if n_a \
        else np.zeros(0, np.int64)
    al = np.fromiter((a.alpha for a in p.assignments), np.float64,
                     count=n_a)
    be = np.fromiter((a.beta for a in p.assignments), np.float64,
                     count=n_a)
    return ("rect", idx, al, be)


def _accounting(dag: GemmDag, plans, table: cm.DeviceTable):
    """Per-device DL/UL/memory totals as ONE ``np.add.at`` /
    ``np.maximum.at`` pass per *unique shape* over id-indexed arrays (the
    dict-of-float accumulation this replaces looped Python-side over every
    assignment of every DAG gemm).  Repeated occurrences of a shape across
    layers/levels collapse into an occurrence multiplier.  Returns dicts
    keyed by device id, restricted to devices that appear in some plan —
    the shape the accounting strategies expect."""
    D = len(table)
    dl = np.zeros(D)
    ul = np.zeros(D)
    mem = np.zeros(D)
    touched = np.zeros(D, bool)
    occurrences: Dict[tuple, list] = {}
    for g in dag.gemms:
        k = plan_shape_key(g) + (g.count,)
        entry = occurrences.get(k)
        if entry is None:
            occurrences[k] = [g, 1]
        else:
            entry[1] += 1
    for k, (g, reps) in occurrences.items():
        p = plans[k]
        kind, idx, x, y = _plan_accounting_arrays(p, table)
        if idx.size == 0:
            continue
        if kind == "inst":
            # one entry per device: plain fancy indexing accumulates safely
            dl[idx] += reps * x * g.in_bytes
            ul[idx] += reps * x * g.out_bytes
            np.maximum.at(mem, idx, g.in_bytes + g.out_bytes)
        else:
            al, be = x, y
            np.add.at(dl, idx, reps * (al * g.n + g.n * be) * g.b * g.count)
            np.add.at(ul, idx, reps * al * be * g.b * g.count)
            np.maximum.at(mem, idx, ((al + be) * g.n + al * be) * g.b)
        touched[idx] = True
    ids = table.ids
    sel = np.nonzero(touched)[0]
    return ({int(ids[i]): float(dl[i]) for i in sel},
            {int(ids[i]): float(ul[i]) for i in sel},
            {int(ids[i]): float(mem[i]) for i in sel})
