"""`TorchCleaveRuntime`: the plan → execute → recover → train/serve session
of the port (``src/repro/api/runtime.py``'s ``CleaveRuntime``).

It owns the DAG cache, the fleet-signature-keyed plan cache, churn
recovery that patches cached plans, and numerical execution on two
backends: ``"numpy"`` (the float64 host stand-in) and ``"torch"`` (the
band GEMM kernel on ``device``, with device-side Freivalds residuals).
``execute_batch`` runs a batch's whole GEMM DAG, level by level or
readiness-driven (``core/dataflow.py``); ``train_session`` builds
single-PS or multi-PS (DiLoCo islands) sessions with periodic
checkpoints.  ``stream_profile`` prices the streamed DL/compute/UL
pipeline (Eq. 9') and ``simulate`` replays a batch on the analytic,
discrete-event or array event engine (``sim/``) with injectable
fail/join/slowdown events; both are host-side numpy and touch no tensor.

Typical session::

    rt = TorchCleaveRuntime(arch="llama3-8b", fleet=Fleet.sample(16, seed=0))
    step = rt.execute_step(A, B, fail_ids=[7])    # the torch backend
    rt.on_failure([7])            # evict + patch cached plans
    batch = rt.execute_batch(8, 128)              # the whole DAG
    tl = rt.simulate(8, 128, events=[fail(1.0, 3)])  # a what-if, priced
    sess = rt.serve_session(params, slots=4)
    train = rt.train_session()                    # train.step(params, ...)
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.accounting import AccountingStrategy, get_accounting
from repro_torch.api.fleet import Fleet
from repro_torch.api.mitigation import (MitigationPolicy, MitigationReport,
                                        get_mitigation)
from repro_torch.configs.base import get_config
from repro_torch.core import churn, cost_model as cm, executor
from repro_torch.core.gemm_dag import GemmDag, build_dag
from repro_torch.core.scheduler import (SchedulePlan, plan_shape_key,
                                        reprice_plan, schedule,
                                        solve_level_gemm)
from repro_torch.sim.events import TimelineEvent, TimelineReport

BACKENDS = ("numpy", "torch")


# ------------------------------------------------------------------- types --

@dataclass(frozen=True)
class PlanRequest:
    """What to plan: one training (or forward-only) batch of the session's
    architecture.  Hashable -- also the runtime's DAG-cache key."""
    batch: int
    seq: int
    attention_scores: str = "ps"
    backward: bool = True
    lm_head: bool = True
    heterogeneity_aware: bool = True


@dataclass
class PlanReport:
    """Result of :meth:`TorchCleaveRuntime.plan`: the priced schedule."""
    request: PlanRequest
    accounting: str
    batch_time: float
    gemm_time: float
    opt_tail: float
    per_device_comm: float
    per_device_mem: float
    schedule: SchedulePlan
    fleet_signature: str
    solve_time: float
    cache_hits: int
    cache_misses: int
    mitigation: Optional[MitigationReport] = None

    @property
    def cached(self) -> bool:
        return self.cache_misses == 0


@dataclass
class StepReport:
    """Result of :meth:`TorchCleaveRuntime.execute_step`: one GEMM executed
    numerically on the fleet.  ``output`` is a float64 numpy array for the
    numpy backend and a float32 tensor on the runtime's device for the
    torch backend."""
    gemm: cm.GEMM
    plan: cm.Plan
    output: Union[np.ndarray, torch.Tensor]
    verified: bool
    n_tasks: int
    n_recovered: int
    recovery: Optional[churn.RecoveryResult]
    exec_time: float
    plan_cached: bool
    backend: str = "numpy"      # 'numpy' | 'torch'
    kernel: str = ""            # torch backend: resolved 'cuda' | 'torch'
    gflops: float = 0.0         # torch backend: achieved GFLOP/s
    # torch backend: the seed of the Freivalds probes (ops.rademacher)
    verify_seed: Optional[int] = None


@dataclass
class LevelReport:
    """Result of :meth:`TorchCleaveRuntime.execute_level`: one GemmDag
    level -- mutually independent GEMMs -- executed on the fleet backend,
    with the event engine's plan pricing as the predicted level
    latency."""
    steps: List[StepReport]
    backend: str
    level_time: float           # wall-clock of executing the level
    predicted_makespan: float   # engine.price_plan max over the level
    verified: bool
    n_tasks: int
    n_recovered: int

    @property
    def outputs(self) -> list:
        return [s.output for s in self.steps]


@dataclass
class BatchExecuteReport:
    """Result of :meth:`TorchCleaveRuntime.execute_batch`: the batch's
    GemmDag executed for real -- level by level (``dispatch="level"``,
    §3.2's barrier walk, the default) or readiness-driven
    (``dispatch="dataflow"``: a node launches as soon as its producers
    complete, operand staging is prefetched behind the running compute,
    and Freivalds verification overlaps downstream gathers).  Either way
    ``levels`` groups the per-GEMM steps by DAG level; under dataflow a
    level's ``level_time`` is the summed step exec time attributed to that
    level, not a measured barrier."""
    request: PlanRequest
    backend: str
    levels: List[LevelReport]
    wall_time: float
    predicted_gemm_time: float  # sum of engine-priced level makespans (Eq. 1)
    verified: bool
    n_tasks: int
    n_recovered: int
    dispatch: str = "level"     # 'level' | 'dataflow'
    # engine.price_dataflow critical path through the ready set -- the
    # barrier-free analog of predicted_gemm_time (dataflow dispatch only)
    predicted_overlap_time: Optional[float] = None
    n_redispatched: int = 0     # dependents re-run after a failed verify

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def steps(self) -> List[StepReport]:
        return [s for lev in self.levels for s in lev.steps]


@dataclass
class ChurnReport:
    """Result of :meth:`TorchCleaveRuntime.on_failure`: the fleet shrank
    and the plan cache was incrementally patched (§4.2)."""
    failed_ids: List[int]
    n_survivors: int
    n_plans_patched: int
    n_plans_carried: int
    n_plans_dropped: int
    recovery_time: float
    recomputed_fraction: float
    solve_time: float
    fleet_signature: str


@dataclass
class StreamReport:
    """Result of :meth:`CleaveRuntime.stream_profile`: the three-stage
    DL/compute/UL pipeline (Eq. 9') with optional Pareto jitter and the
    session's mitigation policy applied."""
    serial_time: float
    pipelined_time: float
    jittered_time: float
    mitigation: MitigationReport

    @property
    def overlap_speedup(self) -> float:
        return self.serial_time / max(self.pipelined_time, 1e-12)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown executor backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def _host_operand(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def host_operands(seed: int):
    """``execute_batch``'s default ``inputs`` on the numpy backend (the
    reference's): each GEMM's A and B standard normal in f32 numpy, drawn
    from one generator in the order the walk asks for them."""
    rng = np.random.default_rng(seed)

    def inputs(g: cm.GEMM):
        A = rng.standard_normal((g.m, g.n)).astype(np.float32)
        B = rng.standard_normal((g.n, g.q)).astype(np.float32)
        return A, B
    return inputs


def device_operands(device: Union[str, torch.device], seed: int):
    """``execute_batch``'s default ``inputs`` on the torch backend: each
    GEMM's A and B standard normal in f32, drawn on ``device`` from a
    generator seeded by ``seed`` and the GEMM's name, so any walk order
    sees the same operands."""
    device = torch.device(device)

    def inputs(g: cm.GEMM):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + zlib.crc32(g.name.encode()))
        return (torch.randn((g.m, g.n), generator=gen, device=device),
                torch.randn((g.n, g.q), generator=gen, device=device))
    return inputs


# ----------------------------------------------------------------- runtime --

class TorchCleaveRuntime:
    """The port's CLEAVE entry surface (see module docstring).  ``device``
    is where the torch backend runs its kernels and keeps its tensors; the
    default ``"cuda"`` raises on a host without CUDA."""

    def __init__(self, arch: Union[str, object] = "opt-13b",
                 fleet: Optional[Fleet] = None, *,
                 accounting: Union[str, AccountingStrategy] = "unicast",
                 mitigation: Union[str, MitigationPolicy, None] = "none",
                 ps: Optional[cm.PSConfig] = None,
                 attention_scores: str = "ps",
                 heterogeneity_aware: bool = True,
                 seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = get_config(arch) if isinstance(arch, str) else arch
        self.fleet = fleet if fleet is not None else Fleet.sample(256,
                                                                  seed=seed)
        self.accounting = get_accounting(accounting)
        self.mitigation = get_mitigation(mitigation)
        self.ps = ps or cm.PSConfig()
        self.attention_scores = attention_scores
        self.heterogeneity_aware = heterogeneity_aware
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.history: List[dict] = []
        self._dag_cache: Dict[PlanRequest, GemmDag] = {}
        self._plan_caches: Dict[Tuple[str, bool], Dict[tuple, cm.Plan]] = {}
        self._sched_cache: Dict[Tuple[PlanRequest, str], SchedulePlan] = {}
        # device-resident padded-operand cache of the torch backend
        self._pad_cache = None
        # warm training sessions of train_step, keyed by option values
        self._train_sessions: dict = {}

    # ---------------------------------------------------------------- plan --

    def plan(self, batch: Optional[int] = None, seq: Optional[int] = None,
             *, request: Optional[PlanRequest] = None) -> PlanReport:
        """Solve (or warm-load) the batch schedule for the session fleet."""
        if request is None:
            if batch is None or seq is None:
                raise ValueError("plan() needs batch+seq or a PlanRequest")
            request = PlanRequest(
                batch=batch, seq=seq,
                attention_scores=self.attention_scores,
                heterogeneity_aware=self.heterogeneity_aware)
        dag = self._dag(request)
        cache = self._cache(request.heterogeneity_aware)
        sched_key = (request, self.fleet.signature())
        t0 = time.perf_counter()
        sp = self._sched_cache.get(sched_key)
        if sp is not None:
            hits, misses = len(sp.plans_by_shape), 0
        else:
            shapes = {plan_shape_key(g) + (g.count,) for g in dag.gemms}
            hits = sum(1 for k in shapes if k in cache)
            misses = len(shapes) - hits
            sp = schedule(dag, self.fleet.table(), ps=self.ps,
                          heterogeneity_aware=request.heterogeneity_aware,
                          plan_cache=cache)
            self._sched_cache[sched_key] = sp
        solve_time = time.perf_counter() - t0
        acc = self.accounting.apply(dag, sp)
        report = PlanReport(
            request=request, accounting=self.accounting.name,
            batch_time=acc.batch_time, gemm_time=acc.gemm_time,
            opt_tail=acc.opt_tail, per_device_comm=acc.per_device_comm,
            per_device_mem=acc.per_device_mem, schedule=sp,
            fleet_signature=self.fleet.signature(), solve_time=solve_time,
            cache_hits=hits, cache_misses=misses,
            mitigation=self.mitigation.mitigate(acc.batch_time))
        self.history.append({
            "event": "plan", "batch": request.batch, "seq": request.seq,
            "batch_time": report.batch_time,
            "solve_time": report.solve_time, "cached": report.cached})
        return report

    def plan_gemm(self, gemm: cm.GEMM) -> cm.Plan:
        """Solve (or warm-load) one GEMM's sub-task plan."""
        plan, _ = self._solve_gemm(gemm)
        return plan

    # ------------------------------------------------------------- execute --

    def execute_step(self, A, B, *, gemm: Optional[cm.GEMM] = None,
                     fail_ids: Sequence[int] = (),
                     corrupt_ids: Sequence[int] = (),
                     verify: bool = True,
                     backend: str = "torch",
                     dtype_policy=None,
                     kernel: str = "auto") -> StepReport:
        """Numerically execute one GEMM's plan on the fleet.  Devices in
        ``fail_ids`` vanish mid-level (in-flight recovery via
        ``churn.recover``); ``corrupt_ids`` return poisoned blocks that
        Freivalds verification must catch.  Uses the session RNG, so a
        fixed-seed session is bit-reproducible.  ``A``/``B`` are numpy
        arrays or tensors; the torch backend moves them to the runtime's
        device."""
        if gemm is None:
            gemm = cm.GEMM(m=A.shape[0], n=A.shape[1], q=B.shape[1])
        plan, cached = self._solve_gemm(gemm)
        report = self._execute_one(gemm, plan, cached, A, B,
                                   fail_ids=fail_ids,
                                   corrupt_ids=corrupt_ids, verify=verify,
                                   backend=backend,
                                   dtype_policy=dtype_policy, kernel=kernel)
        self.history.append({
            "event": "execute_step", "shape": (gemm.m, gemm.n, gemm.q),
            "backend": report.backend,
            "verified": report.verified, "n_tasks": report.n_tasks,
            "n_recovered": report.n_recovered, "plan_cached": cached})
        return report

    def _torch_pad_cache(self):
        if self._pad_cache is None:
            from repro_torch.kernels.ops import PadCache
            self._pad_cache = PadCache()
        return self._pad_cache

    def _execute_one(self, gemm: cm.GEMM, plan: cm.Plan, cached: bool, A, B,
                     *, fail_ids: Sequence[int], corrupt_ids: Sequence[int],
                     verify: bool, backend: str, dtype_policy,
                     kernel: str) -> StepReport:
        _check_backend(backend)
        t0 = time.perf_counter()
        if backend == "numpy":
            rep = executor.execute_plan(gemm, plan, _host_operand(A),
                                        _host_operand(B), self.fleet.devices,
                                        fail_ids=fail_ids,
                                        corrupt_ids=corrupt_ids,
                                        rng=self.rng, verify=verify)
            kern, gflops, vseed = "", 0.0, None
        else:
            from repro_torch.core import torch_executor
            rep = torch_executor.execute_plan_torch(
                gemm, plan, A, B, self.fleet.table(), fail_ids=fail_ids,
                corrupt_ids=corrupt_ids, rng=self.rng, verify=verify,
                policy=dtype_policy, kernel=kernel,
                pad_cache=self._torch_pad_cache(), device=self.device)
            kern, gflops, vseed = rep.kernel, rep.gflops, rep.verify_seed
        return StepReport(
            gemm=gemm, plan=plan, output=rep.output, verified=rep.verified,
            n_tasks=rep.n_tasks, n_recovered=rep.n_recovered,
            recovery=rep.recovery, exec_time=time.perf_counter() - t0,
            plan_cached=cached, backend=backend, kernel=kern,
            gflops=gflops, verify_seed=vseed)

    def execute_step_deferred(self, A, B, *, gemm: Optional[cm.GEMM] = None,
                              fail_ids: Sequence[int] = (),
                              corrupt_ids: Sequence[int] = (),
                              verify: bool = True,
                              backend: str = "torch",
                              dtype_policy=None, kernel: str = "auto",
                              rng: Optional[np.random.Generator] = None,
                              staged=None):
        """Split-phase :meth:`execute_step`: returns ``(StepReport,
        finalize)``; the report carries the compute phase only and
        ``finalize()`` runs the deferred Freivalds checks, correcting failed
        blocks in place and returning the corrected rects.  ``rng`` seeds
        the checks (default: a child split off the session RNG).
        ``staged`` (numpy backend) supplies the f64 operand copies that
        ``executor.stage_operands_f64`` prefetched."""
        if gemm is None:
            gemm = cm.GEMM(m=A.shape[0], n=A.shape[1], q=B.shape[1])
        plan, cached = self._solve_gemm(gemm)
        step, fin = self._execute_one_deferred(
            gemm, plan, cached, A, B, fail_ids=fail_ids,
            corrupt_ids=corrupt_ids, verify=verify, backend=backend,
            dtype_policy=dtype_policy, kernel=kernel, rng=rng,
            staged=staged)
        self.history.append({
            "event": "execute_step", "shape": (gemm.m, gemm.n, gemm.q),
            "backend": step.backend, "deferred": True,
            "verified": step.verified, "n_tasks": step.n_tasks,
            "n_recovered": step.n_recovered, "plan_cached": cached})
        return step, fin

    def _execute_one_deferred(self, gemm: cm.GEMM, plan: cm.Plan,
                              cached: bool, A, B, *,
                              fail_ids: Sequence[int],
                              corrupt_ids: Sequence[int], verify: bool,
                              backend: str, dtype_policy, kernel: str,
                              rng: Optional[np.random.Generator] = None,
                              staged=None):
        """Split-phase :meth:`_execute_one`; ``finalize()`` may run on
        another thread than the compute (the dataflow dispatch), and every
        tensor it touches names its device."""
        _check_backend(backend)
        if rng is None:
            # never hand the session generator to overlapped verification
            rng = np.random.default_rng(self.rng.integers(2 ** 63 - 1))
        t0 = time.perf_counter()
        if backend == "numpy":
            rep, fin = executor.execute_plan_deferred(
                gemm, plan, _host_operand(A), _host_operand(B),
                self.fleet.devices, fail_ids=fail_ids,
                corrupt_ids=corrupt_ids, rng=rng, verify=verify,
                staged=staged)
            kern, gflops, vseed = "", 0.0, None
        else:
            from repro_torch.core import torch_executor
            rep, fin = torch_executor.execute_plan_torch_deferred(
                gemm, plan, A, B, self.fleet.table(), fail_ids=fail_ids,
                corrupt_ids=corrupt_ids, rng=rng, verify=verify,
                policy=dtype_policy, kernel=kernel,
                pad_cache=self._torch_pad_cache(), device=self.device)
            kern, gflops, vseed = rep.kernel, rep.gflops, rep.verify_seed
        step = StepReport(
            gemm=gemm, plan=plan, output=rep.output, verified=rep.verified,
            n_tasks=rep.n_tasks, n_recovered=rep.n_recovered,
            recovery=rep.recovery, exec_time=time.perf_counter() - t0,
            plan_cached=cached, backend=backend, kernel=kern,
            gflops=gflops, verify_seed=vseed)

        def finalize():
            corrected = fin()
            step.verified = rep.verified
            step.n_recovered = rep.n_recovered
            return corrected

        return step, finalize

    def execute_level(self, pairs: Sequence[tuple], *,
                      gemms: Optional[Sequence[cm.GEMM]] = None,
                      fail_ids: Sequence[int] = (),
                      corrupt_ids: Sequence[int] = (),
                      verify: bool = True, backend: str = "torch",
                      dtype_policy=None, kernel: str = "auto",
                      heterogeneity_aware: Optional[bool] = None
                      ) -> LevelReport:
        """Execute one GemmDag level: ``pairs`` is the level's ``(A, B)``
        operand list (mutually independent GEMMs, Eq. 1; numpy arrays or
        tensors).  Each GEMM's plan is solved (or warm-loaded) from the
        session cache and run on the chosen backend; the report carries the
        event engine's ``price_plan`` level makespan next to the measured
        wall time.  ``heterogeneity_aware`` overrides the session flag
        (``None``), so an ablation request executes the plans it
        priced."""
        from repro_torch.sim.engine import price_plan
        if gemms is None:
            gemms = [cm.GEMM(m=A.shape[0], n=A.shape[1], q=B.shape[1])
                     for A, B in pairs]
        if len(gemms) != len(pairs):
            raise ValueError(f"{len(pairs)} operand pairs for "
                             f"{len(gemms)} GEMMs")
        t0 = time.perf_counter()
        steps: List[StepReport] = []
        predicted = 0.0
        for g, (A, B) in zip(gemms, pairs):
            plan, cached = self._solve_gemm(
                g, heterogeneity_aware=heterogeneity_aware)
            predicted = max(predicted, price_plan(g, plan,
                                                  self.fleet.devices))
            steps.append(self._execute_one(
                g, plan, cached, A, B, fail_ids=fail_ids,
                corrupt_ids=corrupt_ids, verify=verify, backend=backend,
                dtype_policy=dtype_policy, kernel=kernel))
        report = LevelReport(
            steps=steps, backend=backend,
            level_time=time.perf_counter() - t0,
            predicted_makespan=predicted,
            verified=all(s.verified for s in steps),
            n_tasks=sum(s.n_tasks for s in steps),
            n_recovered=sum(s.n_recovered for s in steps))
        self.history.append({
            "event": "execute_level", "backend": backend,
            "n_gemms": len(steps), "n_tasks": report.n_tasks,
            "n_recovered": report.n_recovered,
            "verified": report.verified})
        return report

    def execute_batch(self, batch: Optional[int] = None,
                      seq: Optional[int] = None, *,
                      request: Optional[PlanRequest] = None,
                      inputs=None, max_levels: Optional[int] = None,
                      verify: bool = True, backend: str = "torch",
                      dtype_policy=None, kernel: str = "auto",
                      seed: Optional[int] = None,
                      dispatch: str = "level",
                      fail_ids: Sequence[int] = (),
                      corrupt_ids: Sequence[int] = (),
                      dataflow_workers: Optional[int] = None
                      ) -> BatchExecuteReport:
        """Execute the batch's GemmDag for real on the chosen backend -- the
        schedule the session prices is the schedule that runs.

        ``dispatch="level"`` (default) is the §3.2 barrier walk;
        ``dispatch="dataflow"`` runs the readiness-driven walk
        (``core.dataflow``): each GEMM launches as soon as its producers
        complete, operand staging prefetches behind the running compute
        (the f64 copies of the numpy backend; the padded device operands
        of the torch backend, into the runtime's ``PadCache``), and
        Freivalds verification of node *k* overlaps node *k+1*'s gathers
        (a failed check corrects the block and re-dispatches only the
        dependents already in flight).  Outputs are identical for a fixed
        seed.  On an H100 the level walk is the faster of the two (PERF.md
        §6), hence the default.

        ``inputs`` maps a GEMM to its ``(A, B)`` operands, numpy arrays or
        tensors (default: seeded standard normals in f32, drawn on the
        runtime's device for the torch backend, :func:`device_operands`,
        and in level order on the host for the numpy backend,
        :func:`host_operands`); count>1 GEMMs execute one representative
        instance.  ``max_levels`` bounds the walk.  ``fail_ids`` /
        ``corrupt_ids`` inject device failure / poisoned blocks into every
        executed GEMM."""
        if request is None:
            if batch is None or seq is None:
                raise ValueError("execute_batch() needs batch+seq or a "
                                 "PlanRequest")
            request = PlanRequest(
                batch=batch, seq=seq,
                attention_scores=self.attention_scores,
                heterogeneity_aware=self.heterogeneity_aware)
        if dispatch not in ("level", "dataflow"):
            raise ValueError(f"unknown dispatch {dispatch!r}; "
                             "expected 'level' or 'dataflow'")
        _check_backend(backend)
        dag = self._dag(request)
        if inputs is None:
            seed = self.seed if seed is None else seed
            inputs = host_operands(seed) if backend == "numpy" \
                else device_operands(self.device, seed)
        t0 = time.perf_counter()
        if dispatch == "level":
            levels: List[LevelReport] = []
            for li, level in enumerate(dag.levels()):
                if max_levels is not None and li >= max_levels:
                    break
                pairs = [inputs(g) for g in level]
                levels.append(self.execute_level(
                    pairs, gemms=level, verify=verify, backend=backend,
                    fail_ids=fail_ids, corrupt_ids=corrupt_ids,
                    dtype_policy=dtype_policy, kernel=kernel,
                    heterogeneity_aware=request.heterogeneity_aware))
            overlap_time, n_redispatched = None, 0
        else:
            levels, overlap_time, n_redispatched = self._execute_dataflow(
                dag, inputs, max_levels=max_levels, verify=verify,
                backend=backend, dtype_policy=dtype_policy, kernel=kernel,
                heterogeneity_aware=request.heterogeneity_aware,
                fail_ids=fail_ids, corrupt_ids=corrupt_ids,
                max_workers=dataflow_workers)
        report = BatchExecuteReport(
            request=request, backend=backend, levels=levels,
            wall_time=time.perf_counter() - t0,
            predicted_gemm_time=float(sum(l.predicted_makespan
                                          for l in levels)),
            verified=all(l.verified for l in levels),
            n_tasks=sum(l.n_tasks for l in levels),
            n_recovered=sum(l.n_recovered for l in levels),
            dispatch=dispatch, predicted_overlap_time=overlap_time,
            n_redispatched=n_redispatched)
        self.history.append({
            "event": "execute_batch", "backend": backend,
            "dispatch": dispatch,
            "batch": request.batch, "seq": request.seq,
            "n_levels": report.n_levels, "n_tasks": report.n_tasks,
            "verified": report.verified})
        return report

    def _execute_dataflow(self, dag, inputs, *, max_levels, verify,
                          backend, dtype_policy, kernel,
                          heterogeneity_aware, fail_ids, corrupt_ids,
                          max_workers=None):
        """Readiness-driven DAG execution (the ``execute_batch`` dataflow
        path): plans are pre-solved serially, operands pre-drawn in level
        order (the same draws the barrier walk makes), then
        ``core.dataflow.run_dataflow`` dispatches nodes as their producers
        finish, on worker threads.  Those threads share the runtime's
        locked ``PadCache`` and launch on the device the runtime names
        (the kernels take the stream of the output's device, not of the
        thread's current device).  Returns level-grouped StepReports plus
        the ``price_dataflow`` overlapped prediction and the redispatch
        count."""
        from repro_torch.core.dataflow import run_dataflow
        from repro_torch.sim.engine import price_dataflow, price_plan

        level_groups = dag.level_order()
        if max_levels is not None:
            level_groups = level_groups[:max_levels]
        included = [i for grp in level_groups for i in grp]
        idx_of = {i: k for k, i in enumerate(included)}
        gemms = [dag.gemms[i] for i in included]
        operands = [inputs(g) for g in gemms]       # level-order draws
        plans, cached = [], []
        for g in gemms:
            p, c = self._solve_gemm(
                g, heterogeneity_aware=heterogeneity_aware)
            plans.append(p)
            cached.append(c)
        prices = [price_plan(g, p, self.fleet.devices)
                  for g, p in zip(gemms, plans)]
        full_deps = dag.dependencies()
        deps = [[idx_of[j] for j in full_deps[i] if j in idx_of]
                for i in included]
        overlap_time = float(price_dataflow(
            list(zip(gemms, plans)), list(self.fleet.devices), deps=deps))

        compute_dtype = None
        if backend == "torch":
            from repro_torch.core.torch_executor import get_policy
            compute_dtype = get_policy(dtype_policy,
                                       self.device).compute_dtype
            self._torch_pad_cache()     # built before the threads start
        self.fleet.table()          # build the SoA view before threading
        base_seed = int(self.rng.integers(2 ** 63 - 1))
        staged: Dict[int, tuple] = {}

        def compute(k):
            A, B = operands[k]
            return self._execute_one_deferred(
                gemms[k], plans[k], cached[k], A, B, fail_ids=fail_ids,
                corrupt_ids=corrupt_ids, verify=verify, backend=backend,
                dtype_policy=dtype_policy, kernel=kernel,
                rng=np.random.default_rng([base_seed, k]),
                staged=staged.get(k))

        def prefetch(k):
            A, B = operands[k]
            if backend == "numpy":
                staged[k] = executor.stage_operands_f64(
                    _host_operand(A), _host_operand(B))
            elif not fail_ids:
                # warm the device-side PadCache with the node's padded
                # operands (recovery reshapes the rects, so a failing run
                # stages inside the launch instead)
                from repro_torch.kernels import ops
                rects = [(a.r0, a.r1, a.c0, a.c1)
                         for a in plans[k].assignments]
                if rects:
                    ops.stage_plan_operands(
                        A, B, rects, compute_dtype=compute_dtype,
                        pad_cache=self._pad_cache, device=self.device)

        steps, dfr = run_dataflow(len(included), deps, compute,
                                  prefetch=prefetch,
                                  max_workers=max_workers)
        levels: List[LevelReport] = []
        for grp in level_groups:
            ks = [idx_of[i] for i in grp]
            lsteps = [steps[k] for k in ks]
            levels.append(LevelReport(
                steps=lsteps, backend=backend,
                level_time=float(sum(s.exec_time for s in lsteps)),
                predicted_makespan=float(max(prices[k] for k in ks)),
                verified=all(s.verified for s in lsteps),
                n_tasks=sum(s.n_tasks for s in lsteps),
                n_recovered=sum(s.n_recovered for s in lsteps)))
        return levels, overlap_time, dfr.n_redispatched

    # ---------------------------------------------------------------- train --

    def train_session(self, opt_cfg=None, *, backend: str = "torch",
                      kernel: str = "auto", dtype_policy=None,
                      verify: bool = True, q_chunk: int = 64,
                      k_chunk: int = 64, loss_chunk: int = 64,
                      dispatch: str = "level", n_ps: int = 1,
                      diloco=None, checkpoint=None,
                      checkpoint_every: int = 100,
                      backbone_bps: Optional[float] = None):
        """A fresh PS-centric training session
        (:class:`repro_torch.train_loop.FleetTrainSession`): every
        projection GEMM of ``session.step(params, opt_state, batch)`` --
        forward and the dA/dW backward mirrors -- executes through this
        runtime's fleet executors (plan cache, Freivalds, churn recovery;
        the band GEMM kernel with ``backend="torch"`` on the card), while
        the PS hosts embeddings, norms, RoPE, attention, the loss and AdamW
        on the runtime's device (§3.2).

        ``dispatch="dataflow"`` defers each GEMM's Freivalds verification
        to a background worker, overlapped with the next GEMM; ``"level"``
        verifies inline.

        ``checkpoint`` (a directory path or a
        :class:`~repro_torch.checkpointing.checkpoint.CheckpointManager`)
        enables periodic PS-side snapshots every ``checkpoint_every``
        steps; ``session.restore(...)`` resumes bit-exactly.

        ``n_ps > 1`` (or ``n_ps=None`` for envelope auto-sizing, or an
        explicit ``diloco`` config) instead returns a
        :class:`repro_torch.train_loop.MultiPSTrainSession`: the fleet is
        partitioned into flops-balanced PS islands (``api.ShardedFleet``),
        each island runs H local inner steps per round
        (``diloco.inner_steps``), and the sharded DiLoCo outer loop syncs
        them at round boundaries -- ``n_ps=1`` with ``inner_steps=1`` is
        bit-identical to the single-PS session.  ``backbone_bps``
        optionally prices the cross-PS sync over one shared backbone link
        instead of per-PS NICs."""
        if n_ps is None or n_ps > 1 or diloco is not None:
            from repro_torch.train_loop import MultiPSTrainSession
            return MultiPSTrainSession(
                self, n_ps=n_ps, opt_cfg=opt_cfg, diloco=diloco,
                backend=backend, kernel=kernel, dtype_policy=dtype_policy,
                verify=verify, q_chunk=q_chunk, k_chunk=k_chunk,
                loss_chunk=loss_chunk, dispatch=dispatch,
                checkpoint=checkpoint, checkpoint_every=checkpoint_every,
                backbone_bps=backbone_bps)
        from repro_torch.train_loop import FleetTrainSession
        return FleetTrainSession(self, opt_cfg=opt_cfg, backend=backend,
                                 kernel=kernel, dtype_policy=dtype_policy,
                                 verify=verify, q_chunk=q_chunk,
                                 k_chunk=k_chunk, loss_chunk=loss_chunk,
                                 dispatch=dispatch, checkpoint=checkpoint,
                                 checkpoint_every=checkpoint_every)

    def train_step(self, params, opt_state, batch, *, opt_cfg=None,
                   backend: str = "torch", kernel: str = "auto",
                   verify: bool = True,
                   fail_ids: Sequence[int] = (), fail_at_gemm: int = 0,
                   q_chunk: int = 64, k_chunk: int = 64,
                   loss_chunk: int = 64, dispatch: str = "level"):
        """One fleet-executed training step of the session architecture:
        the monolithic ``launch.steps.make_train_step`` math while every
        projection GEMM runs on the fleet.  Returns ``(params, opt_state,
        metrics)``; ``metrics["fleet"]`` is the step's
        :class:`~repro_torch.train_loop.FleetStepReport`.  ``fail_ids``
        injects a mid-step device failure at the ``fail_at_gemm``-th GEMM.
        Sessions are cached per option values, so repeated calls stay
        warm; use :meth:`train_session` for explicit session control."""
        # AdamConfig is a frozen dataclass: keying by value means equal
        # configs share a warm session; None normalizes to the default
        if opt_cfg is None:
            from repro_torch.optim import adam
            opt_cfg = adam.AdamConfig()
        key = (opt_cfg, backend, kernel, verify, q_chunk, k_chunk,
               loss_chunk, dispatch)
        session = self._train_sessions.get(key)
        if session is None:
            session = self.train_session(
                opt_cfg, backend=backend, kernel=kernel, verify=verify,
                q_chunk=q_chunk, k_chunk=k_chunk, loss_chunk=loss_chunk,
                dispatch=dispatch)
            self._train_sessions[key] = session
        return session.step(params, opt_state, batch, fail_ids=fail_ids,
                            fail_at_gemm=fail_at_gemm)

    # ---------------------------------------------------------------- serve --

    def serve_session(self, params=None, *, slots: int = 8,
                      page_size: int = 16, max_len: int = 64,
                      kv_int8: bool = False, backend: str = "torch",
                      kernel: str = "auto", dtype_policy=None,
                      verify: bool = True, check_paged_read: bool = False,
                      n_pages: Optional[int] = None, seed: int = 0,
                      dispatch: str = "level"):
        """A fleet-backed decode serving session
        (:class:`repro_torch.serving.ServeSession`) on the runtime's
        device: continuous batching over ``slots`` lanes, a paged KV cache
        on the device, and every per-token projection GEMM executed on this
        runtime's fleet (plan cache, Freivalds, churn recovery) -- through
        the band GEMM kernel with ``backend="torch"``."""
        from repro_torch.serving import ServeSession
        return ServeSession(self, params, slots=slots, page_size=page_size,
                            max_len=max_len, kv_int8=kv_int8,
                            backend=backend, kernel=kernel,
                            dtype_policy=dtype_policy, verify=verify,
                            check_paged_read=check_paged_read,
                            n_pages=n_pages, seed=seed, dispatch=dispatch)

    # -------------------------------------------------------------- recover --

    def on_failure(self, ids: Sequence[int]) -> ChurnReport:
        """Evict failed devices and incrementally patch every cached plan:
        survivors keep their shards, only orphaned rectangles are re-solved
        (§4.2).  Patched plans land in the new fleet signature's cache."""
        failed = set(int(i) for i in ids)
        new_fleet = self.fleet.without(failed)
        if not len(new_fleet):
            raise RuntimeError("no surviving devices")
        survivors = new_fleet.table()
        old_sig, new_sig = self.fleet.signature(), new_fleet.signature()
        t0 = time.perf_counter()
        patched = carried = dropped = 0
        worst_time = worst_frac = 0.0
        for het in (True, False):
            old_cache = self._plan_caches.get((old_sig, het), {})
            if not old_cache:
                continue
            new_cache = self._plan_caches.setdefault((new_sig, het), {})
            for key, plan in old_cache.items():
                if key in new_cache:
                    continue
                out = _patch_plan(plan, failed, survivors)
                if out is None:
                    dropped += 1
                    continue
                new_plan, rec = out
                new_cache[key] = new_plan
                if rec is None:
                    carried += 1
                else:
                    patched += 1
                    worst_time = max(worst_time, rec.recovery_time)
                    worst_frac = max(worst_frac, rec.recomputed_fraction)
        report = ChurnReport(
            failed_ids=sorted(failed), n_survivors=len(new_fleet),
            n_plans_patched=patched, n_plans_carried=carried,
            n_plans_dropped=dropped,
            recovery_time=worst_time, recomputed_fraction=worst_frac,
            solve_time=time.perf_counter() - t0,
            fleet_signature=new_sig)
        self.fleet = new_fleet
        self.history.append({
            "event": "on_failure", "failed_ids": report.failed_ids,
            "n_survivors": report.n_survivors,
            "n_plans_patched": report.n_plans_patched,
            "n_plans_carried": report.n_plans_carried,
            "n_plans_dropped": report.n_plans_dropped})
        return report

    def on_join(self, device: cm.Device, keep_id: bool = False) -> Fleet:
        """Admit a joiner into the fleet for the next round."""
        self.fleet = self.fleet.admit(device, keep_id=keep_id)
        return self.fleet

    # -------------------------------------------------------------- stream --

    def stream_profile(self, gemm: cm.GEMM, *, alpha: int = 10,
                       beta: int = 10, k: int = 64,
                       pareto_alpha: float = 0.0,
                       device: Optional[cm.Device] = None,
                       n_trials: int = 20) -> StreamReport:
        """Profile the streamed row-column pipeline (Eq. 9') for ``k``
        (alpha x beta) work quanta on a representative edge device, with
        optional Pareto(α) stage jitter, and apply the session mitigation
        policy to the jittered latency.

        ``device`` is a :class:`cost_model.Device` of the fleet, not the
        torch device the runtime keeps its tensors on (``self.device``);
        the default is the fleet's median device by flops.
        ``pareto_alpha=0`` (the default) means a deterministic profile; any
        other value must exceed 1 for a finite-mean Pareto, matching the
        ``tail``/``streaming`` entry points.  Jittered trials draw from the
        session's ``rng``."""
        from repro_torch.core import streaming, tail
        if pareto_alpha != 0.0:
            tail.require_alpha_gt1(pareto_alpha, "stream_profile")
        edge = device
        if edge is None:
            devs = sorted(self.fleet.devices, key=lambda d: d.flops)
            edge = devs[len(devs) // 2]
        c = streaming.pair_cost(gemm, edge, alpha=alpha, beta=beta)
        serial = k * (edge.dl_lat + c.t_dl + c.t_comp + c.t_ul
                      + edge.ul_lat)
        piped = streaming.pipeline_time(c, k, dl_lat=edge.dl_lat,
                                        ul_lat=edge.ul_lat)
        if pareto_alpha > 1.0:
            jittered = float(np.mean([
                streaming.simulate_stream(c, k, edge.dl_lat, edge.ul_lat,
                                          jitter=self.rng,
                                          pareto_alpha=pareto_alpha)
                for _ in range(n_trials)]))
        else:
            jittered = piped
        report = StreamReport(serial_time=serial, pipelined_time=piped,
                              jittered_time=jittered,
                              mitigation=self.mitigation.mitigate(jittered))
        self.history.append({
            "event": "stream_profile", "k": k,
            "overlap_speedup": report.overlap_speedup})
        return report

    # ------------------------------------------------------------ simulate --

    def simulate(self, batch: Optional[int] = None,
                 seq: Optional[int] = None, *,
                 request: Optional[PlanRequest] = None,
                 events: Sequence[TimelineEvent] = (),
                 backend: str = "event",
                 jitter_alpha: float = 0.0,
                 ps_contention: bool = False,
                 seed: Optional[int] = None,
                 trace: bool = False) -> TimelineReport:
        """Price one batch on a simulation backend (host-side numpy: no
        tensor is made and no kernel runs).

        ``backend="analytic"`` returns the closed-form accounting
        (Eq. 1/2-5) as a :class:`TimelineReport`, but cannot price events.
        ``backend="event"`` replays the solved schedule on the
        discrete-event fleet engine: ``events`` (``sim.events``
        ``fail``/``join``/``slowdown``) are injected on the timeline,
        ``jitter_alpha`` adds per-stage Pareto(α) jitter drawn from
        ``seed`` (the session's seed by default), and ``ps_contention=True``
        bounds aggregate transfers by the session ``PSConfig.net_bw`` (§6).
        With no events, jitter or contention the event backend reproduces
        the analytic unicast batch time (to 1e-6 relative).
        ``backend="event-array"`` prices the same scenario on the
        struct-of-arrays engine (``sim.engine_array``) to <=1e-9, replaying
        on the scalar engine outside its bit-exact envelope.

        Simulation never mutates the session's fleet: a ``fail`` event here
        prices the what-if; :meth:`on_failure` evicts devices."""
        if request is None:
            if batch is None or seq is None:
                raise ValueError("simulate() needs batch+seq or a "
                                 "PlanRequest")
            request = PlanRequest(
                batch=batch, seq=seq,
                attention_scores=self.attention_scores,
                heterogeneity_aware=self.heterogeneity_aware)
        from repro_torch.sim import engine as eng_mod
        from repro_torch.sim.events import validate_events
        evs = validate_events(list(events))
        if backend == "analytic":
            if evs or jitter_alpha or ps_contention:
                raise ValueError(
                    "backend='analytic' cannot price injected events, "
                    "jitter, or PS contention; use backend='event'")
            sp = self.plan(request=request).schedule
            report = TimelineReport(
                backend="analytic", makespan=sp.batch_time,
                gemm_time=sp.gemm_time, opt_tail=sp.opt_tail,
                level_times=list(sp.level_times))
        elif backend in ("event", "event-array"):
            from repro_torch.sim.events import FailEvent, SlowdownEvent
            known = {d.device_id for d in self.fleet.devices}
            known |= {e.device.device_id for e in evs
                      if not isinstance(e, (FailEvent, SlowdownEvent))}
            for e in evs:
                if isinstance(e, (FailEvent, SlowdownEvent)) \
                        and e.device_id not in known:
                    raise ValueError(
                        f"{e!r} targets device {e.device_id}, which is "
                        f"neither in the session fleet nor joined by an "
                        f"earlier event")
            sp = self.plan(request=request).schedule
            cap = self.ps.net_bw if ps_contention else None
            rng = np.random.default_rng(self.seed if seed is None else seed)
            engine_cls = None
            if backend == "event-array":
                from repro_torch.sim.engine_array import ArrayTimelineEngine
                engine_cls = ArrayTimelineEngine
            report = eng_mod.simulate_schedule(
                sp, events=evs, ps_egress_bps=cap, ps_ingress_bps=cap,
                jitter_alpha=jitter_alpha, rng=rng,
                heterogeneity_aware=request.heterogeneity_aware,
                trace=trace, engine_cls=engine_cls)
        else:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             "'analytic', 'event', or 'event-array'")
        self.history.append({
            "event": "simulate", "backend": backend,
            "batch": request.batch, "seq": request.seq,
            "n_events": report.n_events, "makespan": report.makespan,
            "n_failures": report.n_failures, "n_joins": report.n_joins})
        return report

    # ----------------------------------------------------------- internals --

    def _dag(self, request: PlanRequest) -> GemmDag:
        if request not in self._dag_cache:
            self._dag_cache[request] = build_dag(
                self.cfg, request.batch, request.seq,
                backward=request.backward, lm_head=request.lm_head,
                attention_scores=request.attention_scores)
        return self._dag_cache[request]

    def _cache(self, heterogeneity_aware: bool) -> Dict[tuple, cm.Plan]:
        return self._plan_caches.setdefault(
            (self.fleet.signature(), heterogeneity_aware), {})

    def _solve_gemm(self, gemm: cm.GEMM,
                    heterogeneity_aware: Optional[bool] = None
                    ) -> Tuple[cm.Plan, bool]:
        het = self.heterogeneity_aware if heterogeneity_aware is None \
            else heterogeneity_aware
        cache = self._cache(het)
        key = plan_shape_key(gemm) + (gemm.count,)
        if key in cache:
            return cache[key], True
        if het:
            plan = solve_level_gemm(gemm, self.fleet.table())
        else:
            plan = solve_level_gemm(gemm, self.fleet.homogenized_table())
            reprice_plan(plan, self.fleet.table())
        cache[key] = plan
        return plan, False


# ------------------------------------------------------------ plan patching --

def _patch_plan(plan: cm.Plan, failed: set,
                survivors: cm.Fleetlike
                ) -> Optional[Tuple[cm.Plan, Optional[churn.RecoveryResult]]]:
    """Carry one cached plan across a churn event: survivors keep their
    rectangles; each orphaned rectangle is re-solved over the survivors and
    grafted back in place.  ``None`` when the plan cannot be patched
    (instance-granular or n-split plans re-solve cold instead)."""
    if plan.instances is not None or plan.n_split != 1:
        return None
    orphans = [a for a in plan.assignments if a.device_id in failed]
    if not orphans:
        return plan, None
    table = cm.DeviceTable.ensure(survivors)
    hit = sorted(failed & {a.device_id for a in plan.assignments})
    event = churn.FailureEvent(gemm=plan.gemm, failed_ids=hit, plan=plan)
    rec = churn.recover(event, table)
    assignments = [a for a in plan.assignments if a.device_id not in failed]
    for rect, patch in rec.patches:
        for pa in patch.assignments:
            assignments.append(cm.Assignment(
                device_id=pa.device_id,
                r0=rect.r0 + pa.r0, r1=rect.r0 + pa.r1,
                c0=rect.c0 + pa.c0, c1=rect.c0 + pa.c1))
    active = {a.device_id for a in assignments}
    new_plan = cm.Plan(
        gemm=plan.gemm, assignments=assignments, makespan=0.0,
        lower_bound=cm.lower_bound(plan.gemm, table),
        excluded=[int(i) for i in table.ids if int(i) not in active])
    new_plan.makespan = cm.plan_makespan(plan.gemm, table, new_plan)
    return new_plan, rec
