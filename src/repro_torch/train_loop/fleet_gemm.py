"""Differentiable fleet GEMM: the bridge between PyTorch autograd on the PS
and the CLEAVE executors on the (simulated) device fleet (port of
``src/repro/train_loop/fleet_gemm.py``).

:meth:`FleetGemmSession.open` installs the ``models.layers.pdot`` hook;
inside it every ``x @ w`` is :class:`_FleetDot`, a
``torch.autograd.Function`` whose primal *and* both cotangents run on the
fleet:

* forward:   C  = A·B          (kind ``fwd``)
* backward:  dA = dO·Bᵀ        (kind ``dA``, ``gemm_dag``'s ``.dA`` mirror)
*            dW = Aᵀ·dO        (kind ``dW``, the ``.dW`` mirror)

Each goes through :meth:`TorchCleaveRuntime.execute_step` -- plan cache,
failure recovery (``churn.recover``), Freivalds verification and, for
``backend="torch"``, the band GEMM kernel with the session ``PadCache``.
As in the reference's custom VJP, both backward GEMMs run for every fleet
dot, so a training step runs three GEMMs per forward GEMM, and an armed
failure counts GEMMs across the forward and the backward.  PyTorch runs
eagerly, so the executor is called directly on tensors (no host
callback); on the card autograd may run the backward on its own device
thread while the caller waits, which the session's sequential state
allows.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.train_loop import hook as _hook

_SESSION: Optional["FleetGemmSession"] = None


@dataclass
class GemmRecord:
    """One fleet-executed GEMM inside a step."""
    m: int
    n: int
    q: int
    kind: str                   # 'fwd' | 'dA' | 'dW'
    exec_time: float            # host wall-clock of the fleet execution
    predicted_makespan: float   # engine.price_plan of the executed plan
    n_tasks: int
    n_recovered: int
    verified: bool
    plan_cached: bool
    failed_ids: Tuple[int, ...] = ()
    b: int = 4                  # element width the plan was solved for
    verify_time: float = 0.0    # dataflow dispatch: deferred check wall
    # self seconds of the GEMM's phase spans and its counters
    # (core.spans), the deferred check's joined by drain(); the
    # ``fleet.<kind>`` span's own self time is the step's alone
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.n * self.q


@dataclass
class _ArmedFailure:
    """A scheduled mid-step device failure, injected into the
    ``at_gemm``-th fleet execution, then (optionally) made permanent via
    ``on_failure``."""
    fail_ids: Tuple[int, ...]
    at_gemm: int
    evict: bool = True
    fired: bool = False


class FleetGemmSession:
    """Owns the per-step GEMM trace and the executor options; reused
    across steps so plan caches stay warm (see the reference class)."""

    def __init__(self, runtime, *, backend: str = "torch",
                 kernel: str = "auto", dtype_policy=None,
                 verify: bool = True, dispatch: str = "level"):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown fleet backend {backend!r}; "
                             "expected 'numpy' or 'torch'")
        if dispatch not in ("level", "dataflow"):
            raise ValueError(f"unknown dispatch {dispatch!r}; "
                             "expected 'level' or 'dataflow'")
        self.rt = runtime
        self.backend = backend
        self.kernel = kernel
        self.dtype_policy = dtype_policy
        self.verify = verify
        # 'dataflow': each GEMM's Freivalds check runs on a background
        # worker, overlapping the next GEMM; drain() joins them
        self.dispatch = dispatch
        self.records: List[GemmRecord] = []
        self.churn_reports: list = []
        self._armed: Optional[_ArmedFailure] = None
        self._gemm_index = 0
        self._verify_pool = None
        self._pending: List[tuple] = []     # (record, StepReport, future)
        self._price_memo: dict = {}
        self._trace_price_memo: dict = {}

    # ------------------------------------------------------------- control --

    @contextlib.contextmanager
    def open(self):
        """Make this session the process-global GEMM executor and install
        the ``pdot`` hook for the extent of the block."""
        global _SESSION
        if _SESSION is not None:
            raise RuntimeError("a FleetGemmSession is already open")
        _SESSION = self
        try:
            with _hook.use_hook(self.dot):
                yield self
        finally:
            _SESSION = None

    def arm_failure(self, fail_ids: Sequence[int], *, at_gemm: int = 0,
                    evict: bool = True) -> None:
        """Schedule ``fail_ids`` to vanish during the ``at_gemm``-th fleet
        GEMM of the upcoming step; with ``evict=True`` the devices are then
        removed for good (``on_failure``)."""
        ids = tuple(int(i) for i in fail_ids)
        known = set(self.rt.fleet.ids())
        missing = [i for i in ids if i not in known]
        if missing:
            raise ValueError(f"cannot fail unknown devices {missing}")
        self._armed = _ArmedFailure(fail_ids=ids, at_gemm=int(at_gemm),
                                    evict=evict)

    def drain(self) -> Tuple[List[GemmRecord], list]:
        """Harvest (and clear) the step's GEMM trace and churn reports,
        joining deferred verifications first (their spans and counts go
        to the GEMM's record and to the current tally); disarms a pending
        failure."""
        for record, step, fut in self._pending:
            record.verify_time, tally = fut.result()
            record.verified = step.verified
            record.n_recovered = step.n_recovered
            spans.fold(record.spans, record.counters, tally)
            spans.merge(tally)
        self._pending = []
        out, self.records = self.records, []
        churn, self.churn_reports = self.churn_reports, []
        self._gemm_index = 0
        self._armed = None
        return out, churn

    # ------------------------------------------------------------ GEMM ops --

    def dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The ``pdot`` hook: ``x @ w`` with leading dims flattened to the
        GEMM's ``m``; the result has ``x``'s dtype, as in the reference.
        Differentiable: both cotangent GEMMs also run on the fleet."""
        lead = tuple(x.shape[:-1])
        out = _FleetDot.apply(self, x.reshape(-1, x.shape[-1]), w)
        return out.reshape(lead + (w.shape[-1],))

    def _price(self, gemm, plan) -> float:
        from repro_torch.sim.engine import price_plan
        with spans.span("fleet.plan"):
            key = (gemm.m, gemm.n, gemm.q, gemm.b,
                   self.rt.fleet.signature())
            if key not in self._price_memo:
                self._price_memo[key] = price_plan(gemm, plan,
                                                   self.rt.fleet.devices)
            return self._price_memo[key]

    def price_step(self, records: Sequence[GemmRecord]) -> float:
        """Engine price of one step's executed GEMM trace: the barrier sum
        of per-plan makespans (level), or the ``price_dataflow`` critical
        path of the GEMM chain (dataflow), memoized per trace and fleet."""
        if self.dispatch != "dataflow":
            return float(sum(r.predicted_makespan for r in records))
        if not records:
            return 0.0
        key = (tuple((r.m, r.n, r.q, r.b) for r in records),
               self.rt.fleet.signature())
        hit = self._trace_price_memo.get(key)
        if hit is None:
            from repro_torch.core import cost_model as cm
            from repro_torch.sim.engine import price_dataflow
            nodes = []
            for r in records:
                g = cm.GEMM(m=r.m, n=r.n, q=r.q, b=r.b)
                plan, _ = self.rt._solve_gemm(g)
                nodes.append((g, plan))
            deps = [[] if i == 0 else [i - 1] for i in range(len(nodes))]
            hit = float(price_dataflow(nodes, list(self.rt.fleet.devices),
                                       deps=deps))
            self._trace_price_memo[key] = hit
        return hit

    def _execute(self, a: torch.Tensor, b: torch.Tensor,
                 kind: str) -> torch.Tensor:
        # a span per kind ("fleet.fwd", "fleet.dA", "fleet.dW") around the
        # GEMM's phase spans; the record holds the GEMM's tally, which the
        # phases fill until the block ends
        with spans.span(f"fleet.{kind}"), spans.collect() as tally:
            fail_ids: Tuple[int, ...] = ()
            armed = self._armed
            if armed is not None and not armed.fired \
                    and self._gemm_index >= armed.at_gemm:
                fail_ids = armed.fail_ids
                armed.fired = True
            self._gemm_index += 1

            from repro_torch.core import cost_model as cm
            # the real element width keys the plan, as in the reference
            gemm = cm.GEMM(m=a.shape[0], n=a.shape[1], q=b.shape[1],
                           b=int(a.element_size()))
            if self.dispatch == "dataflow":
                rep, fin = self.rt.execute_step_deferred(
                    a, b, gemm=gemm, fail_ids=fail_ids, verify=self.verify,
                    backend=self.backend, dtype_policy=self.dtype_policy,
                    kernel=self.kernel)

                def _timed_verify():
                    # on the worker's own chain: drain() joins its tally
                    with spans.collect(own=True) as vtally:
                        t0 = time.perf_counter()
                        fin()
                        return time.perf_counter() - t0, vtally

                if self._verify_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._verify_pool = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="fleet-verify")
                self._pending.append(
                    (None, rep, self._verify_pool.submit(_timed_verify)))
            else:
                rep = self.rt.execute_step(
                    a, b, gemm=gemm, fail_ids=fail_ids, verify=self.verify,
                    backend=self.backend, dtype_policy=self.dtype_policy,
                    kernel=self.kernel)
            record = GemmRecord(
                m=rep.gemm.m, n=rep.gemm.n, q=rep.gemm.q, kind=kind,
                exec_time=rep.exec_time,
                predicted_makespan=self._price(rep.gemm, rep.plan),
                n_tasks=rep.n_tasks, n_recovered=rep.n_recovered,
                verified=rep.verified, plan_cached=rep.plan_cached,
                failed_ids=fail_ids, b=gemm.b, spans=tally.spans,
                counters=tally.counters)
            if self.dispatch == "dataflow":
                self._pending[-1] = (record, rep, self._pending[-1][2])
            self.records.append(record)
            if fail_ids and armed is not None and armed.evict:
                self.churn_reports.append(self.rt.on_failure(fail_ids))
            with spans.span("fleet.scatter"):
                out = rep.output
                if isinstance(out, np.ndarray):
                    out = torch.from_numpy(np.ascontiguousarray(out))
                return out.to(device=a.device, dtype=a.dtype)


# ------------------------------------------------------ autograd fleet dot

class _FleetDot(torch.autograd.Function):
    """``a @ w`` on the fleet, with dA = dO·wᵀ and dW = aᵀ·dO on the fleet
    too (the reference's ``fleet_dot`` custom VJP).  Each result has its
    left operand's dtype (``_execute``), cast to the primal's dtype."""

    @staticmethod
    def forward(ctx, sess, a, w):
        ctx.sess = sess
        ctx.save_for_backward(a, w)
        return sess._execute(a, w, "fwd")

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = ctx.sess._execute(g, w.T, "dA")       # dA = dO · Bᵀ
        dw = ctx.sess._execute(a.T, g, "dW")       # dW = Aᵀ · dO
        return None, da.to(a.dtype), dw.to(w.dtype)
