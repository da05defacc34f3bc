"""PS-centric training steps (§3.2, §4): real forward+backward+AdamW where
every projection GEMM executes on the fleet and the PS hosts the rest
(port of ``src/repro/train_loop/train_step.py``).

One step is the monolithic ``launch.steps.make_train_step`` math — the same
``models.model.loss_fn`` and ``optim.adam.apply`` — evaluated with the
``FleetGemmSession`` hook open, so each projection GEMM (and its dA/dW
mirrors under autograd) lowers onto the session runtime's
plan→execute→recover machinery.  Under the f32 policy, loss and updated
parameters match the monolithic step to float32 tolerance (the fleet
executors are numerically exact; the numpy backend even accumulates in
float64).  With a checkpoint manager the session saves params and
optimizer state every ``checkpoint_every`` steps, and :meth:`restore`
resumes bit-exactly.

Non-GEMM ops — embeddings, RMSNorm, RoPE, softmax/attention scores (the
``attention_scores="ps"`` convention), cross-entropy, AdamW — run on the PS
between levels, exactly the paper's Table 1/2 split (<1% of step FLOPs).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import spans
from repro_torch.train_loop.fleet_gemm import FleetGemmSession, GemmRecord


@dataclass
class FleetStepReport:
    """Per-step fleet metrics: what actually ran on the devices, next to
    what the event engine predicted for the planned batch."""
    step: int
    loss: float
    grad_norm: float
    lr: float
    n_gemms: int                 # fleet GEMM executions this step
    n_tasks: int                 # sub-GEMM tasks dispatched to devices
    n_recovered: int             # tasks re-executed via churn.recover
    verified: bool               # every Freivalds check passed
    gemm_flops: float            # total fleet GEMM FLOPs this step
    fleet_exec_time: float       # host wall spent inside the executors
    #                              (dataflow dispatch: compute phases only —
    #                              deferred verification is off the path)
    wall_time: float             # total step wall (PS ops + fleet)
    predicted_makespan: float    # engine.price_plan sum over DAG levels —
    #                              the modeled edge-fleet batch GEMM time
    #                              (Eq. 1 barrier walk)
    plan_cache_hit_rate: float   # of executed GEMMs; the pricing pass
    #                              pre-warms the same keys, so <1.0 means
    #                              churn dropped plans mid-step
    n_cold_plan_solves: int = 0  # shapes solved cold by this step's
    #                              pricing pass (0 on steady-state steps)
    failed_ids: Tuple[int, ...] = ()
    n_plans_patched: int = 0     # cache patches when a failure was injected
    records: List[GemmRecord] = field(default_factory=list, repr=False)
    dispatch: str = "level"      # executor dispatch the step ran under
    # engine.price_dataflow critical path through the fleet-lowered DAG —
    # the barrier-free edge prediction (dataflow-dispatch sessions only)
    predicted_makespan_overlap: Optional[float] = None
    fleet_verify_time: float = 0.0   # summed deferred-verify wall (dataflow)

    def log_line(self) -> str:
        s = (f"fleet: {self.n_gemms} gemms {self.n_tasks} tasks "
             f"{self.gemm_flops / 1e9:.2f} GFLOP "
             f"exec {self.fleet_exec_time:.2f}s/{self.wall_time:.2f}s "
             f"predicted {self.predicted_makespan:.1f}s "
             f"cache {self.plan_cache_hit_rate:.0%}")
        if self.n_cold_plan_solves:
            s += f" ({self.n_cold_plan_solves} shapes solved cold)"
        if self.failed_ids:
            s += (f" | failed {list(self.failed_ids)} "
                  f"recovered {self.n_recovered} tasks, "
                  f"{self.n_plans_patched} plans patched")
        return s


@dataclass
class SpannedStepReport(FleetStepReport):
    """The port's :class:`FleetStepReport`: the step's self seconds by
    span and its counts by counter (``core.spans``) -- every GEMM's phases
    and ``fleet.<kind>`` spans, and the PS's ``ps.forward``,
    ``ps.backward``, ``ps.adam`` and ``ps.sync`` with the model's spans
    inside them."""
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)


# DAG GEMM families the pdot hook does NOT lower onto the fleet: per-expert
# MoE einsums (the routed experts — shared experts go through ``swiglu``
# and DO lower), SSM scans, RWKV time/channel mixing, and attention/cross
# score GEMMs (the PS-host score convention) run PS-locally — see
# docs/TRAINING.md "what runs where".
PS_LOCAL_GEMMS = ("moe.gate", "moe.up", "moe.down",
                  "ssm.", "tm.", "cm.",
                  "attn.qk", "attn.av", "cross.qk", "cross.av")


def fleet_lowered(name: str) -> bool:
    """Whether the ``pdot`` hook lowers this DAG GEMM onto the fleet
    (dense/GQA/MLA projections, MoE router + shared experts, cross K/V,
    lm_head)."""
    for suffix in (".dA", ".dW"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    if name.startswith("L") and "." in name:
        name = name.split(".", 1)[1]
    return not name.startswith(PS_LOCAL_GEMMS)


def price_request(rt, request, loss_chunk: Optional[int] = None,
                  stats: Optional[dict] = None,
                  overlap: bool = False) -> float:
    """Predicted edge-fleet GEMM makespan of one batch over the
    **fleet-lowered** DAG GEMMs.  PS-local GEMMs (:data:`PS_LOCAL_GEMMS`)
    are skipped so the prediction covers exactly the work the fleet runs.

    ``overlap=False`` (default) is the Eq. 1 barrier walk: each level
    priced as the max ``engine.price_plan`` over its plans, levels summed.
    ``overlap=True`` prices the same plans through
    ``engine.price_dataflow`` instead — the critical path through the
    ready set, with producer edges taken from ``dag.dependencies()`` and
    transitively closed over the skipped PS-local nodes (a lowered GEMM
    whose direct producer runs on the PS inherits that producer's lowered
    ancestors), which is what dataflow dispatch should converge to.

    ``loss_chunk`` mirrors ``models.model.loss_fn``'s LM-head chunking:
    the ``lm_head`` GEMM and its dA/dW mirrors are priced as the executed
    chunk shapes — ``nc`` *sequential* chunk GEMMs per level — so the
    prediction walks (and warms the plan cache for) exactly the shapes the
    training step runs.  ``stats``, if given, receives ``cold_solves`` —
    the number of shapes this pricing pass solved cold."""
    from dataclasses import replace

    from repro_torch.sim.engine import price_dataflow, price_plan
    dag = rt._dag(request)
    nc = 1
    if loss_chunk and request.seq % loss_chunk == 0 \
            and request.seq >= loss_chunk:
        nc = request.seq // loss_chunk

    def chunked(g):
        reps = 1
        if nc > 1 and g.name.startswith("lm_head"):
            # fwd (m=B·S) and dA chunk on rows; dW = Aᵀ·dO chunks on
            # the contraction dim (one dW GEMM per loss chunk)
            g = replace(g, n=g.n // nc) if g.name.endswith(".dW") \
                else replace(g, m=g.m // nc)
            reps = nc
        plan, cached = rt._solve_gemm(
            g, heterogeneity_aware=request.heterogeneity_aware)
        if stats is not None and not cached:
            stats["cold_solves"] = stats.get("cold_solves", 0) + 1
        return g, plan, reps

    if not overlap:
        total = 0.0
        for level in dag.levels():
            level_time = 0.0
            for g in level:
                if not fleet_lowered(g.name):
                    continue
                g, plan, reps = chunked(g)
                level_time = max(level_time, reps * price_plan(
                    g, plan, rt.fleet.devices))
            total += level_time
        return total

    deps_full = dag.dependencies()
    lowered_pos: Dict[int, int] = {}
    eff: Dict[int, List[int]] = {}      # node -> lowered ancestor closure
    nodes: List[tuple] = []
    node_deps: List[List[int]] = []
    for grp in dag.level_order():       # closure needs level order
        for i in grp:
            g = dag.gemms[i]
            ds = sorted({d for j in deps_full[i]
                         for d in ([j] if j in lowered_pos else eff[j])})
            if not fleet_lowered(g.name):
                eff[i] = ds             # pass producers through the PS op
                continue
            eff[i] = [i]
            g, plan, reps = chunked(g)
            lowered_pos[i] = len(nodes)
            nodes.append((g, plan, reps))
            node_deps.append([lowered_pos[j] for j in ds])
    return float(price_dataflow(nodes, list(rt.fleet.devices),
                                deps=node_deps))


def price_trace_emulated(records: Sequence[GemmRecord], *,
                         gflops: float, overhead_s: float) -> float:
    """Engine price of an executed GEMM trace on the **emulation
    substrate**: the host machine that actually ran the fleet executors,
    modeled as one device executing the trace as a sequential chain (the
    autodiff order the train loop dispatches in), each GEMM costing
    ``overhead_s + flops / gflops``.

    This is the prediction that is commensurable with the *measured*
    ``fleet_exec_time`` — the edge-fleet prices (``price_request``) are in
    modeled edge-seconds, a different clock from host wall-seconds, so
    the bench's predicted-vs-measured convergence check calibrates
    ``(gflops, overhead_s)`` from a warm-up step's records (see
    ``benchmarks.core_bench.calibrate_emulation``) and prices later steps
    through the same TimelineEngine that prices the edge fleet."""
    from repro_torch.core import cost_model as cm
    from repro_torch.sim.engine import TimelineEngine, WorkItem
    if not records:
        return 0.0
    host = cm.Device(flops=max(gflops, 1e-9) * 1e9, dl_bw=1e30,
                     ul_bw=1e30, dl_lat=0.0, ul_lat=0.0, device_id=0)
    eng = TimelineEngine([host])
    eng.add_chain(0, [WorkItem(dl_bytes=0.0, flops=r.flops, ul_bytes=0.0,
                               setup=max(overhead_s, 0.0))
                      for r in records])
    return float(eng.run().makespan)


class FleetTrainSession:
    """A training run on the fleet: owns the GEMM session (so plan caches
    stay warm across steps), the optimizer config, and the step counter.

    Built by :meth:`repro_torch.api.TorchCleaveRuntime.train_session` (or
    directly); :meth:`step` is the PS-centric analog of the monolithic
    step.  ``checkpoint`` (a directory path or a
    :class:`~repro_torch.checkpointing.checkpoint.CheckpointManager`)
    enables periodic PS-side snapshots every ``checkpoint_every`` steps."""

    def __init__(self, runtime, cfg=None, opt_cfg=None, *,
                 backend: str = "torch", kernel: str = "auto",
                 dtype_policy=None, verify: bool = True,
                 q_chunk: int = 64, k_chunk: int = 64,
                 loss_chunk: int = 64, dispatch: str = "level",
                 checkpoint=None, checkpoint_every: int = 100):
        from repro_torch.optim import adam
        self.rt = runtime
        self.cfg = cfg if cfg is not None else runtime.cfg
        self.opt_cfg = opt_cfg or adam.AdamConfig()
        self.dispatch = dispatch
        # periodic PS-side checkpoints (§6): a directory path builds a
        # CheckpointManager(every=checkpoint_every); a manager passes
        # through.  AdamState.step is saved with the moments, so restore()
        # resumes with the lr schedule intact
        if isinstance(checkpoint, str):
            from repro_torch.checkpointing.checkpoint import \
                CheckpointManager
            checkpoint = CheckpointManager(checkpoint,
                                           every=checkpoint_every)
        self.checkpoint = checkpoint
        self.gemms = FleetGemmSession(runtime, backend=backend,
                                      kernel=kernel,
                                      dtype_policy=dtype_policy,
                                      verify=verify, dispatch=dispatch)
        self.chunks = dict(q_chunk=q_chunk, k_chunk=k_chunk,
                           loss_chunk=loss_chunk)
        self.step_index = 0
        self.reports: List[FleetStepReport] = []
        self._priced: Dict[tuple, float] = {}
        self._last_cold_solves = 0
        cfg = self.cfg
        if cfg.moe or cfg.ssm or cfg.rwkv or cfg.hybrid_parallel:
            import warnings
            warnings.warn(
                f"arch {cfg.name!r}: routed-expert / recurrent GEMMs run "
                "PS-locally — the dense projection GEMMs, MoE router, and "
                "shared experts lower onto the fleet; predicted_makespan "
                "covers the fleet-lowered set (docs/TRAINING.md)",
                stacklevel=3)

    # ---------------------------------------------------------------- step --

    def step(self, params, opt_state, batch, *,
             fail_ids: Sequence[int] = (), fail_at_gemm: int = 0,
             donate: bool = False):
        """One fleet-executed train step.  Returns
        ``(params, opt_state, metrics)`` like the monolithic step; metrics
        additionally carries ``metrics["fleet"]`` (a
        :class:`FleetStepReport`).  ``params`` is a nested dict of tensors
        on the runtime's device and ``batch`` holds ``tokens``/``labels``
        tensors there; neither is modified unless ``donate``, which
        updates params and the optimizer moments in place
        (``adam.apply(donate=True)``, the reference's
        ``donate_argnums=(0, 1)``): the returned trees then hold the
        caller's tensors.

        ``fail_ids`` injects a mid-step device failure at the
        ``fail_at_gemm``-th fleet GEMM (counted across the forward and the
        backward): the in-flight GEMM recovers through ``churn.recover``
        (exact output) and the devices are then evicted, so the remainder
        of the step — and all later steps — plan over the survivors."""
        from repro_torch import ieee_f32
        from repro_torch.models import model as M
        from repro_torch.optim import adam

        if self.rt.device.type == "cuda":
            ieee_f32()
        predicted, predicted_overlap = self._predict(batch)
        with spans.collect() as tally:
            t0 = time.perf_counter()
            try:
                with self.gemms.open() as fleet:
                    if fail_ids:
                        fleet.arm_failure(fail_ids, at_gemm=fail_at_gemm)
                    # no recompute: the fleet GEMMs run once each, as the
                    # reference's unrolled scan_layers=False path
                    (loss, metrics), grads = M.value_and_grad(
                        self.cfg, params, batch, remat=False, **self.chunks)
                    with spans.span("ps.adam"):
                        params2, opt2, opt_metrics = adam.apply(
                            params, grads, opt_state, self.opt_cfg,
                            donate=donate)
                    del grads
            finally:
                # drain unconditionally: an exception mid-step must not
                # leak a partial step's records / armed failure / GEMM
                # counter into the next step of this (cached, reused)
                # session
                records, churn_reports = self.gemms.drain()
            with spans.span("ps.sync"):
                if self.rt.device.type == "cuda":
                    torch.cuda.synchronize(self.rt.device)
            wall = time.perf_counter() - t0
        # report what actually happened, not what was requested: an armed
        # failure whose at_gemm index was never reached fired nothing
        fired_ids = tuple(sorted({int(i) for r in records
                                  for i in r.failed_ids}))
        if fail_ids and not fired_ids:
            raise RuntimeError(
                f"fail_at_gemm={fail_at_gemm} exceeds the step's "
                f"{len(records)} fleet GEMMs: the requested failure of "
                f"devices {sorted(int(i) for i in fail_ids)} never fired")
        n_patched = sum(c.n_plans_patched for c in churn_reports)

        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        report = SpannedStepReport(
            step=self.step_index, loss=float(loss),
            grad_norm=float(metrics["grad_norm"]),
            lr=float(metrics["lr"]),
            n_gemms=len(records),
            n_tasks=sum(r.n_tasks for r in records),
            n_recovered=sum(r.n_recovered for r in records),
            verified=all(r.verified for r in records),
            gemm_flops=sum(r.flops for r in records),
            fleet_exec_time=sum(r.exec_time for r in records),
            wall_time=wall, predicted_makespan=predicted,
            plan_cache_hit_rate=(sum(r.plan_cached for r in records)
                                 / max(len(records), 1)),
            n_cold_plan_solves=self._last_cold_solves,
            failed_ids=fired_ids,
            n_plans_patched=n_patched, records=records,
            dispatch=self.dispatch,
            predicted_makespan_overlap=predicted_overlap,
            fleet_verify_time=sum(r.verify_time for r in records),
            spans=tally.spans, counters=tally.counters)
        # the caller's report carries the full per-GEMM trace; the
        # session-retained copy drops it so a long run doesn't grow
        # memory by ~90 records/step
        import dataclasses
        self.reports.append(dataclasses.replace(report, records=[]))
        metrics["fleet"] = report
        self.rt.history.append({
            "event": "train_step", "step": self.step_index,
            "loss": report.loss, "backend": self.gemms.backend,
            "n_gemms": report.n_gemms, "n_tasks": report.n_tasks,
            "n_recovered": report.n_recovered,
            "verified": report.verified,
            "predicted_makespan": report.predicted_makespan,
            "failed_ids": list(report.failed_ids)})
        self.step_index += 1
        if self.checkpoint is not None:
            # the save copies every leaf to the host before it returns:
            # with donate the next step updates these tensors in place
            self.checkpoint.maybe_save(
                self.step_index, {"params": params2, "opt_state": opt2},
                metadata={"loss": float(loss)})
        return params2, opt2, metrics

    # ----------------------------------------------------------- restore --

    def restore(self, params_like, opt_state_like):
        """Resume from the newest checkpoint in the session's manager:
        returns ``(params, opt_state, step)`` with ``step_index``
        fast-forwarded so the resumed trajectory -- losses, lr schedule,
        checkpoint cadence -- bit-matches the uninterrupted run.  The
        restored leaves take the types and devices of the ``_like`` trees.
        With no snapshot on disk the ``_like`` trees pass through at step
        0."""
        if self.checkpoint is None:
            raise RuntimeError("session has no checkpoint manager")
        step, tree = self.checkpoint.restore_latest(
            {"params": params_like, "opt_state": opt_state_like})
        if step is None:
            return params_like, opt_state_like, 0
        self.step_index = step
        return tree["params"], tree["opt_state"], step

    # ----------------------------------------------------------- internals --

    def _predict(self, batch) -> Tuple[float, Optional[float]]:
        """Engine-priced batch GEMM makespan for this batch shape —
        ``(Eq. 1 barrier price, price_dataflow overlap price or None)`` —
        cached per (shape, fleet signature) so churn re-prices but
        steady-state steps don't.  The overlap price is only computed for
        dataflow-dispatch sessions (same plans, different composition)."""
        from repro_torch.api.runtime import PlanRequest
        b, s = (int(n) for n in batch["tokens"].shape)
        request = PlanRequest(
            batch=b, seq=s, attention_scores=self.rt.attention_scores,
            heterogeneity_aware=self.rt.heterogeneity_aware)
        key = (request, self.rt.fleet.signature())
        if key not in self._priced:
            stats: dict = {}
            barrier = price_request(
                self.rt, request, loss_chunk=self.chunks["loss_chunk"],
                stats=stats)
            over = None
            if self.dispatch == "dataflow":
                over = price_request(
                    self.rt, request, loss_chunk=self.chunks["loss_chunk"],
                    overlap=True)
            self._priced[key] = (barrier, over)
            self._last_cold_solves = stats.get("cold_solves", 0)
        else:
            self._last_cold_solves = 0
        return self._priced[key]


def make_fleet_train_step(runtime, cfg=None, opt_cfg=None, **opts):
    """Factory mirroring ``launch.steps.make_train_step``: returns
    ``step(params, opt_state, batch, *, fail_ids=(), fail_at_gemm=0)``
    bound to a fresh :class:`FleetTrainSession` (exposed as
    ``step.session``)."""
    session = FleetTrainSession(runtime, cfg=cfg, opt_cfg=opt_cfg, **opts)

    def train_step(params, opt_state, batch, *, fail_ids=(),
                   fail_at_gemm: int = 0):
        return session.step(params, opt_state, batch, fail_ids=fail_ids,
                            fail_at_gemm=fail_at_gemm)

    train_step.session = session
    return train_step
