"""Multi-PS sharded training: K parameter-server islands under an outer
DiLoCo loop (§6 scale-out x §2.4 hybrid).  Port of
``src/repro/train_loop/multi_ps.py``.

One :class:`MultiPSTrainSession` runs K islands, each a full PS-centric
:class:`~repro_torch.train_loop.train_step.FleetTrainSession` over its own
planner-assigned device subfleet (``api.ShardedFleet``: per-island
runtimes on the caller's device, so plan caches never mix across PS
shards).  Each island takes H local AdamW inner steps on its own data
shard; at every round boundary the PSs reduce the islands' drifted
parameters and apply Nesterov momentum to the pseudo-gradient
(``optim.diloco.outer_step_sharded``).  K=1/H=1 bypasses the outer loop
and is bit-identical to the single-PS session.

Each island owns its params and moments.  The reference shares one tree
among the islands after ``init`` and after each round, which immutable
JAX arrays allow; here an island's in-place AdamW (``donate=True``) would
write into the others' replicas, so islands 1..K-1 hold copies (K=1 keeps
the caller's tensors, as the single-PS session does).  With ``donate``
the outer round also runs in place: the anchor, the velocity and every
island's replica are overwritten, and no island tree is copied.

Churn happens at two granularities: ``fail_ids`` inside an island exercises
the mid-GEMM ``churn.recover`` path; ``fail_ps`` kills a whole parameter
server mid-round -- the island is evicted, its inner progress since the
last boundary is lost, and its devices join the surviving islands with
their ids kept (``ShardedFleet.without_ps`` ->
``TorchCleaveRuntime.on_join(keep_id=True)``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.spans import span
from repro_torch.train_loop.train_step import FleetStepReport, FleetTrainSession


@dataclass(frozen=True)
class MultiPSState:
    """Functional training state across the islands: per-island parameter /
    optimizer replicas (equal right after a sync, drifted between), the
    sharded outer state (None when the session bypasses the outer loop),
    and the inner-step / round clocks."""
    island_params: tuple
    island_opt: tuple
    outer: Optional[object]          # diloco.OuterState, sharded across PSs
    inner_step: int = 0
    round: int = 0

    @property
    def n_islands(self) -> int:
        return len(self.island_params)

    @property
    def params(self):
        """Island 0's replica — the authoritative view right after a sync
        (all replicas are equal there) and the single-PS view at K=1."""
        return self.island_params[0]

    @property
    def opt_state(self):
        return self.island_opt[0]


@dataclass
class MultiPSStepReport:
    """One inner step across every island, plus the outer boundary if this
    step landed on one."""
    step: int                        # completed inner steps (post-step)
    round: int                       # completed outer rounds
    n_islands: int
    synced: bool                     # did this step end an outer round?
    loss: float                      # mean of the island losses
    island_loss: Tuple[float, ...]
    island_reports: List[FleetStepReport] = field(repr=False,
                                                  default_factory=list)
    cross_ps_sync_bytes: float = 0.0     # wire bytes of the boundary sync
    predicted_sync_time: float = 0.0     # engine.price_outer_sync (edge s)
    predicted_makespan: float = 0.0      # max island makespan (+ sync) —
    #                                      islands run concurrently on the
    #                                      modeled edge fleet
    fleet_exec_time: float = 0.0         # summed island executor wall (the
    #                                      host emulates islands serially)
    wall_time: float = 0.0
    evicted_ps: Optional[int] = None     # PS island lost this step
    n_devices_reassigned: int = 0

    def log_line(self) -> str:
        s = (f"multi_ps[{self.n_islands}]: step {self.step} "
             f"round {self.round} loss {self.loss:.4f} "
             f"exec {self.fleet_exec_time:.2f}s "
             f"predicted {self.predicted_makespan:.1f}s")
        if self.synced:
            s += (f" | synced {self.cross_ps_sync_bytes / 1e6:.1f} MB "
                  f"across PSs ({self.predicted_sync_time * 1e3:.1f} ms)")
        if self.evicted_ps is not None:
            s += (f" | PS {self.evicted_ps} failed: island evicted, "
                  f"{self.n_devices_reassigned} devices reassigned")
        return s


class _Island:
    """One PS shard at runtime: its group, its runtime, its train session."""
    __slots__ = ("group", "rt", "session")

    def __init__(self, group, rt, session):
        self.group = group
        self.rt = rt
        self.session = session


def _own(tree):
    """A copy of a tree of tensors (nested dicts, tuples such as
    ``AdamState``) that shares no storage with it."""
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_own(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class MultiPSTrainSession:
    """K-island training session (built by
    ``TorchCleaveRuntime.train_session(n_ps=...)``).

    ``step(state, batch)`` runs one inner step on every island -- ``batch``
    is either one batch dict (replicated; the parity path) or a sequence of
    K per-island batches (data parallelism) -- and applies the sharded
    outer update when ``state.inner_step`` crosses a
    ``diloco.inner_steps`` boundary.  Returns ``(new_state, metrics)`` with
    ``metrics["multi_ps"]`` a :class:`MultiPSStepReport`."""

    def __init__(self, runtime, n_ps: Optional[int] = None, cfg=None,
                 opt_cfg=None, *, diloco=None, sharded=None,
                 backend: str = "torch", kernel: str = "auto",
                 dtype_policy=None, verify: bool = True,
                 q_chunk: int = 64, k_chunk: int = 64,
                 loss_chunk: int = 64, dispatch: str = "level",
                 checkpoint=None, checkpoint_every: int = 100,
                 backbone_bps: Optional[float] = None):
        from repro_torch.api.ps_group import ShardedFleet
        from repro_torch.optim.diloco import DiLoCoConfig
        self.rt = runtime
        self.cfg = cfg if cfg is not None else runtime.cfg
        self.diloco = diloco or DiLoCoConfig()
        self.backbone_bps = backbone_bps
        self.sharded = sharded if sharded is not None else \
            ShardedFleet.partition(runtime.fleet, n_ps, ps=runtime.ps)
        opts = dict(opt_cfg=opt_cfg, backend=backend, kernel=kernel,
                    dtype_policy=dtype_policy, verify=verify,
                    q_chunk=q_chunk, k_chunk=k_chunk,
                    loss_chunk=loss_chunk, dispatch=dispatch)
        self.islands: List[_Island] = []
        for g in self.sharded:
            rt = g.runtime_for(runtime)
            self.islands.append(_Island(
                g, rt, FleetTrainSession(rt, cfg=self.cfg, **opts)))
        if isinstance(checkpoint, str):
            from repro_torch.checkpointing.checkpoint import \
                CheckpointManager
            checkpoint = CheckpointManager(checkpoint,
                                           every=checkpoint_every)
        self.checkpoint = checkpoint
        self.reports: List[MultiPSStepReport] = []

    # ------------------------------------------------------------- queries --

    @property
    def n_islands(self) -> int:
        return len(self.islands)

    @property
    def H(self) -> int:
        return int(self.diloco.inner_steps)

    # --------------------------------------------------------------- state --

    def init(self, params, opt_state) -> MultiPSState:
        """Hand the initial replica to every island and anchor the outer
        state (K=1 runs anchor-free: the single island's parameters are
        authoritative and the outer loop is bypassed).  Island 0 takes the
        caller's trees, islands 1..K-1 copies; the anchor is a copy."""
        from repro_torch.optim import diloco
        k = self.n_islands
        outer = diloco.outer_init(params) if k > 1 else None
        return MultiPSState(
            island_params=(params,) + tuple(_own(params)
                                            for _ in range(k - 1)),
            island_opt=(opt_state,) + tuple(_own(opt_state)
                                            for _ in range(k - 1)),
            outer=outer)

    # ---------------------------------------------------------------- step --

    def step(self, state: MultiPSState, batch, *,
             fail_ids: Sequence[int] = (), fail_island: int = 0,
             fail_at_gemm: int = 0,
             fail_ps: Optional[int] = None, donate: bool = False):
        """One inner step on every island (one after the other on the
        card -- the GEMM hook is process-global -- but concurrently on the
        modeled edge fleet: ``predicted_makespan`` is the max island
        time).  ``fail_ids``/``fail_island``/``fail_at_gemm`` inject a
        mid-GEMM device failure inside one island; ``fail_ps`` kills that
        parameter server outright.  ``donate`` updates every island's
        params and moments in place (``FleetTrainSession.step``'s
        ``donate``), and the outer state and the replicas at a round
        boundary; the returned state then holds the given tensors."""
        t0 = time.perf_counter()
        evicted_ps = None
        n_reassigned = 0
        batches = list(batch) if isinstance(batch, (list, tuple)) else None
        if fail_ps is not None:
            # callers shard batches against the islands alive at the
            # step's start; the dead island's shard is dropped with it
            idx = next((i for i, isl in enumerate(self.islands)
                        if isl.group.ps_id == int(fail_ps)), None)
            state, n_reassigned = self._evict_ps(state, int(fail_ps))
            evicted_ps = int(fail_ps)
            if batches is not None and len(batches) == self.n_islands + 1:
                del batches[idx]
        k = self.n_islands
        if batches is None:
            batches = [batch] * k
        if len(batches) != k:
            raise ValueError(
                f"got {len(batches)} per-island batches for {k} islands")
        new_params: list = []
        new_opt: list = []
        island_reports: List[FleetStepReport] = []
        losses: List[float] = []
        for i, isl in enumerate(self.islands):
            kw = {}
            if fail_ids and i == fail_island:
                kw = dict(fail_ids=fail_ids, fail_at_gemm=fail_at_gemm)
            p2, o2, metrics = isl.session.step(
                state.island_params[i], state.island_opt[i], batches[i],
                donate=donate, **kw)
            new_params.append(p2)
            new_opt.append(o2)
            island_reports.append(metrics["fleet"])
            losses.append(float(metrics["loss"]))
        inner = state.inner_step + 1
        rnd = state.round
        outer = state.outer
        synced = False
        sync_bytes = sync_time = 0.0
        if k > 1 and outer is not None and inner % self.H == 0:
            from repro_torch.optim import diloco
            from repro_torch.sim.engine import price_outer_sync
            part = diloco.partition_params(new_params[0], k)
            with span("ps.outer_round"):
                merged, outer, traffic = diloco.outer_step_sharded(
                    outer, new_params, part, self.diloco, donate=donate)
            if not donate:
                # every island owns its replica of the merged params
                new_params = [merged] + [_own(merged)
                                         for _ in range(k - 1)]
            # inner Adam moments stay per-island (the DiLoCo convention:
            # only parameters sync; moments re-adapt from local data)
            sync_bytes = traffic["total_bytes"]
            sync_time = price_outer_sync(
                part.shard_bytes, ps_net_bps=self.rt.ps.net_bw,
                backbone_bps=self.backbone_bps)
            synced = True
            rnd += 1
        new_state = MultiPSState(
            island_params=tuple(new_params), island_opt=tuple(new_opt),
            outer=outer, inner_step=inner, round=rnd)
        report = MultiPSStepReport(
            step=inner, round=rnd, n_islands=k, synced=synced,
            loss=float(np.mean(losses)), island_loss=tuple(losses),
            island_reports=island_reports,
            cross_ps_sync_bytes=sync_bytes,
            predicted_sync_time=sync_time,
            predicted_makespan=max(r.predicted_makespan
                                   for r in island_reports) + sync_time,
            fleet_exec_time=sum(r.fleet_exec_time for r in island_reports),
            wall_time=time.perf_counter() - t0,
            evicted_ps=evicted_ps, n_devices_reassigned=n_reassigned)
        self.reports.append(report)
        if self.checkpoint is not None:
            # the save copies every leaf to the host before it returns, so
            # a later in-place step cannot reach the file
            self.checkpoint.maybe_save(inner, self._ckpt_tree(new_state),
                                       metadata={"round": rnd,
                                                 "n_islands": k})
        metrics = {"loss": report.loss, "multi_ps": report,
                   "islands": island_reports}
        return new_state, metrics

    # --------------------------------------------------------- checkpoints --

    def _ckpt_tree(self, state: MultiPSState) -> dict:
        tree = {"island_params": list(state.island_params),
                "island_opt": list(state.island_opt)}
        if state.outer is not None:
            tree["outer"] = state.outer
        return tree

    def restore(self, state_like: MultiPSState):
        """Resume from the newest checkpoint (island count must match the
        snapshot's).  Returns ``(state, inner_step)``; the ``_like`` state
        passes through at step 0 when no snapshot exists."""
        if self.checkpoint is None:
            raise RuntimeError("session has no checkpoint manager")
        step, tree = self.checkpoint.restore_latest(
            self._ckpt_tree(state_like))
        if step is None:
            return state_like, 0
        from repro_torch.checkpointing.checkpoint import load_metadata
        meta = load_metadata(self.checkpoint._path(step)) or {}
        return MultiPSState(
            island_params=tuple(tree["island_params"]),
            island_opt=tuple(tree["island_opt"]),
            outer=tree.get("outer"),
            inner_step=step, round=int(meta.get("round", 0))), step

    # --------------------------------------------------------------- churn --

    def _evict_ps(self, state: MultiPSState,
                  ps_id: int) -> Tuple[MultiPSState, int]:
        """A parameter server dies mid-round: evict its island, drop its
        replica (inner progress since the last boundary is lost -- the
        outer loop absorbs it), and fold its devices into the survivors'
        runtimes with their ids preserved, so the survivors' next plans
        re-solve over the enlarged subfleets."""
        idx = next((i for i, isl in enumerate(self.islands)
                    if isl.group.ps_id == ps_id), None)
        if idx is None:
            raise KeyError(f"no PS island with ps_id={ps_id}")
        new_sharded, placements = self.sharded.without_ps(ps_id)
        survivors = {isl.group.ps_id: isl for i, isl in
                     enumerate(self.islands) if i != idx}
        for tgt_ps_id, device in placements:
            survivors[tgt_ps_id].rt.on_join(device, keep_id=True)
        # rebind the surviving islands to their refreshed groups (the live
        # runtimes already carry the enlarged fleets)
        for g in new_sharded:
            isl = survivors[g.ps_id]
            g._runtime = isl.rt
            isl.group = g
        self.sharded = new_sharded
        self.islands = [survivors[g.ps_id] for g in new_sharded]
        return MultiPSState(
            island_params=tuple(p for i, p in
                                enumerate(state.island_params) if i != idx),
            island_opt=tuple(o for i, o in
                             enumerate(state.island_opt) if i != idx),
            outer=state.outer, inner_step=state.inner_step,
            round=state.round), len(placements)
