"""Schedule executor: numerically runs a CLEAVE plan's sub-GEMM tasks and
proves the scheduled computation equals the monolithic product (§3.2's
exact-semantics claim), including under injected mid-level device failures
(recovery path) and Freivalds verification of each returned block (§6).

This is the CPU stand-in for the device fleet; on TPU the same tile
decomposition is executed by the Pallas ``block_gemm`` kernel grid.
:func:`build_task_list` is the single source of task order — surviving
rectangles in plan order, then ``churn.recover`` patches offset into
absolute output coordinates — shared with the JAX executor so the two
backends cannot drift.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import churn, cost_model as cm
from repro_torch.core.seeding import as_rng
from repro_torch.core.verify import freivalds


@dataclass
class ExecutionReport:
    output: np.ndarray
    verified: bool
    n_tasks: int
    n_recovered: int
    recovery: Optional[churn.RecoveryResult]


@dataclass(frozen=True)
class TaskRect:
    """One executable sub-GEMM task: an absolute output rectangle owned by
    a device, tagged with whether it came from the recovery path."""
    device_id: int
    r0: int
    r1: int
    c0: int
    c1: int
    is_recovery: bool = False

    @property
    def area(self) -> int:
        return max(self.r1 - self.r0, 0) * max(self.c1 - self.c0, 0)


def build_task_list(gemm: cm.GEMM, plan: cm.Plan, devices: cm.Fleetlike,
                    fail_ids: Sequence[int] = ()
                    ) -> Tuple[List[TaskRect], Optional[churn.RecoveryResult]]:
    """The canonical task order both executor backends run: surviving
    assignment rectangles in plan order, then — when devices failed —
    every ``churn.recover`` patch assignment offset by its orphan
    rectangle's origin (the (rect, patch) pairs keep offsets aligned even
    when ``recover`` skips degenerate orphans)."""
    fail = set(fail_ids)
    tasks = [TaskRect(a.device_id, a.r0, a.r1, a.c0, a.c1, False)
             for a in plan.assignments if a.device_id not in fail]
    recovery: Optional[churn.RecoveryResult] = None
    if fail:
        event = churn.FailureEvent(gemm=gemm, failed_ids=sorted(fail),
                                   plan=plan)
        recovery = churn.recover(event, devices)
        for rect, patch in recovery.patches:
            for pa in patch.assignments:
                tasks.append(TaskRect(
                    pa.device_id, rect.r0 + pa.r0, rect.r0 + pa.r1,
                    rect.c0 + pa.c0, rect.c0 + pa.c1, True))
    return tasks, recovery


def stage_operands_f64(A: np.ndarray, B: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-cast both operands to the f64 compute dtype.  The dataflow
    dispatcher runs this on the prefetch pool so the next node's staging
    overlaps the current node's compute; slicing the staged copies is
    bit-identical to the per-task ``astype`` casts."""
    return np.ascontiguousarray(A, np.float64), \
        np.ascontiguousarray(B, np.float64)


def execute_plan_deferred(
        gemm: cm.GEMM, plan: cm.Plan, A: np.ndarray, B: np.ndarray,
        devices: cm.Fleetlike,
        fail_ids: Sequence[int] = (),
        corrupt_ids: Sequence[int] = (),
        rng: Union[np.random.Generator, int, None] = None,
        verify: bool = True,
        staged: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        ) -> Tuple[ExecutionReport, Callable[[], List[TaskRect]]]:
    """Split-phase :func:`execute_plan`: the compute phase runs every task's
    block GEMM and scatters it into C immediately; the returned ``finalize``
    closure re-walks the scattered blocks in the same task order and runs the
    Freivalds checks, recomputing (and patching into C) any block that fails.
    Calling ``finalize()`` right away is bit-identical to ``execute_plan``;
    the dataflow dispatcher instead overlaps it with the next node's compute.
    ``staged`` optionally supplies prefetched f64 operand copies
    (:func:`stage_operands_f64`).
    """
    rng = as_rng(rng)
    m, q = gemm.m, gemm.q
    assert A.shape == (m, gemm.n) and B.shape == (gemm.n, q)
    if staged is not None:
        A64, B64 = staged
    else:
        A64 = A if A.dtype == np.float64 else A.astype(np.float64)
        B64 = B if B.dtype == np.float64 else B.astype(np.float64)
    C = np.zeros((m, q), np.float64)
    filled = np.zeros((m, q), bool)
    corrupt = set(corrupt_ids)
    n_rec = 0

    tasks, recovery = build_task_list(gemm, plan, devices, fail_ids)
    for t in tasks:
        r0, r1, c0, c1 = t.r0, t.r1, t.c0, t.c1
        block = A64[r0:r1] @ B64[:, c0:c1]
        if t.device_id in corrupt and block.size:
            block[0, 0] += 1.0 + abs(block[0, 0])
        assert not filled[r0:r1, c0:c1].any(), "overlapping assignment"
        C[r0:r1, c0:c1] = block
        filled[r0:r1, c0:c1] = True
        if t.is_recovery:
            n_rec += 1
    assert filled.all(), "coverage violated"

    report = ExecutionReport(output=C, verified=True, n_tasks=len(tasks),
                             n_recovered=n_rec, recovery=recovery)

    def finalize() -> List[TaskRect]:
        corrected: List[TaskRect] = []
        if not verify:
            return corrected
        for t in tasks:
            r0, r1, c0, c1 = t.r0, t.r1, t.c0, t.c1
            Ab = A64[r0:r1]
            Bb = B64[:, c0:c1]
            if not freivalds(Ab, Bb, C[r0:r1, c0:c1], rng):
                report.verified = False
                C[r0:r1, c0:c1] = Ab @ Bb  # PS re-dispatch -> local recompute
                corrected.append(t)
        return corrected

    return report, finalize


def execute_plan(gemm: cm.GEMM, plan: cm.Plan, A: np.ndarray, B: np.ndarray,
                 devices: cm.Fleetlike,
                 fail_ids: Sequence[int] = (),
                 corrupt_ids: Sequence[int] = (),
                 rng: Union[np.random.Generator, int, None] = None,
                 verify: bool = True) -> ExecutionReport:
    """Execute every assignment; devices in `fail_ids` vanish before
    uploading (their shards are re-solved via churn.recover and executed by
    survivors); devices in `corrupt_ids` return poisoned blocks which must be
    caught by Freivalds verification.

    `rng` seeds the Freivalds check vectors: a Generator, an int seed, or
    None (seed 0).  Prefer driving this through
    ``repro_torch.api.CleaveRuntime.execute_step``, which owns a session RNG.
    """
    report, finalize = execute_plan_deferred(
        gemm, plan, A, B, devices, fail_ids=fail_ids,
        corrupt_ids=corrupt_ids, rng=rng, verify=verify)
    finalize()
    return report
