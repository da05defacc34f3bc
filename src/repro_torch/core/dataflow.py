"""Readiness-driven dataflow dispatch over GEMM-DAG nodes.

The level-barrier walk (``for level in dag.levels(): for g in level: ...``)
wastes the §3.2 overlap the planner already prices: a GEMM whose producers
finished early idles behind the slowest node of the previous level, operand
staging can't start until the level opens, and Freivalds verification of
level *k* serializes in front of level *k+1*'s gathers.  This module is the
host-side replacement: a dependency-counting ready queue over node indices
with a thread pool running three overlapped phases per node —

* **prefetch** — when a node is one unfinished producer away from ready,
  its operand staging (padded device buffers on the jax path, f64 casts on
  the numpy path) is submitted to the pool, double-buffered behind the
  current node's compute;
* **compute** — the split-phase executor's compute half
  (:func:`repro_torch.core.executor.execute_plan_deferred` /
  :func:`repro_torch.core.jax_executor.execute_plan_jax_deferred`): band-bucketed
  batched launches + scatter, no verification on the critical path;
* **finalize** — the deferred Freivalds half, submitted as soon as the
  compute half lands, overlapping node *k*'s verification with node
  *k+1*'s gathers and compute.

Verification failure triggers targeted rollback: any dependent whose
compute *started* before the failed node's correction landed is
re-dispatched (re-running only that node; every node's output is a pure
function of its operands, the plan, and the fail set, so the re-run is
exact) — mirroring how ``churn.recover`` patches re-dispatch only the
orphaned rectangles rather than the whole level.

Determinism: node outputs never depend on dispatch order or thread timing.
Operand generation happens up front in node order, Freivalds draws come
from per-node child generators, and a failed check recomputes the exact
block — so the same seed gives bit-identical C across repeated runs, which
`tests/test_dataflow.py` pins.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class DataflowReport:
    """Bookkeeping from one :func:`run_dataflow` pass."""
    order: List[int] = field(default_factory=list)  # compute completion order
    n_redispatched: int = 0       # dependents re-run after a failed verify
    n_prefetched: int = 0


def default_workers() -> int:
    return max(2, min(8, (os.cpu_count() or 4) - 1))


def run_dataflow(
        n_nodes: int,
        deps: Sequence[Sequence[int]],
        compute: Callable[[int], Tuple[object, Optional[Callable]]],
        *,
        prefetch: Optional[Callable[[int], None]] = None,
        max_workers: Optional[int] = None,
        ) -> Tuple[List[object], DataflowReport]:
    """Run ``compute(i)`` for every node as soon as its dependencies are
    complete.

    ``compute(i)`` returns ``(result, finalize)``; ``finalize`` (or None)
    is the node's deferred verification, submitted to the same pool right
    after the compute half returns and overlapped with downstream compute.
    A ``finalize`` returning a truthy value signals that blocks were
    corrected after a failed check: every dependent of that node whose
    compute started before the correction is re-dispatched once all other
    work has drained.  ``prefetch(j)`` (optional) is submitted for a node
    when it becomes ready-or-one-away, staging its operands behind the
    running compute.  Returns the per-node results in index order plus a
    :class:`DataflowReport`.
    """
    deps = [list(d) for d in deps]
    indeg = [len(d) for d in deps]
    dependents: List[List[int]] = [[] for _ in range(n_nodes)]
    for i, ds in enumerate(deps):
        for j in ds:
            dependents[j].append(i)

    results: List[object] = [None] * n_nodes
    report = DataflowReport()
    lock = threading.Lock()
    started_at: Dict[int, int] = {}     # node -> dispatch tick of its compute
    corrected_at: Dict[int, int] = {}   # node -> dispatch tick of correction
    tick = [0]
    prefetched: set = set()

    def _submit_prefetch(pool, j):
        if prefetch is None or j in prefetched:
            return
        prefetched.add(j)
        report.n_prefetched += 1
        pool.submit(prefetch, j)

    def _run_compute(i):
        return compute(i)

    with ThreadPoolExecutor(
            max_workers=max_workers or default_workers(),
            thread_name_prefix="dataflow") as pool:

        def _dispatch(i, pending):
            with lock:
                tick[0] += 1
                started_at[i] = tick[0]
            fut = pool.submit(_run_compute, i)
            pending[fut] = i
            # stage operands of nodes this completion will unblock next
            for j in dependents[i]:
                if indeg[j] == 1:
                    _submit_prefetch(pool, j)

        def _finalize_wrapper(i, finalize):
            corrected = finalize()
            if corrected:
                # stamp when the correction actually landed, so rollback
                # targets only the dependents already in flight by then
                with lock:
                    tick[0] += 1
                    corrected_at[i] = tick[0]
            return corrected

        def _drain(ready):
            """Dispatch `ready` and everything it unblocks; collect
            finalize futures."""
            pending: Dict[object, int] = {}
            vfuts: List[object] = []
            for i in ready:
                _dispatch(i, pending)
            while pending:
                done, _ = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    i = pending.pop(fut)
                    result, finalize = fut.result()
                    results[i] = result
                    report.order.append(i)
                    if finalize is not None:
                        vfuts.append(pool.submit(_finalize_wrapper,
                                                 i, finalize))
                    for j in dependents[i]:
                        indeg[j] -= 1
                        if indeg[j] == 0:
                            _dispatch(j, pending)
            for vfut in vfuts:          # drain the overlapped verifies
                vfut.result()

        _drain([i for i in range(n_nodes) if indeg[i] == 0])

        # targeted rollback: re-dispatch dependents that computed against a
        # block later corrected by the overlapped Freivalds check.  Outputs
        # are pure functions of (operands, plan, fail set), so the re-run
        # is exact; the corrected producer output itself stays in place.
        redo = sorted({
            j for i, ct in corrected_at.items() for j in dependents[i]
            if started_at.get(j, ct + 1) < ct})
        for j in redo:
            report.n_redispatched += 1
            result, finalize = compute(j)
            results[j] = result
            if finalize is not None:
                finalize()

    return results, report
