"""Churn recovery (§4.2): device failures orphan only that device's
row/column shards; the same cost model re-solves a much smaller instance over
the orphaned rectangle with cache-aware communication (rows/columns already
resident on surviving devices download for free).

Also models new-device admission: a joiner registers capabilities and is
folded into the device set for the next GEMM round (no training pause).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import cost_model as cm


@dataclass
class FailureEvent:
    gemm: cm.GEMM
    failed_ids: list            # device ids that disappeared mid-level
    plan: cm.Plan               # the plan that was executing


@dataclass
class RecoveryResult:
    patches: list               # (orphan rect, patch Plan) pairs.  Empty or
    #                             fully-completed orphan rectangles are
    #                             skipped, so consumers must NOT zip the
    #                             plans against the plan's orphan list —
    #                             iterate the pairs, which carry the rect a
    #                             patch's offsets are relative to.
    recovery_time: float        # makespan of the patch schedule
    recomputed_fraction: float  # share of the GEMM output recomputed
    solve_time: float           # wall-clock of the incremental re-solve

    @property
    def patch_plans(self) -> list:
        """The patch plans alone (legacy view; alignment-safe iteration is
        ``for rect, patch in result.patches``)."""
        return [p for _, p in self.patches]


def device_caches(plan: cm.Plan) -> Dict[int, tuple]:
    """rows/cols already resident per device for this GEMM (its own shard
    stays cached until the level completes, §4.2 R_s/C_s)."""
    caches: Dict[int, tuple] = {}
    for a in plan.assignments:
        rc, cc = caches.get(a.device_id, (0.0, 0.0))
        caches[a.device_id] = (rc + a.alpha, cc + a.beta)
    return caches


def _cache_overlap(plan: cm.Plan, rect: cm.Assignment) -> Dict[int, tuple]:
    """Per surviving device: how many of the orphan rectangle's rows/cols it
    already holds (row-band neighbours hold the same rows; column-aligned
    devices hold the same cols)."""
    out: Dict[int, tuple] = {}
    for a in plan.assignments:
        rows = max(0, min(a.r1, rect.r1) - max(a.r0, rect.r0))
        cols = max(0, min(a.c1, rect.c1) - max(a.c0, rect.c0))
        rc, cc = out.get(a.device_id, (0.0, 0.0))
        out[a.device_id] = (max(rc, float(rows)), max(cc, float(cols)))
    return out


def recover(event: FailureEvent, devices: cm.Fleetlike,
            completed_fraction: float = 0.0) -> RecoveryResult:
    """Re-solve the orphaned shards over surviving devices (Eq. in §4.2).

    `completed_fraction`: fraction of the failed device's shard already
    uploaded before the failure (bookkeeping identifies finished outputs;
    only unfinished work is redistributed)."""
    t0 = time.perf_counter()
    failed = set(event.failed_ids)
    tab = cm.DeviceTable.ensure(devices)
    if failed.isdisjoint(tab.id_index):
        # caller already passed a survivor fleet (the runtime's churn path
        # and the executors do): reuse its SoA view outright
        survivor_table = tab
    else:
        survivors = [d for d in tab.devices if d.device_id not in failed]
        survivor_table = cm.DeviceTable.from_devices(survivors)
    if not len(survivor_table):
        raise RuntimeError("no surviving devices")
    # one struct-of-arrays view shared by every orphan re-solve
    orphan_rects = [a for a in event.plan.assignments
                    if a.device_id in failed]

    patches: List[tuple] = []
    total_area = float(event.gemm.m * event.gemm.q)
    orphan_area = 0.0
    recovery_time = 0.0
    for rect in orphan_rects:
        # unfinished columns only (completed outputs were already uploaded)
        c1 = rect.c1 - int(completed_fraction * (rect.c1 - rect.c0))
        if c1 <= rect.c0 or rect.r1 <= rect.r0:
            continue
        sub = cm.GEMM(m=rect.r1 - rect.r0, n=event.gemm.n, q=c1 - rect.c0,
                      b=event.gemm.b, name=event.gemm.name + ".recovery",
                      level=event.gemm.level, layer=event.gemm.layer)
        caches = _cache_overlap(event.plan, rect)
        plan = cm.solve_gemm(sub, survivor_table, caches=caches)
        patches.append((rect, plan))
        orphan_area += sub.m * sub.q
        recovery_time = max(recovery_time, plan.makespan)
    solve_time = time.perf_counter() - t0
    return RecoveryResult(
        patches=patches, recovery_time=recovery_time,
        recomputed_fraction=orphan_area / total_area,
        solve_time=solve_time)


def admit(devices: List[cm.Device], new_device: cm.Device,
          keep_id: bool = False) -> List[cm.Device]:
    """New device joins on the next GEMM round — no pause, no resharding of
    in-flight work (§3.2).  By default the joiner gets a fresh id (a
    recycled id must never resurrect a dead device's cached plans);
    ``keep_id=True`` preserves it — the island-reassignment path, where a
    device migrating between PS shards keeps its fleet-wide identity so
    churn bookkeeping stays coherent across islands."""
    import dataclasses
    if keep_id:
        if any(d.device_id == new_device.device_id for d in devices):
            raise ValueError(
                f"admit(keep_id=True): device_id {new_device.device_id} "
                "already present in the fleet")
        return list(devices) + [new_device]
    nid = max((d.device_id for d in devices), default=-1) + 1
    return list(devices) + [dataclasses.replace(new_device, device_id=nid)]
