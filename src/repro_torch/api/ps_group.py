"""PS islands: the fleet partitioned by parameter-server affinity (port of
``src/repro/api/ps_group.py``).

A :class:`PSGroup` is one island -- a parameter server, its
planner-assigned device subfleet, and (lazily) its own
:class:`~repro_torch.api.TorchCleaveRuntime` on the template runtime's
device, so every island keeps independent plan/DAG caches keyed by its own
subfleet signature.  A :class:`ShardedFleet` (a copy of the reference's)
is the K-island partition with churn transitions at island granularity: a
PS failure evicts the whole island and redistributes its devices to the
survivors **preserving device ids**.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.fleet import Fleet
from repro_torch.core import cost_model as cm
from repro_torch.core.streaming import multi_ps_plan


@dataclass
class PSGroup:
    """One parameter-server island: the PS, its device subfleet, and its
    own runtime (per-shard plan caches)."""
    ps_id: int
    fleet: Fleet
    ps: cm.PSConfig = field(default_factory=cm.PSConfig)
    _runtime: Optional[object] = field(default=None, repr=False)

    def runtime_for(self, template) -> object:
        """The island's :class:`TorchCleaveRuntime`, built once from a
        template runtime (same arch, accounting, PS, seed and device; this
        island's subfleet) -- each island plans against its own fleet
        signature, so plan caches never mix across PS shards, and its
        kernels run where the template's do."""
        if self._runtime is None:
            from repro_torch.api.runtime import TorchCleaveRuntime
            self._runtime = TorchCleaveRuntime(
                arch=template.cfg, fleet=self.fleet,
                accounting=template.accounting.name,
                ps=self.ps,
                attention_scores=template.attention_scores,
                heterogeneity_aware=template.heterogeneity_aware,
                seed=template.seed, device=template.device)
        return self._runtime

    def __len__(self) -> int:
        return len(self.fleet)


class ShardedFleet:
    """A fleet partitioned into K PS islands (device-disjoint, covering)."""

    def __init__(self, groups: Sequence[PSGroup]):
        if not groups:
            raise ValueError("ShardedFleet needs at least one PSGroup")
        self.groups: List[PSGroup] = list(groups)
        seen: set = set()
        for g in self.groups:
            ids = set(g.fleet.ids())
            if ids & seen:
                raise ValueError(
                    f"PS islands must be device-disjoint; duplicated ids "
                    f"{sorted(ids & seen)}")
            seen |= ids

    # ------------------------------------------------------------ builders --

    @classmethod
    def partition(cls, fleet: Fleet, n_ps: Optional[int] = None, *,
                  ps: Optional[cm.PSConfig] = None,
                  overlap_factor: float = 0.1) -> "ShardedFleet":
        """Partition ``fleet`` into ``n_ps`` flops-balanced islands.
        ``n_ps=None`` auto-sizes K from the §6 envelope
        (``streaming.multi_ps_plan`` on the fleet's mean downlink rate
        against ``ps.net_bw``), clamped to the fleet size."""
        ps = ps or cm.PSConfig()
        if n_ps is None:
            mean_dl = float(np.mean([d.dl_bw for d in fleet.devices]))
            n_ps = multi_ps_plan(len(fleet), mean_dl,
                                 ps_capacity_bps=ps.net_bw,
                                 overlap_factor=overlap_factor).n_ps
        n_ps = max(1, min(int(n_ps), len(fleet)))
        parts = cm.partition_devices(fleet.devices, n_ps)
        return cls([PSGroup(ps_id=k,
                            fleet=Fleet.from_devices(p), ps=ps)
                    for k, p in enumerate(parts)])

    # ------------------------------------------------------------- queries --

    @property
    def n_ps(self) -> int:
        return len(self.groups)

    def __len__(self) -> int:
        return sum(len(g) for g in self.groups)

    def __iter__(self):
        return iter(self.groups)

    def __getitem__(self, i) -> PSGroup:
        return self.groups[i]

    def ps_of(self) -> Dict[int, int]:
        """device_id -> island index (the ``TimelineEngine(ps_of=...)``
        mapping: positional index, not ``ps_id``, so it stays dense after
        island evictions)."""
        return {did: k for k, g in enumerate(self.groups)
                for did in g.fleet.ids()}

    def group_of(self, device_id: int) -> PSGroup:
        for g in self.groups:
            if device_id in g.fleet.ids():
                return g
        raise KeyError(f"device {device_id} is in no island")

    def signature(self) -> str:
        """Content hash over (island id, island fleet signature) rows —
        changes on any membership move, island loss, or capability change."""
        h = hashlib.blake2b(digest_size=8)
        for g in self.groups:
            h.update(f"{g.ps_id}:{g.fleet.signature()};".encode())
        return h.hexdigest()

    # --------------------------------------------------------------- churn --

    def without_ps(self, ps_id: int) -> Tuple["ShardedFleet",
                                              List[Tuple[int, cm.Device]]]:
        """Island-granularity churn: the PS with ``ps_id`` dies, its whole
        island is evicted, and its devices are redistributed to the
        surviving islands greedy-LPT (lightest island by total flops first),
        **keeping their device ids**.  Returns the new sharded fleet and
        the placement list ``[(survivor ps_id, device), ...]`` so the
        caller can mirror the moves into live per-island runtimes
        (``CleaveRuntime.on_join(device, keep_id=True)``)."""
        dead = next((g for g in self.groups if g.ps_id == ps_id), None)
        if dead is None:
            raise KeyError(f"no PS island with ps_id={ps_id}")
        survivors = [g for g in self.groups if g.ps_id != ps_id]
        if not survivors:
            raise RuntimeError("cannot evict the only PS island")
        loads = {g.ps_id: sum(d.flops for d in g.fleet.devices)
                 for g in survivors}
        extra: Dict[int, List[cm.Device]] = {g.ps_id: [] for g in survivors}
        placements: List[Tuple[int, cm.Device]] = []
        for d in sorted(dead.fleet.devices,
                        key=lambda d: (-d.flops, d.device_id)):
            tgt = min(survivors, key=lambda g: (loads[g.ps_id], g.ps_id))
            extra[tgt.ps_id].append(d)
            loads[tgt.ps_id] += d.flops
            placements.append((tgt.ps_id, d))
        new_groups = []
        for g in survivors:
            fl = g.fleet
            for d in extra[g.ps_id]:
                fl = fl.admit(d, keep_id=True)
            new_groups.append(PSGroup(ps_id=g.ps_id, fleet=fl, ps=g.ps))
        return ShardedFleet(new_groups), placements

    # ------------------------------------------------------------- dunders --

    def __repr__(self) -> str:
        sizes = ",".join(str(len(g)) for g in self.groups)
        return (f"ShardedFleet(n_ps={self.n_ps}, devices={len(self)}, "
                f"islands=[{sizes}], sig={self.signature()})")
