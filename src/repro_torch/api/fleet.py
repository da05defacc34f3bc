"""Device-fleet builder for the :class:`~repro_torch.api.CleaveRuntime` session.

A :class:`Fleet` is an immutable-by-convention wrapper over the
``cost_model.Device`` list with deterministic construction (explicit seeds),
a stable content ``signature()`` used to key the runtime's plan cache, and
churn helpers (``without`` for departures, ``admit`` for joiners).
"""
from __future__ import annotations

import hashlib
import struct
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core import churn
from repro_torch.core.cost_model import Device, DeviceTable
from repro_torch.sim import devices as fleet_mod


class Fleet:
    """An edge-device fleet: the unit the runtime plans and re-plans over."""

    def __init__(self, devices: Sequence[Device],
                 seed: Optional[int] = None):
        self.devices: List[Device] = list(devices)
        self.seed = seed
        self._table: Optional[DeviceTable] = None
        self._homog_table: Optional[DeviceTable] = None

    # ------------------------------------------------------------ builders --

    @classmethod
    def sample(cls, n: int, seed: int = 0, *,
               phone_fraction: float = 0.6,
               straggler_fraction: float = 0.0,
               straggler_slowdown: float = 10.0) -> "Fleet":
        """Heterogeneous fleet (§2.1 capability ranges), bit-reproducible for
        a given ``seed``."""
        devs = fleet_mod.sample_fleet(
            n, np.random.default_rng(seed),
            phone_fraction=phone_fraction,
            straggler_fraction=straggler_fraction,
            straggler_slowdown=straggler_slowdown)
        return cls(devs, seed=seed)

    @classmethod
    def median(cls, n: int) -> "Fleet":
        """``n`` copies of the paper's median device (deterministic)."""
        return cls(fleet_mod.median_fleet(n))

    @classmethod
    def from_devices(cls, devices: Iterable[Device]) -> "Fleet":
        return cls(list(devices))

    # ------------------------------------------------------------- queries --

    def signature(self) -> str:
        """Content hash of the fleet's capabilities — the plan-cache key.
        Two fleets with identical devices share cached plans; any departure,
        join, or capability change invalidates them."""
        h = hashlib.blake2b(digest_size=8)
        for d in sorted(self.devices, key=lambda d: d.device_id):
            h.update(struct.pack("<q6d", d.device_id, *d.as_row()))
        return h.hexdigest()

    def table(self) -> DeviceTable:
        """The struct-of-arrays fleet view the vectorized planner consumes.
        Built once per ``Fleet`` instance (fleets are immutable by
        convention — churn transitions return new fleets, so the cached
        table can never go stale)."""
        if self._table is None:
            self._table = DeviceTable.from_devices(self.devices)
        return self._table

    def homogenized_table(self) -> DeviceTable:
        """Equal-capability idealization of :meth:`table` (Table 9
        ablation), cached alongside it."""
        if self._homog_table is None:
            self._homog_table = self.table().homogenized()
        return self._homog_table

    def stats(self) -> dict:
        return fleet_mod.fleet_stats(self.devices)

    def mtbf_minutes(self, hourly_failure_rate: float = 0.01) -> float:
        return fleet_mod.mtbf_minutes(len(self.devices), hourly_failure_rate)

    def ids(self) -> List[int]:
        return [d.device_id for d in self.devices]

    # --------------------------------------------------------------- churn --

    def without(self, ids: Iterable[int]) -> "Fleet":
        """Fleet after the given devices depart (failure / opt-out)."""
        gone = set(ids)
        return Fleet([d for d in self.devices if d.device_id not in gone],
                     seed=self.seed)

    def admit(self, device: Device, keep_id: bool = False) -> "Fleet":
        """Fleet after a joiner registers (fresh id, next-round folding,
        §3.2 — no pause of in-flight work).  ``keep_id=True`` preserves the
        joiner's id — the PS-island reassignment path, where a device
        migrating between shards keeps its fleet-wide identity."""
        return Fleet(churn.admit(self.devices, device, keep_id=keep_id),
                     seed=self.seed)

    # ------------------------------------------------------------- dunders --

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self) -> Iterator[Device]:
        return iter(self.devices)

    def __getitem__(self, i):
        return self.devices[i]

    def __repr__(self) -> str:
        s = self.stats() if self.devices else {"total_flops": 0.0}
        return (f"Fleet(n={len(self.devices)}, "
                f"total={s['total_flops'] / 1e12:.0f} TFLOPS, "
                f"sig={self.signature()})")
