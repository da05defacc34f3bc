"""Communication-accounting strategies (EXPERIMENTS.md §Paper-validation).

The unicast/broadcast split used to live inline in ``sim.simulator``; it is
now a strategy object shared by the simulator shim and the
:class:`~repro_torch.api.CleaveRuntime` so every caller prices a schedule the same
way:

* ``unicast``  — Eq. (3) taken literally: every device's row/column shard
  crosses its own downlink.  Conservative default.
* ``broadcast`` — the §3.1 idealized accounting: each unique byte transmitted
  once, multicast to the row/column group (the paper's published Table 8
  arithmetic).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from repro_torch.core.gemm_dag import GemmDag
from repro_torch.core.scheduler import SchedulePlan


@dataclass(frozen=True)
class AccountingResult:
    batch_time: float
    gemm_time: float
    opt_tail: float
    per_device_comm: float      # max over non-excluded devices, bytes/batch
    per_device_mem: float       # max peak bytes


class AccountingStrategy:
    """Prices a solved :class:`SchedulePlan` into caller-facing numbers."""
    name = "base"

    def apply(self, dag: GemmDag, sp: SchedulePlan) -> AccountingResult:
        raise NotImplementedError


class UnicastAccounting(AccountingStrategy):
    name = "unicast"

    def apply(self, dag: GemmDag, sp: SchedulePlan) -> AccountingResult:
        return AccountingResult(
            batch_time=sp.batch_time, gemm_time=sp.gemm_time,
            opt_tail=sp.opt_tail, per_device_comm=sp.max_per_device_comm,
            per_device_mem=sp.max_per_device_mem)


class BroadcastAccounting(AccountingStrategy):
    name = "broadcast"

    def apply(self, dag: GemmDag, sp: SchedulePlan) -> AccountingResult:
        scale = broadcast_scale(dag, sp)
        gemm_time = sp.opt_tail + sp.gemm_time * scale
        return AccountingResult(
            batch_time=gemm_time + sp.opt_tail, gemm_time=gemm_time,
            opt_tail=sp.opt_tail,
            per_device_comm=sp.max_per_device_comm * scale,
            per_device_mem=sp.max_per_device_mem)


def broadcast_scale(dag: GemmDag, sp: SchedulePlan) -> float:
    """Ratio of unique input bytes to unicast-replicated input bytes."""
    unique = dag.total_in_bytes() + dag.total_out_bytes()
    replicated = (sum(sp.per_device_dl.values())
                  + sum(sp.per_device_ul.values()))
    return min(1.0, unique / max(replicated, 1.0))


_REGISTRY = {
    UnicastAccounting.name: UnicastAccounting,
    BroadcastAccounting.name: BroadcastAccounting,
}


def get_accounting(spec: Union[str, AccountingStrategy]) -> AccountingStrategy:
    """Resolve an accounting spec: a strategy instance passes through, a name
    (``"unicast"`` / ``"broadcast"``) is looked up in the registry."""
    if isinstance(spec, AccountingStrategy):
        return spec
    try:
        return _REGISTRY[spec]()
    except KeyError:
        raise ValueError(
            f"unknown accounting {spec!r}; "
            f"expected one of {sorted(_REGISTRY)}") from None
