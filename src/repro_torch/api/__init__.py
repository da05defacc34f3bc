"""Session API of the port: :class:`TorchCleaveRuntime` (plan → execute →
recover → train/serve), the PS islands (:class:`PSGroup`,
:class:`ShardedFleet`) and the fleet, accounting and mitigation strategies
it shares with the reference package (copied, not imported)."""
from repro_torch.api.accounting import (AccountingResult, AccountingStrategy,
                                        BroadcastAccounting,
                                        UnicastAccounting, get_accounting)
from repro_torch.api.fleet import Fleet
from repro_torch.api.mitigation import (MitigationPolicy, MitigationReport,
                                        get_mitigation)
from repro_torch.api.ps_group import PSGroup, ShardedFleet
from repro_torch.api.runtime import (BatchExecuteReport, ChurnReport,
                                     LevelReport, PlanReport, PlanRequest,
                                     StepReport, TorchCleaveRuntime)

__all__ = [
    "AccountingResult", "AccountingStrategy", "BatchExecuteReport",
    "BroadcastAccounting", "ChurnReport", "Fleet", "LevelReport",
    "MitigationPolicy", "MitigationReport", "PSGroup", "PlanReport",
    "PlanRequest", "ShardedFleet", "StepReport", "TorchCleaveRuntime",
    "UnicastAccounting", "get_accounting", "get_mitigation",
]
