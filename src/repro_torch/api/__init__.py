"""Session API of the port: :class:`TorchCleaveRuntime` (plan → execute →
recover → serve) and the fleet, accounting and mitigation strategies it
shares with the reference package (copied, not imported)."""
from repro_torch.api.accounting import (AccountingResult, AccountingStrategy,
                                        BroadcastAccounting,
                                        UnicastAccounting, get_accounting)
from repro_torch.api.fleet import Fleet
from repro_torch.api.mitigation import (MitigationPolicy, MitigationReport,
                                        get_mitigation)
from repro_torch.api.runtime import (ChurnReport, PlanReport, PlanRequest,
                                     StepReport, TorchCleaveRuntime)

__all__ = [
    "AccountingResult", "AccountingStrategy", "BroadcastAccounting",
    "ChurnReport", "Fleet", "MitigationPolicy", "MitigationReport",
    "PlanReport", "PlanRequest", "StepReport", "TorchCleaveRuntime",
    "UnicastAccounting", "get_accounting", "get_mitigation",
]
