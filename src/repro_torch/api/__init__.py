"""Session API of the port: :class:`TorchCleaveRuntime` (plan → execute →
recover → train/serve → stream → simulate), the PS islands
(:class:`PSGroup`, :class:`ShardedFleet`), the fleet, accounting and
mitigation strategies, and the timeline-event vocabulary it shares with
the reference package (copied, not imported)."""
from repro_torch.api.accounting import (AccountingResult, AccountingStrategy,
                                        BroadcastAccounting,
                                        UnicastAccounting, get_accounting)
from repro_torch.api.fleet import Fleet
from repro_torch.api.mitigation import (CodedMitigation, MitigationPolicy,
                                        MitigationReport, NoMitigation,
                                        SpeculativeMitigation,
                                        get_mitigation)
from repro_torch.api.ps_group import PSGroup, ShardedFleet
from repro_torch.api.runtime import (BatchExecuteReport, ChurnReport,
                                     LevelReport, PlanReport, PlanRequest,
                                     StepReport, StreamReport,
                                     TorchCleaveRuntime)
from repro_torch.sim.engine_array import ArrayTimelineEngine
from repro_torch.sim.events import (FailEvent, JoinEvent, SlowdownEvent,
                                    TimelineReport, fail, join, slowdown)

__all__ = [
    "AccountingResult", "AccountingStrategy", "ArrayTimelineEngine",
    "BatchExecuteReport", "BroadcastAccounting", "ChurnReport",
    "CodedMitigation", "FailEvent", "Fleet", "JoinEvent", "LevelReport",
    "MitigationPolicy", "MitigationReport", "NoMitigation", "PSGroup",
    "PlanReport", "PlanRequest", "ShardedFleet", "SlowdownEvent",
    "SpeculativeMitigation", "StepReport", "StreamReport",
    "TimelineReport", "TorchCleaveRuntime", "UnicastAccounting", "fail",
    "get_accounting", "get_mitigation", "join", "slowdown",
]
