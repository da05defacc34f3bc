"""Pluggable straggler-mitigation policies (§6 / Appendix C.4).

Speculative replication and coded computation used to be a separate code
path in ``core.streaming`` that callers wired up by hand; here they become a
``mitigation=`` policy the :class:`~repro_torch.api.CleaveRuntime` applies to any
latency it reports.  ``"none"`` is the identity policy, so the runtime can
apply its policy unconditionally.

Every policy answers twice:

* :meth:`~MitigationPolicy.mitigate` — the closed-form order-statistic
  expectation (Eq. 26-28);
* :meth:`~MitigationPolicy.replay` — the same scheme *replayed* on the
  discrete-event fleet engine as duplicate / erasure chains racing under
  Pareto(α) jitter, converging to the formula as trials grow (tested).
  The replay is what generalizes: it keeps working when the latency being
  mitigated itself came from an event timeline with contention or churn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from repro_torch.core import streaming


@dataclass(frozen=True)
class MitigationReport:
    policy: str
    base_latency: float
    expected_latency: float
    redundancy: float           # extra dispatched work factor (1.0 = none)
    pareto_alpha: float = 0.0
    method: str = "analytic"    # "analytic" (Eq. 26-28) | "replay" (engine)


class MitigationPolicy:
    """Maps a base (jitter-free or jittered) latency to the expected latency
    under the policy's redundancy scheme."""
    name = "base"

    def mitigate(self, base_latency: float) -> MitigationReport:
        raise NotImplementedError

    def replay(self, base_latency: float,
               rng: Optional[np.random.Generator] = None,
               n_trials: int = 200) -> MitigationReport:
        """Event-engine Monte-Carlo replay of the policy (see module
        docstring).  Default: identical to :meth:`mitigate`."""
        rep = self.mitigate(base_latency)
        return MitigationReport(policy=rep.policy,
                                base_latency=rep.base_latency,
                                expected_latency=rep.expected_latency,
                                redundancy=rep.redundancy,
                                pareto_alpha=rep.pareto_alpha,
                                method="replay")


class NoMitigation(MitigationPolicy):
    name = "none"

    def mitigate(self, base_latency: float) -> MitigationReport:
        return MitigationReport(policy=self.name, base_latency=base_latency,
                                expected_latency=base_latency,
                                redundancy=1.0)


class SpeculativeMitigation(MitigationPolicy):
    """Every work quantum dispatched to ``r`` devices, first response wins
    (Eq. 26/27).  With ``r=None`` the cost-optimal replication r* is chosen
    from the comm/tail cost ratio."""
    name = "speculative"

    def __init__(self, pareto_alpha: float = 2.0, r: Optional[int] = None,
                 c_comm: float = 10.0, c_tail: float = 1.0):
        self.pareto_alpha = pareto_alpha
        self.r = r if r is not None else streaming.choose_replication(
            c_comm, c_tail, pareto_alpha)

    def mitigate(self, base_latency: float) -> MitigationReport:
        out = streaming.speculative_latency(base_latency, self.pareto_alpha,
                                            self.r)
        return MitigationReport(policy=self.name, base_latency=base_latency,
                                expected_latency=out.expected_latency,
                                redundancy=out.redundancy_factor,
                                pareto_alpha=self.pareto_alpha)

    def replay(self, base_latency: float,
               rng: Optional[np.random.Generator] = None,
               n_trials: int = 200) -> MitigationReport:
        """Race ``r`` duplicate chains per trial on the event engine; the
        first response wins (Eq. 26 as events)."""
        from repro_torch.sim.engine import replay_speculative
        expected = replay_speculative(base_latency, self.pareto_alpha,
                                      self.r,
                                      rng or np.random.default_rng(0),
                                      n_trials=n_trials)
        return MitigationReport(policy=self.name, base_latency=base_latency,
                                expected_latency=expected,
                                redundancy=float(self.r),
                                pareto_alpha=self.pareto_alpha,
                                method="replay")


class CodedMitigation(MitigationPolicy):
    """(n, k) erasure-coded work groups: any k of n responses reconstruct
    (Eq. 28).  With ``n=None`` the smallest n with bounded k-th order
    statistic is designed per Appendix C.4."""
    name = "coded"

    def __init__(self, pareto_alpha: float = 2.0, k: int = 64,
                 n: Optional[int] = None):
        self.pareto_alpha = pareto_alpha
        self.k = k
        self.n = n if n is not None else streaming.coded_design(k,
                                                                pareto_alpha)

    def mitigate(self, base_latency: float) -> MitigationReport:
        out = streaming.coded_latency(base_latency, self.pareto_alpha,
                                      self.k, self.n)
        return MitigationReport(policy=self.name, base_latency=base_latency,
                                expected_latency=out.expected_latency,
                                redundancy=out.redundancy_factor,
                                pareto_alpha=self.pareto_alpha)

    def replay(self, base_latency: float,
               rng: Optional[np.random.Generator] = None,
               n_trials: int = 200) -> MitigationReport:
        """Run ``n`` erasure-coded chains per trial on the event engine; the
        group completes at the k-th response (Eq. 28 as events)."""
        from repro_torch.sim.engine import replay_coded
        expected = replay_coded(base_latency, self.pareto_alpha, self.k,
                                self.n, rng or np.random.default_rng(0),
                                n_trials=n_trials)
        return MitigationReport(policy=self.name, base_latency=base_latency,
                                expected_latency=expected,
                                redundancy=self.n / self.k,
                                pareto_alpha=self.pareto_alpha,
                                method="replay")


_REGISTRY = {
    NoMitigation.name: NoMitigation,
    SpeculativeMitigation.name: SpeculativeMitigation,
    CodedMitigation.name: CodedMitigation,
}


def get_mitigation(spec: Union[str, MitigationPolicy, None]
                   ) -> MitigationPolicy:
    """Resolve a mitigation spec: an instance passes through; a name
    (``"none"`` / ``"speculative"`` / ``"coded"``) builds the default-
    parameterized policy; ``None`` means no mitigation."""
    if spec is None:
        return NoMitigation()
    if isinstance(spec, MitigationPolicy):
        return spec
    try:
        return _REGISTRY[spec]()
    except KeyError:
        raise ValueError(
            f"unknown mitigation {spec!r}; "
            f"expected one of {sorted(_REGISTRY)}") from None
