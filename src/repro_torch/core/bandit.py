"""Thompson-sampling device selection (Appendix C.5's suggested extension).

The PS maintains a Normal-Gamma posterior over each device's log service
time from runtime telemetry; per round it samples a rate per device and
hands the sampled capabilities to the deterministic cost-model solver —
exploration (uncertain devices occasionally tried) and exploitation
(chronically degraded devices drift out of the schedule) in one mechanism,
composing with the §4.1 scheduler unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import Device


@dataclass
class Posterior:
    """Normal-Gamma over log of the device's slowdown factor.

    The prior is tight around nominal (devices *register* their
    capabilities at join, §3.2) — exploration widens only after surprising
    telemetry."""
    mu: float = 0.0        # mean log-slowdown (0 => nominal speed)
    kappa: float = 4.0
    alpha: float = 4.0
    beta: float = 0.2
    n: int = 0

    def update(self, log_slowdown: float):
        self.n += 1
        k0, m0 = self.kappa, self.mu
        self.mu = (k0 * m0 + log_slowdown) / (k0 + 1)
        self.kappa = k0 + 1
        self.alpha += 0.5
        self.beta += 0.5 * k0 * (log_slowdown - m0) ** 2 / (k0 + 1)

    def sample(self, rng: np.random.Generator) -> float:
        prec = rng.gamma(self.alpha, 1.0 / self.beta)
        var = 1.0 / max(prec * self.kappa, 1e-9)
        return rng.normal(self.mu, np.sqrt(var))


class ThompsonScheduler:
    """Wraps a device fleet; yields capability-sampled fleets for the
    solver and ingests observed completion times."""

    def __init__(self, devices: Sequence[Device], seed: int = 0):
        self.devices = list(devices)
        self.post: Dict[int, Posterior] = {
            d.device_id: Posterior() for d in devices}
        self.rng = np.random.default_rng(seed)

    def sampled_fleet(self) -> List[Device]:
        out = []
        for d in self.devices:
            s = float(np.exp(self.post[d.device_id].sample(self.rng)))
            s = float(np.clip(s, 0.05, 50.0))
            out.append(dataclasses.replace(
                d, flops=d.flops / s, dl_bw=d.dl_bw / s, ul_bw=d.ul_bw / s))
        return out

    def observe(self, device_id: int, expected_s: float, actual_s: float):
        if expected_s <= 0 or actual_s <= 0:
            return
        self.post[device_id].update(float(np.log(actual_s / expected_s)))

    def believed_slowdown(self, device_id: int) -> float:
        return float(np.exp(self.post[device_id].mu))
