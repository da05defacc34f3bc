"""Streaming execution model (§3.2 / Appendix A.3) and straggler-mitigation
scheduler extensions (Appendix C.4).

The PS streams row-column pairs to each device over parallel threads so DL,
compute, and UL overlap (Eq. 9'): for k pairs,
    T_pipeline(k) = T_DL + (k-1)·max(T_DL, T_comp, T_UL) + T_comp + T_UL.
``simulate_stream`` replays the pipeline on the discrete-event fleet engine
(``repro_torch.sim.engine``) — a thin single-device wrapper that matches the
closed form exactly in the deterministic case (tested).

Mitigations:
  * speculative execution — every pair dispatched to r devices, first
    response wins (Eq. 26/27);
  * coded computation — (n, k) erasure-coded pair groups, any k of n
    responses reconstruct (Eq. 28).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import tail
from repro_torch.core.cost_model import GEMM, Device


@dataclass(frozen=True)
class PairCost:
    t_dl: float
    t_comp: float
    t_ul: float


def pair_cost(gemm: GEMM, dev: Device, alpha: int, beta: int) -> PairCost:
    """Cost of one (alpha-row x beta-col) streamed work quantum."""
    dl = (alpha + beta) * gemm.n * gemm.b / dev.dl_bw
    ul = alpha * beta * gemm.b / dev.ul_bw
    comp = 2.0 * alpha * beta * gemm.n / dev.flops
    return PairCost(t_dl=dl, t_comp=comp, t_ul=ul)


def pipeline_time(c: PairCost, k: int, dl_lat: float = 0.0,
                  ul_lat: float = 0.0) -> float:
    """Eq. (9'): fill + steady state at the slowest stage + drain."""
    if k <= 0:
        return 0.0
    steady = max(c.t_dl, c.t_comp, c.t_ul)
    return (dl_lat + c.t_dl + (k - 1) * steady + c.t_comp + c.t_ul
            + ul_lat)


def simulate_stream(c: PairCost, k: int, dl_lat: float = 0.0,
                    ul_lat: float = 0.0,
                    jitter: Optional[np.random.Generator] = None,
                    pareto_alpha: float = 0.0) -> float:
    """Three-stage pipeline (download / compute / upload with one in flight
    per stage) replayed on the discrete-event fleet engine as a single
    ``pipeline``-mode chain.  With a ``jitter`` RNG and ``pareto_alpha``,
    every stage time is multiplied by a Pareto(α)/mean sample (Appendix C
    latencies) — the α must then exceed 1 for a finite mean.  Matches
    Eq. (9') exactly in the deterministic case (tested)."""
    if jitter is not None and pareto_alpha <= 1.0:
        raise ValueError(
            f"simulate_stream: pareto_alpha must be > 1 when a jitter RNG "
            f"is provided (got {pareto_alpha}); omit the RNG for a "
            f"deterministic stream")
    if k <= 0:
        return 0.0
    # lazy import: core defines the closed forms, sim.engine replays them
    from repro_torch.sim.engine import TimelineEngine, WorkItem
    dev = Device(flops=1.0, dl_bw=1.0, ul_bw=1.0, dl_lat=0.0, ul_lat=0.0,
                 device_id=0)
    eng = TimelineEngine(
        [dev], rng=jitter,
        jitter_alpha=pareto_alpha if jitter is not None else 0.0)
    eng.add_chain(0, [WorkItem(dl_bytes=c.t_dl * k, flops=c.t_comp * k,
                               ul_bytes=c.t_ul * k, mode="pipeline", k=k,
                               dl_lat=dl_lat, ul_lat=ul_lat)])
    return eng.run().makespan


# -------------------------------------------------- speculative execution --

@dataclass
class SpeculativeOutcome:
    expected_latency: float
    redundancy_factor: float
    comm_overhead: float     # extra DL+UL bytes factor


def speculative_latency(base_latency: float, pareto_alpha: float,
                        r: int) -> SpeculativeOutcome:
    """Replicate each pair to r devices, first responder wins (Eq. 26)."""
    tail.require_alpha_gt1(pareto_alpha, "speculative_latency")
    mean = pareto_alpha / (pareto_alpha - 1.0)
    e_min = tail.replicated_min(1.0, pareto_alpha, r) / mean
    return SpeculativeOutcome(expected_latency=base_latency * e_min,
                              redundancy_factor=float(r),
                              comm_overhead=float(r))


def choose_replication(c_comm: float, c_tail: float,
                       pareto_alpha: float) -> int:
    """Eq. (27) rounded to an integer r*."""
    r = tail.optimal_replication(c_comm, c_tail, pareto_alpha)
    return max(1, int(round(r)))


# --------------------------------------------------- coded computation -----

@dataclass
class CodedOutcome:
    expected_latency: float
    redundancy_factor: float   # n / k


def coded_latency(base_latency: float, pareto_alpha: float, k: int,
                  n: int) -> CodedOutcome:
    """(n, k) erasure-coded groups: makespan = k-th order statistic of n
    (Eq. 28), normalized by the mean so `base_latency` is the no-jitter
    time."""
    tail.require_alpha_gt1(pareto_alpha, "coded_latency")
    mean = pareto_alpha / (pareto_alpha - 1.0)
    e_k = tail.coded_order_stat(1.0, pareto_alpha, k, n) / mean
    return CodedOutcome(expected_latency=base_latency * e_k,
                        redundancy_factor=n / k)


def coded_design(k: int, pareto_alpha: float) -> int:
    """n - k = O(n^{1-1/α}) extra shards (App. C.4) — smallest n whose
    expected k-th order statistic is within 2x the scale parameter."""
    tail.require_alpha_gt1(pareto_alpha, "coded_design")
    n = k
    while n < 4 * k:
        if tail.coded_order_stat(1.0, pareto_alpha, k, n) <= \
                2.0 * pareto_alpha / (pareto_alpha - 1.0):
            return n
        n += max(1, k // 20)
    return n


# ---------------------------------------------------- multi-PS scale-out ---

@dataclass
class MultiPSPlan:
    n_ps: int
    per_ps_devices: int
    per_ps_demand_gbps: float
    within_envelope: bool


def multi_ps_plan(n_devices: int, per_device_dl_bps: float,
                  ps_capacity_bps: float = 25e9,
                  overlap_factor: float = 0.1) -> MultiPSPlan:
    """§6 single-PS operating envelope + 1/N scale-out: service demand is
    per-level payload (devices overlap seconds-scale compute, so only
    ~`overlap_factor` of peak link rates hit the PS concurrently)."""
    demand = n_devices * per_device_dl_bps * overlap_factor
    n_ps = max(1, math.ceil(demand / ps_capacity_bps))
    return MultiPSPlan(
        n_ps=n_ps,
        per_ps_devices=math.ceil(n_devices / n_ps),
        per_ps_demand_gbps=demand / n_ps / 1e9,
        within_envelope=demand / n_ps <= ps_capacity_bps)


def island_boundaries(n_devices: int, n_ps: int) -> list:
    """Contiguous ``[start, end)`` device-index ranges for ``n_ps`` islands:
    the balanced split behind ``multi_ps_plan.per_ps_devices`` made exact —
    island sizes differ by at most one, the first ``n_devices % n_ps``
    islands carry the extra device, and the ranges tile ``[0, n_devices)``.
    ``n_ps=1`` degenerates to the whole fleet."""
    if n_ps < 1 or n_devices < n_ps:
        raise ValueError(
            f"island_boundaries: need 1 <= n_ps <= n_devices, "
            f"got n_ps={n_ps}, n_devices={n_devices}")
    base, extra = divmod(n_devices, n_ps)
    out, start = [], 0
    for i in range(n_ps):
        size = base + (1 if i < extra else 0)
        out.append((start, start + size))
        start += size
    return out


# --------------------------------------------------------- energy model ----

@dataclass
class EnergyEstimate:
    edge_kwh: float
    cloud_kwh: float
    ratio: float
    edge_carbon_kg: float
    cloud_carbon_kg: float


def energy_comparison(total_flops: float, n_devices: int,
                      device_flops: float = 6e12,
                      device_watts: float = 4.0,   # phone/laptop NPU at load
                      wifi_watts: float = 0.5,
                      comm_seconds_per_device: float = 0.0,
                      a100_flops: float = 312e12,
                      a100_watts: float = 400.0,
                      pue_cloud: float = 1.2,
                      carbon_kg_per_kwh: float = 0.4,
                      embodied_discount_edge: float = 0.5) -> EnergyEstimate:
    """§6 energy/carbon companion-analysis model: already-provisioned edge
    devices amortize embodied carbon; cloud pays PUE overhead.  Under the
    paper's representative settings this yields the 1.5-5x energy and
    3.5-6x carbon advantages it reports."""
    t_edge = total_flops / (n_devices * device_flops * 0.3)
    edge_kwh = (n_devices * (device_watts * t_edge
                             + wifi_watts * comm_seconds_per_device)
                / 3.6e6)
    t_cloud = total_flops / (a100_flops * 0.45)
    cloud_kwh = a100_watts * t_cloud * pue_cloud / 3.6e6
    edge_c = edge_kwh * carbon_kg_per_kwh * embodied_discount_edge
    cloud_c = cloud_kwh * carbon_kg_per_kwh
    return EnergyEstimate(edge_kwh=edge_kwh, cloud_kwh=cloud_kwh,
                          ratio=cloud_kwh / max(edge_kwh, 1e-12),
                          edge_carbon_kg=edge_c, cloud_carbon_kg=cloud_c)
