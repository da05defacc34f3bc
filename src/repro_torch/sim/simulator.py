"""Per-batch-runtime simulation engine of the port (§5; a copy of
``src/repro/sim/simulator.py`` but for ``_cleave`` and
``cleave_batch_time``): evaluates CLEAVE and the baselines under the same
latency accounting, runs the straggler / churn / scaling / ablation
experiments, and applies the paper's matched-resource normalizations.

The unicast/broadcast communication accountings live in
``repro_torch.api.accounting`` (strategy objects shared with the
``TorchCleaveRuntime`` session API); the experiments below all price CLEAVE
through that runtime.  ``cleave_batch_time`` remains as a deprecated shim.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.core import churn, cost_model as cm
from repro_torch.core.gemm_dag import GemmDag, build_dag
from repro_torch.core.scheduler import SchedulePlan, schedule
from repro_torch.sim import baselines, devices as fleet_mod


@dataclass
class CleaveResult:
    batch_time: float
    gemm_time: float
    opt_tail: float
    per_device_comm: float
    per_device_mem: float
    plan: SchedulePlan


def _cleave(cfg: ArchConfig, batch: int, seq: int,
            devices: Sequence[cm.Device],
            attention_scores: str = "ps",
            accounting: str = "unicast",
            heterogeneity_aware: bool = True) -> CleaveResult:
    """Price one CLEAVE batch via the unified runtime (single shared path
    for simulator, benchmarks, and examples)."""
    from repro_torch.api import Fleet, TorchCleaveRuntime
    # pricing makes no tensor and launches no kernel, so the runtime is
    # built on the host; this is no fallback: nothing here needs the card
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.from_devices(devices),
                            accounting=accounting,
                            attention_scores=attention_scores,
                            heterogeneity_aware=heterogeneity_aware,
                            device="cpu")
    rep = rt.plan(batch, seq)
    return CleaveResult(batch_time=rep.batch_time, gemm_time=rep.gemm_time,
                        opt_tail=rep.opt_tail,
                        per_device_comm=rep.per_device_comm,
                        per_device_mem=rep.per_device_mem,
                        plan=rep.schedule)


def cleave_batch_time(cfg: ArchConfig, batch: int, seq: int,
                      devices: Sequence[cm.Device],
                      attention_scores: str = "ps",
                      accounting: str = "unicast",
                      heterogeneity_aware: bool = True,
                      use_ps: bool = True) -> CleaveResult:
    """Deprecated shim: use
    ``repro_torch.api.TorchCleaveRuntime(...).plan(batch, seq)`` instead.
    Results are unchanged."""
    warnings.warn(
        "cleave_batch_time is deprecated; use "
        "repro_torch.api.TorchCleaveRuntime(...).plan(batch, seq)",
        DeprecationWarning, stacklevel=2)
    del use_ps  # kept for signature compatibility (Table 9 handled in
    #             ablation() via the alpa-volume baseline)
    return _cleave(cfg, batch, seq, devices,
                   attention_scores=attention_scores, accounting=accounting,
                   heterogeneity_aware=heterogeneity_aware)


# ----------------------------------------------------------- experiments --

def compare_systems(arch: str, batch: int, seq: int, n_devices: int,
                    rng=None, accounting: str = "unicast") -> dict:
    """Fig 3 / Table 8 row: CLEAVE vs DTFM vs Alpa vs cloud."""
    cfg = get_config(arch)
    devs = fleet_mod.median_fleet(n_devices)
    n_params = cfg.n_params()
    out = {"arch": arch, "devices": n_devices}
    cl = _cleave(cfg, batch, seq, devs, accounting=accounting)
    out["cleave"] = cl.batch_time
    out["cleave_comm_mb"] = cl.per_device_comm / 1e6
    out["cleave_mem_mb"] = cl.per_device_mem / 1e6
    try:
        dt = baselines.dtfm_batch_time(n_params, batch, seq, cfg.d_model,
                                       cfg.n_layers, devs)
        out["dtfm"] = dt.batch_time
        out["dtfm_mem_mb"] = dt.per_device_mem / 1e6
    except baselines.SolverOOM:
        out["dtfm"] = float("nan")
        out["dtfm_mem_mb"] = float("nan")
    al = baselines.alpa_batch_time(n_params, batch, seq, cfg.d_model,
                                   cfg.d_ff, cfg.n_layers, devs)
    out["alpa"] = al.batch_time
    out["alpa_mem_mb"] = al.per_device_mem / 1e6
    cloud = baselines.cloud_batch_time(n_params, batch, seq, n_gpus=1)
    out["cloud"] = cloud.batch_time
    return out


def straggler_experiment(arch: str = "opt-13b", batch: int = 128,
                         seq: int = 1024, n_devices: int = 32,
                         fractions=(0.0, 0.05, 0.1, 0.2),
                         seed: int = 0) -> List[dict]:
    """Fig 6: per-batch runtime vs straggler fraction, normalized to each
    system's no-straggler runtime."""
    cfg = get_config(arch)
    n_params = cfg.n_params()
    rows = []
    base = {}
    for frac in fractions:
        rng = np.random.default_rng(seed)
        devs = fleet_mod.sample_fleet(n_devices, rng,
                                      straggler_fraction=frac)
        cl = _cleave(cfg, batch, seq, devs)
        al = baselines.alpa_batch_time(n_params, batch, seq, cfg.d_model,
                                       cfg.d_ff, cfg.n_layers, devs)
        try:
            dt = baselines.dtfm_batch_time(n_params, batch, seq, cfg.d_model,
                                           cfg.n_layers, devs).batch_time
        except baselines.SolverOOM:
            dt = float("nan")
        row = {"fraction": frac, "cleave": cl.batch_time,
               "alpa": al.batch_time, "dtfm": dt}
        if frac == fractions[0]:
            base = dict(row)
        for k in ("cleave", "alpa", "dtfm"):
            row[f"{k}_norm"] = row[k] / base[k]
        # ideal: straggler work redistributed at infinitely fine granularity
        devs_ideal = [d for d in devs
                      if d.flops >= np.median([x.flops for x in devs]) / 5]
        ideal = _cleave(cfg, batch, seq, devs_ideal).batch_time
        row["ideal_norm"] = ideal / base["cleave"]
        rows.append(row)
    return rows


def churn_experiment(arch: str = "opt-13b", batch: int = 128,
                     seq: int = 1024, n_devices: int = 256,
                     seed: int = 0) -> dict:
    """Fig 7: absolute single-failure recovery latency, CLEAVE vs baselines."""
    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    devs = fleet_mod.sample_fleet(n_devices, rng)
    # representative (largest) weight GEMM mid-level failure
    dag = build_dag(cfg, batch, seq, attention_scores="ps")
    g = max(dag.gemms, key=lambda g: g.flops)
    plan = cm.solve_gemm(g, devs)
    victim = plan.assignments[len(plan.assignments) // 2].device_id
    event = churn.FailureEvent(gemm=g, failed_ids=[victim], plan=plan)
    rec = churn.recover(event, devs)
    base = baselines.recovery_times(cfg.n_params(), batch, seq, cfg.d_model,
                                    cfg.n_layers, devs)
    out = {"cleave": rec.recovery_time + rec.solve_time,
           "cleave_solve": rec.solve_time,
           "cleave_recompute_fraction": rec.recomputed_fraction}
    out.update(base)
    return out


def scaling_devices(arch: str = "opt-13b", batch: int = 128, seq: int = 1024,
                    counts=(32, 64, 128, 256, 512, 1024),
                    accounting: str = "unicast") -> List[dict]:
    """Fig 8 strong scaling: fixed model/batch, growing fleet."""
    return [compare_systems(arch, batch, seq, n, accounting=accounting)
            for n in counts]


def scaling_model(pairs=(("opt-1.3b", 64), ("opt-13b", 256),
                         ("llama2-13b", 256), ("opt-66b", 1024),
                         ("llama2-70b", 1024)),
                  batch: int = 128, seq: int = 1024) -> List[dict]:
    """Fig 9 weak scaling in model size."""
    return [compare_systems(a, batch, seq, n) for a, n in pairs]


def scaling_batch(arch: str = "opt-13b", seq: int = 1024,
                  batches=(16, 32, 64, 128, 256),
                  device_per_batch: int = 2) -> List[dict]:
    """Fig 10 weak scaling in batch size (each device owns microbatch 2)."""
    return [compare_systems(arch, b, seq, max(b // device_per_batch, 8) * 8)
            for b in batches]


def ablation(arch: str = "llama2-13b", batch: int = 128, seq: int = 1024,
             n_devices: int = 1024, seed: int = 0) -> dict:
    """Table 9: contribution of TP (sub-GEMM sharding), the PS architecture,
    and heterogeneity awareness."""
    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    devs = fleet_mod.sample_fleet(n_devices, rng)
    n_params = cfg.n_params()

    full = _cleave(cfg, batch, seq, devs)
    base = {"comm": full.per_device_comm, "mem": full.per_device_mem,
            "runtime": full.batch_time}

    # w/o TP: no row/column sharding — each device receives whole matrices
    # (bounded by its memory; GEMV-style work assignment).
    dag = build_dag(cfg, batch, seq, attention_scores="ps")
    dl = np.median([d.dl_bw for d in devs])
    comm_wo_tp = max(g.in_bytes + g.out_bytes for g in dag.gemms)
    runtime_wo_tp = sum(
        (g.in_bytes / dl + g.flops / np.median([d.flops for d in devs]))
        / max(1, n_devices // g.count if g.count > 1 else 1) * g.count
        if g.count > 1 else (g.in_bytes + g.out_bytes) / dl
        for g in dag.gemms)
    mem_wo_tp = max(g.in_bytes + g.out_bytes for g in dag.gemms)

    # w/o PS: peer-to-peer — Alpa-style collectives replace PS dispatch
    al = baselines.alpa_batch_time(n_params, batch, seq, cfg.d_model,
                                   cfg.d_ff, cfg.n_layers, devs)
    # optimizer must live on devices now
    mem_wo_ps = full.per_device_mem + 12.0 * n_params / n_devices

    # w/o heterogeneity awareness
    wo_het = _cleave(cfg, batch, seq, devs,
                     heterogeneity_aware=False)

    return {
        "cleave": base,
        "wo_tp": {"comm": comm_wo_tp, "mem": mem_wo_tp,
                  "runtime": runtime_wo_tp},
        "wo_ps": {"comm": al.per_device_comm, "mem": mem_wo_ps,
                  "runtime": al.batch_time},
        "wo_hetero": {"comm": wo_het.per_device_comm,
                      "mem": wo_het.per_device_mem,
                      "runtime": wo_het.batch_time},
    }


def adaptive_experiment(arch: str = "opt-13b", batch: int = 128,
                        seq: int = 1024, n_devices: int = 64,
                        n_rounds: int = 12, seed: int = 0) -> List[dict]:
    """§6 "adaptation to active devices" + App. C.5: mid-run, a quarter of
    the fleet becomes foreground-active (hidden 8x slowdown).  A static
    scheduler keeps trusting registered capabilities; the Thompson-sampling
    scheduler learns the degradation from completion telemetry and shifts
    work away, then re-admits devices when they recover."""
    from repro_torch.core.bandit import ThompsonScheduler

    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    devs = fleet_mod.sample_fleet(n_devices, rng)
    degraded = set(rng.choice(n_devices, size=n_devices // 4,
                              replace=False).tolist())
    dag = build_dag(cfg, batch, seq, attention_scores="ps")
    ts = ThompsonScheduler(devs, seed=seed)
    rows = []
    for rnd in range(n_rounds):
        active_phase = n_rounds // 4 <= rnd < 3 * n_rounds // 4

        def truth(d):
            s = 8.0 if (active_phase and d.device_id in degraded) else 1.0
            return dataclasses.replace(d, flops=d.flops / s,
                                       dl_bw=d.dl_bw / s, ul_bw=d.ul_bw / s)

        true_fleet = [truth(d) for d in devs]
        # static: plans on registered capabilities, pays true time
        static_plan = schedule(dag, devs)
        static_time = schedule(dag, true_fleet,
                               heterogeneity_aware=True).batch_time
        static_real = _evaluate_on(static_plan, true_fleet)
        # adaptive: plans on sampled beliefs, pays true time, observes
        believed = ts.sampled_fleet()
        adapt_plan = schedule(dag, believed)
        adapt_real = _evaluate_on(adapt_plan, true_fleet)
        for d in devs:
            s = 8.0 if (active_phase and d.device_id in degraded) else 1.0
            ts.observe(d.device_id, 1.0, s * rng.lognormal(0, 0.1))
        rows.append({"round": rnd, "active_phase": active_phase,
                     "static_s": static_real,
                     "adaptive_s": adapt_real,
                     "oracle_s": static_time})
    return rows


def _evaluate_on(plan: SchedulePlan, true_fleet) -> float:
    """Re-price a schedule's level times against the true capabilities
    (the plan keeps its shard assignments; the fleet's real speeds pay).
    Each unique shape's plan is replayed once through the discrete-event
    engine — the same substrate that prices streaming, contention, and
    churn — instead of a third copy of the closed-form level formulas."""
    from repro_torch.sim.engine import price_plan
    n_pool = len(true_fleet)
    total = 0.0
    cache: dict = {}
    for level in plan.dag.levels():
        t = 0.0
        for g in level:
            key = (g.m, g.n, g.q, g.b, g.count)
            if key not in cache:
                cache[key] = price_plan(g, plan.plans_by_shape[key],
                                        true_fleet, n_pool)
            t = max(t, cache[key])
        total += t
    return total + plan.opt_tail


def memory_experiment(archs=("opt-1.3b", "opt-13b", "llama2-13b", "opt-66b",
                             "llama2-70b"),
                      batch: int = 128, seq: int = 1024,
                      n_candidates: int = 8192) -> List[dict]:
    """Fig 5: per-device peak memory; each system picks its device count."""
    rows = []
    for arch in archs:
        cfg = get_config(arch)
        n_params = cfg.n_params()
        devs = fleet_mod.median_fleet(min(n_candidates, 1024))
        cl = _cleave(cfg, batch, seq, devs)
        row = {"arch": arch, "cleave_mb": cl.per_device_mem / 1e6}
        try:
            dt = baselines.dtfm_batch_time(
                n_params, batch, seq, cfg.d_model, cfg.n_layers,
                fleet_mod.median_fleet(min(n_candidates, 4096)))
            row["dtfm_mb"] = dt.per_device_mem / 1e6
        except baselines.SolverOOM:
            row["dtfm_mb"] = float("nan")
        al = baselines.alpa_batch_time(
            n_params, batch, seq, cfg.d_model, cfg.d_ff, cfg.n_layers,
            fleet_mod.median_fleet(min(n_candidates, 8192)))
        row["alpa_mb"] = al.per_device_mem / 1e6
        rows.append(row)
    return rows
