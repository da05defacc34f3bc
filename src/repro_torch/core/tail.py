"""Distributional latency modeling (Appendix C): Pareto tails, EVT barrier
scaling, CVaR-augmented cost, speculative execution, coded computation.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln


# ------------------------------------------------------------------ Pareto --

def require_alpha_gt1(alpha: float, what: str) -> None:
    """Mean-based tail quantities need a finite-mean Pareto: α > 1.  The
    mitigation formulas divide by (α − 1), so α ≤ 1 silently produced
    negative/garbage latencies before this guard."""
    if not alpha > 1.0:
        raise ValueError(
            f"{what}: pareto_alpha must be > 1 for a finite mean "
            f"(got {alpha})")


def pareto_sample(rng, x_m: float, alpha: float, size):
    if not alpha > 0:
        raise ValueError(f"pareto_sample: alpha must be > 0, got {alpha}")
    u = rng.uniform(size=size)
    return x_m / np.power(u, 1.0 / alpha)


def expected_max(x_m: float, alpha: float, D: int) -> float:
    """Eq. (22): E[max of D Pareto(α, x_m)] ~ x_m α/(α−1) D^{1/α} (α>1)."""
    if alpha <= 1:
        return math.inf
    return x_m * alpha / (alpha - 1.0) * D ** (1.0 / alpha)


def expected_max_exact(x_m: float, alpha: float, D: int) -> float:
    """Exact E[max] via order statistics: E[L_(D:D)] = x_m · Γ(D+1)Γ(1-1/α) /
    Γ(D+1-1/α)."""
    if alpha <= 1:
        return math.inf
    return x_m * math.exp(gammaln(D + 1) + gammaln(1 - 1 / alpha)
                          - gammaln(D + 1 - 1 / alpha))


def expected_max_exponential(x_m: float, D: int) -> float:
    """Light-tailed reference (Table 12): E[max of D Exp(mean x_m)] =
    x_m · H_D ≈ x_m (ln D + γ)."""
    return x_m * (math.log(D) + 0.5772156649) if D > 1 else x_m


def cvar(x_m: float, alpha: float, beta: float = 0.05) -> float:
    """Eq. (24): CVaR_β[L] = x_m β^{-1/α} α/(α−1)."""
    if alpha <= 1:
        return math.inf
    return x_m / beta ** (1.0 / alpha) * alpha / (alpha - 1.0)


# ------------------------------------------------- straggler mitigations --

def replicated_min(x_m: float, alpha: float, r: int) -> float:
    """Eq. (26): E[min of r replicas] = x_m · rα/(rα−1) · r^{−1/α}."""
    require_alpha_gt1(alpha, "replicated_min")
    ra = r * alpha
    return x_m * ra / (ra - 1.0) * r ** (-1.0 / alpha)


def optimal_replication(c_comm: float, c_tail: float, alpha: float) -> float:
    """Eq. (27): r* ≈ (C_comm / (C_tail α))^{α/(α+1)} (clamped ≥ 1)."""
    return max(1.0, (c_comm / (c_tail * alpha)) ** (alpha / (alpha + 1.0)))


def coded_order_stat(x_m: float, alpha: float, k: int, n: int) -> float:
    """Eq. (28): E[L_(k:n)] (k-th smallest of n Pareto samples — the coded
    makespan when any k of n responses reconstruct).  Standard identity
    E = x_m · Γ(n+1)Γ(n−k+1−1/α) / (Γ(n−k+1)Γ(n+1−1/α)); the appendix's
    printed form garbles the Γ arguments (repro note).  Requires
    n−k+1 > 1/α for a finite mean."""
    require_alpha_gt1(alpha, "coded_order_stat")
    if n - k + 1 <= 1 / alpha:
        return math.inf
    return x_m * math.exp(gammaln(n + 1) + gammaln(n - k + 1 - 1 / alpha)
                          - gammaln(n - k + 1) - gammaln(n + 1 - 1 / alpha))


# --------------------------------------------------------------- Table 12 --

def table12(x_m: float = 1.0, device_counts=(100, 1000)):
    rows = []
    for name, alpha in (("Exponential", None), ("Pareto 3", 3.0),
                        ("Pareto 2", 2.0), ("Pareto 1.5", 1.5)):
        row = {"distribution": name}
        for D in device_counts:
            if alpha is None:
                row[f"D={D}"] = expected_max_exponential(x_m, D)
            else:
                row[f"D={D}"] = expected_max(x_m, alpha, D)
        rows.append(row)
    return rows


# ----------------------------------------------- heterogeneity (Appendix B) --

def hetero_penalty(T_homo: float, cv: float, D: int,
                   fine_grained: bool = True) -> float:
    """Eq. (19): E[T_hetero] ≈ T_homo (1 + c_v²/2 · g(D)); g(D)=1/√D for
    row-column-granular CLEAVE, g(D)=1 for layer-granular baselines."""
    g = 1.0 / math.sqrt(D) if fine_grained else 1.0
    return T_homo * (1.0 + cv * cv / 2.0 * g)


def optimal_device_count(w_gemm: float, l_median: float, w_d: float,
                         alpha: float) -> float:
    """Eq. (29): D* ≈ (W_GEMM / (L_median · W_d))^{α/(α+1)}."""
    return (w_gemm / (l_median * w_d)) ** (alpha / (alpha + 1.0))
