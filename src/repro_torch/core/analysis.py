"""Closed-form communication-volume analysis (Appendix A).

Per-device volumes for conventional 3D parallelism (Eq. 8) vs CLEAVE
(§A.2), the crossover conditions (Eq. 7/9), and the pipeline/makespan
refinements (Eq. 9'–11).  Variables follow Megatron convention (Table 11):
a heads, b_mu microbatch, h hidden, p pipeline size, H intermediate,
s sequence, t tensor size, B batch, L layers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelDims:
    h: int          # hidden
    H: int          # intermediate (MLP)
    L: int          # layers
    s: int          # sequence length
    B: int          # global batch
    b_mu: int = 2   # microbatch
    bytes_per_el: int = 2

    @property
    def params_per_layer(self):
        return 4 * self.h * self.h + 3 * self.h * self.H

    @property
    def n_params(self):
        return self.params_per_layer * self.L


def baseline_3d_volume(dims: ModelDims, t: int, p: int,
                       per_layer_tp: bool = True) -> float:
    """Eq. (8): per-device communication volume (elements) for DP+PP+TP.

    With `per_layer_tp` (physical accounting, §2.3/Fig 1: "AllReduce and
    AlltoAll at each layer in both propagation directions"), the TP term is
    4·B·s·h per layer; Eq. (8) as printed drops the L factor — both modes are
    provided so the appendix inequality can be checked as stated while the
    simulator uses the physical volume."""
    v = dims.params_per_layer * dims.L / max(t, 1)
    if p > 1:
        v += 2 * dims.B * dims.s * dims.h
    if t > 1:
        tp = 4 * dims.B * dims.s * dims.h
        v += tp * (dims.L if per_layer_tp else 1)
    return v * dims.bytes_per_el


def dp_allreduce_volume(dims: ModelDims) -> float:
    """DP gradient AllReduce per device per batch (§A.1)."""
    return dims.n_params * dims.bytes_per_el


def cleave_volume(dims: ModelDims, D: int) -> dict:
    """§A.2: CLEAVE total (and per-device) DL/UL communication per batch.

    DL: weights + both GEMM inputs per layer (QKVO: 8Bsh² -> weight h×h rows
    + activation Bs×h; MLP: 18BshH-equivalent terms), attention s² term.
    UL: partial output blocks == model params + intermediates + activations.
    Per-device volume is total / D — the decreasing-in-D behavior.
    """
    h, H, Lr, s, B = dims.h, dims.H, dims.L, dims.s, dims.B
    be = dims.bytes_per_el
    # Activation rows (A matrices) + weight columns (B matrices), fwd+bwd:
    dl_total = ((8 * B * s * h + 18 * B * s * H) * Lr        # activations
                + 2 * (4 * h * h + 3 * h * H) * Lr           # weights (fwd+bwd)
                + 4 * B * s * s * Lr)                        # attention scores
    ul_total = ((4 * h * h + 3 * h * H) * Lr                 # grads, once
                + B * s * h * Lr                             # intermediates
                + (2 * B * s * H + 5 * B * s * h + B * s * s) * Lr)
    return {
        "dl_total": dl_total * be,
        "ul_total": ul_total * be,
        "dl_per_device": dl_total * be / D,
        "ul_per_device": ul_total * be / D,
        "per_device": (dl_total + ul_total) * be / D,
    }


def crossover_downlink(dims: ModelDims, t: int) -> float:
    """Eq. (7): CLEAVE beats baselines on DL volume when
    D > 3(80+4s)L / (16h/(tBs) + 4)."""
    h, s, B, Lr = dims.h, dims.s, dims.B, dims.L
    return 3 * (80 + 4 * s) * Lr / (16 * h / (t * B * s) + 4)


def crossover_uplink(dims: ModelDims, t: int) -> float:
    """Eq. (9): D > (8h/(Bs) + 13 + s)L / (8h/(tBs) + 2)."""
    h, s, B, Lr = dims.h, dims.s, dims.B, dims.L
    return (8 * h / (B * s) + 13 + s) * Lr / (8 * h / (t * B * s) + 2)


def pipeline_time(t_dl: float, t_comp: float, t_ul: float, k: int) -> float:
    """Eq. (9'): streaming pipeline over k row-column pairs."""
    return t_dl + (k - 1) * max(t_dl, t_comp, t_ul) + t_comp + t_ul


def allreduce_latency(alpha: float, D: int, beta: float = 0.0,
                      volume: float = 0.0, bw: float = 1.0) -> float:
    """Ring AllReduce latency model O(α·log2 D) + bandwidth term (§A.3)."""
    return alpha * math.ceil(math.log2(max(D, 2))) + beta * volume / bw


def tightened_crossover(S: int, t_pipeline: float, alpha: float, beta: float,
                        v_baseline: float, w_d: float, D: int) -> bool:
    """Eq. (11): CLEAVE wins when D > S·T_pipe / (α⌈log2 D⌉ + β·V/W_d)."""
    denom = alpha * math.ceil(math.log2(max(D, 2))) + beta * v_baseline / w_d
    return D > S * t_pipeline / max(denom, 1e-12)
