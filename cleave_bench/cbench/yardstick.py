"""The yardstick: one H100's published peaks (NVIDIA's data sheet, SXM,
dense, at 700 W) and the arithmetic of operations and bytes.  A copy of
the port's bound (``chip_smoke.py``: bytes once over the memory rate or
operations over the rate, the larger), kept here so that it does not
move with the program."""
from __future__ import annotations

from typing import Dict, Iterable

PEAK_BF16 = 989e12          # FLOP/s
PEAK_BW = 3.35e12           # bytes/s


def step_flops(family, config: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per parameter a token
    multiplies by, per token, plus three times the forward FLOPs of the
    sequence mixer's products (attention's scores and values, or the
    WKV recurrence's); a recompute is not counted."""
    tokens = batch * seq
    return (6.0 * family.matmul_params(config) * tokens
            + 3.0 * family.mixer_flops(config, batch, seq))


def gemm_least_s(m: int, n: int, q: int, b: int) -> float:
    """Least time of C (m x q, f32) = A (m x n) B (n x q), operands of b
    bytes: the larger of its operations over the bf16 rate and its bytes,
    each operand read once and the product written once, over the memory
    rate."""
    ops = 2.0 * m * n * q / PEAK_BF16
    nbytes = ((m * n + n * q) * b + m * q * 4) / PEAK_BW
    return max(ops, nbytes)


def gemms_least_s(records: Iterable) -> float:
    return sum(gemm_least_s(r.m, r.n, r.q, r.b) for r in records)
