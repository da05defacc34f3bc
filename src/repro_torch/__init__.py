"""PyTorch/CUDA port of the CLEAVE reproduction (``src/repro``), for one
NVIDIA H100.

The port imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``: the framework-neutral numpy modules (planner, churn recovery,
Freivalds oracle, pricing engine, configs, batcher) are kept here as
copies with only their imports rewritten.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; on a host without
CUDA a default-device call raises instead of falling back.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and this
    host has no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the port's plain CPU path")
    return dev


def ieee_f32() -> None:
    """Keep every f32 matrix product on the card in IEEE f32 (no TF32):
    the f32 policy's Freivalds tolerance and the parity checks need it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
