"""AdamW with PS-offload semantics, over nested dicts of tensors (port of
``src/repro/optim/adam.py``; the mesh ``constrain`` calls stay out until
the mesh layer is ported).

The paper keeps the optimizer state on the PS (bf16 weights and grads,
f32 moments); here the PS is the card, and the moments are f32 tensors
beside the params.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch import tree as T


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the host (the lr schedule's)
    mu: dict
    nu: dict


def init(params, cfg: AdamConfig = AdamConfig()) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamState(step=torch.zeros((), dtype=torch.int32),
                     mu=T.map_tree(zeros, params),
                     nu=T.map_tree(zeros, params))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_schedule(cfg: AdamConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32 as the
    reference computes it."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in T.leaves(grads)))


def apply(params, grads, state: AdamState, cfg: AdamConfig = AdamConfig()):
    """Returns ``(new_params, new_state, metrics)``; the inputs are not
    modified, as in the reference.

    Out of place, the update holds the caller's params and moments beside
    the new ones until the caller drops the old; at llama3-8b's width with
    4 layers (1.92 B params) a fleet step then peaks at 44 GB
    (``chip_smoke.py`` train_full, ``torch.cuda.max_memory_allocated`` on
    an H100), which fits one card, so the port keeps the reference's
    semantics.  Each leaf's temporaries are updated in place and freed
    before the next leaf, so the peak adds a few temporaries of the
    largest leaf (the 128256 x 4096 embedding, 2.1 GB in f32), not of the
    whole tree."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0) \
        if cfg.grad_clip else None
    lr = float(lr_schedule(cfg, step))
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))

    def upd(p, g, m, v):
        g = g.to(torch.float32, copy=True)
        if scale is not None:
            g.mul_(scale)
        m = m.mul(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v = v.mul(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        u = v.div(b2c).sqrt_().add_(cfg.eps)
        u = m.div(b1c).div_(u)
        p32 = p.to(torch.float32, copy=True)
        u.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(u, alpha=lr)
        return p32.to(p.dtype), m, v

    keys = T.paths(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        T.leaves(params), T.leaves(grads), T.leaves(state.mu),
        T.leaves(state.nu))]
    new_p = T.unflatten(keys, [o[0] for o in out])
    new_m = T.unflatten(keys, [o[1] for o in out])
    new_v = T.unflatten(keys, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": torch.as_tensor(lr)}
    return new_p, AdamState(step=step, mu=new_m, nu=new_v), metrics
