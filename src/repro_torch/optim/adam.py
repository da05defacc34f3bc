"""AdamW with PS-offload semantics, over nested dicts of tensors (port of
``src/repro/optim/adam.py``).  On a mesh the leaves are DTensors: each
rank updates its own shards (the moments' layout, which may add a ZeRO
'pod' shard to the param's), and the global norm sums every shard once.

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
from repro_torch.parallel.sharding import is_dtensor


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


# elements of a leaf that the donated update and its norm touch at once
SLICE = 1 << 23


def _slices(t: torch.Tensor) -> list:
    """Views that tile ``t`` along its leading axes, each of at most
    :data:`SLICE` elements where one index of the axis allows: runs of
    rows of a 2-D leaf, one expert of a stacked (L, E, d, ff) one."""
    if t.dim() == 0 or t.numel() <= SLICE:
        return [t]
    row = t[0].numel()
    if row > SLICE:
        return [s for i in range(t.shape[0]) for s in _slices(t[i])]
    n = SLICE // row
    return [t[i:i + n] for i in range(0, t.shape[0], n)]


def global_norm(grads, *, sliced: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in f32; with
    ``sliced`` slice by slice (:func:`_slices`), so that an f32 copy of a
    slice, not of a whole bf16 leaf, exists at a time."""
    parts = (s for g in T.leaves(grads)
             for s in (_slices(g) if sliced and not is_dtensor(g) else (g,)))
    return torch.sqrt(sum(_sum_sq(s) for s in parts))


def _sum_sq(s):
    q = torch.sum(torch.square(s.to(torch.float32)))
    # a DTensor's sum is pending over its shards: reduce it
    return q.full_tensor() if is_dtensor(q) else q


def apply(params, grads, state: AdamState, cfg: AdamConfig = AdamConfig(),
          *, donate: bool = False):
    """Returns ``(new_params, new_state, metrics)``.

    With ``donate=False`` the inputs are not modified, as in the
    reference: each leaf is updated whole into new tensors, and the caller
    holds the old tree beside the new one until it drops the old (at
    llama3-8b's width with 4 layers, 1.92 B params, a fleet step then
    peaks at 44 GB: ``chip_smoke.py`` train_full,
    ``torch.cuda.max_memory_allocated`` on an H100).  Each leaf's
    temporaries are freed before the next leaf, so the peak adds a few
    temporaries of the largest leaf, not of the whole tree.

    With ``donate=True`` params, ``mu`` and ``nu`` are updated in place
    and returned, as the reference's monolithic step donates its params
    and optimizer state (``donate_argnums=(0, 1)``): a full-width
    deepseek-v2-236b layer (5.0 B params with the embedding and head)
    would need about 110 GB out of place.  The update and the norm then
    go slice by slice (:func:`_slices`), so the temporaries are one
    slice's: one expert's 7.9 M elements, not the 1.26 B of a stacked
    ``w_gate``.  The update is elementwise, so both modes give the same
    values bit for bit where no leaf exceeds :data:`SLICE` elements;
    above it the norm sums the leaf's squares in another order."""
    step = state.step + 1
    gnorm = global_norm(grads, sliced=donate)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0) \
        if cfg.grad_clip else None
    lr = float(lr_schedule(cfg, step))
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))

    def upd(p, g, m, v):
        # new tensors, or p, m, v themselves when donated
        g = g.to(torch.float32, copy=True)
        if scale is not None:
            g.mul_(scale)
        m = (m.mul_ if donate else m.mul)(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v = (v.mul_ if donate else v.mul)(cfg.b2).addcmul_(
            g, g, value=1 - cfg.b2)
        del g
        u = v.div(b2c).sqrt_().add_(cfg.eps)
        u = m.div(b1c).div_(u)
        p32 = p.to(torch.float32, copy=True)
        u.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(u, alpha=lr)
        return (p.copy_(p32) if donate else p32.to(p.dtype)), m, v

    keys = T.paths(params)
    leaves = list(zip(T.leaves(params), T.leaves(grads),
                      T.leaves(state.mu), T.leaves(state.nu)))
    if donate:
        for leaf in leaves:
            if is_dtensor(leaf[0]):
                _upd_sharded(upd, *leaf, donate=True)
                continue
            for sl in zip(*(_slices(t) for t in leaf)):
                upd(*sl)
        out = [(p, m, v) for p, _, m, v in leaves]
    else:
        out = [_upd_sharded(upd, *leaf, donate=False) if is_dtensor(leaf[0])
               else upd(*leaf) for leaf in leaves]
    new_p = T.unflatten(keys, [o[0] for o in out])
    new_m = T.unflatten(keys, [o[1] for o in out])
    new_v = T.unflatten(keys, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": torch.as_tensor(lr)}
    return new_p, AdamState(step=step, mu=new_m, nu=new_v), metrics


def _upd_sharded(upd, p, g, m, v, *, donate):
    """``upd`` on one DTensor leaf, rank by rank in the moments' layout:
    the gradient and the param are brought to it (a local slice where
    the moments add a 'pod' shard), the elementwise update runs on the
    local shards, and the new param goes back to its own layout (an
    all-gather over 'pod').  With ``donate`` p, m and v are updated in
    place."""
    from torch.distributed.tensor import DTensor
    mesh, mpl = m.device_mesh, tuple(m.placements)
    g_l = g.redistribute(mesh, mpl).to_local()
    same = tuple(p.placements) == mpl
    p_m = p if same else p.redistribute(mesh, mpl)
    p_l = p_m.to_local()
    m_l, v_l = m.to_local(), v.to_local()
    np_l, nm_l, nv_l = upd(p_l if (same or not donate) else p_l.clone(),
                           g_l, m_l, v_l)

    def wrap(t, like, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=like.shape, stride=like.stride())
    new_p = wrap(np_l, p, mpl)
    if not same:
        new_p = new_p.redistribute(mesh, tuple(p.placements))
        if donate:
            p.to_local().copy_(new_p.to_local())
            new_p = p
    if donate:
        return p, m, v
    return new_p, wrap(nm_l, m, mpl), wrap(nv_l, v, mpl)
