"""DiLoCo-hybrid outer optimizer (§2.4), over nested dicts of tensors (port
of ``src/repro/optim/diloco.py``).

Inner loop: H local AdamW steps per worker group (each group itself running
CLEAVE sub-GEMM sharding internally).  Outer loop: the PS applies Nesterov
momentum to the pseudo-gradient Δ = θ_start − mean_g(θ_g^H).

The reference relies on JAX arrays being immutable; torch tensors are not,
and ``.to(torch.float32)`` of an f32 tensor returns the tensor itself.  So
the anchor is always a copy of the params, a round's new params are never
the new anchor, and :func:`outer_step_sharded` with ``donate=True`` (the
in-place round of a session that owns its state) overwrites only the
state and the group replicas it was given.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from repro_torch import tree as T


@dataclass(frozen=True)
class DiLoCoConfig:
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    inner_steps: int = 50          # H


class OuterState(NamedTuple):
    velocity: dict                 # Nesterov momentum buffer
    anchor: dict                   # θ at the start of the round


def outer_init(params) -> OuterState:
    z = T.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params)
    a = T.map_tree(lambda p: p.to(torch.float32, copy=True), params)
    return OuterState(velocity=z, anchor=a)


def _outer_leaf(a, v, gs, cfg: DiLoCoConfig, donate: bool):
    """One leaf of the outer round: the reference's ``mean``, ``delta``,
    ``vel`` and ``new`` in its order of operations.  Returns ``(vel, new,
    params)``: new tensors, the params in the groups' type (never the
    anchor itself); or, with ``donate``, ``v`` and ``a`` updated in place
    and the params written into every group's replica ``gs``."""
    mean = gs[0].to(torch.float32, copy=True)
    for g in gs[1:]:
        mean.add_(g.to(torch.float32))
    mean.div_(float(len(gs)))
    delta = mean.neg_().add_(a)                  # a - mean, bit for bit
    vel = (v.mul_ if donate else v.mul)(cfg.outer_momentum).add_(delta)
    step = vel.mul(cfg.outer_momentum).add_(delta).mul_(cfg.outer_lr)
    if not donate:
        new = a.sub(step)
        return vel, new, new.to(gs[0].dtype, copy=True)
    new = a.sub_(step)
    for g in gs:
        g.copy_(new)
    return vel, new, gs[0]


def outer_step(state: OuterState, group_params: Sequence,
               cfg: DiLoCoConfig = DiLoCoConfig()):
    """Average the groups' drifted parameters, form the pseudo-gradient,
    apply Nesterov momentum, return (new_params, new_state)."""
    keys = T.paths(group_params[0])
    g_leaves = [T.leaves(g) for g in group_params]
    out = [_outer_leaf(a, v, [g[i] for g in g_leaves], cfg, False)
           for i, (a, v) in enumerate(zip(T.leaves(state.anchor),
                                          T.leaves(state.velocity)))]
    return T.unflatten(keys, [o[2] for o in out]), OuterState(
        velocity=T.unflatten(keys, [o[0] for o in out]),
        anchor=T.unflatten(keys, [o[1] for o in out]))


def communication_per_round(n_params: float, inner_steps: int,
                            bytes_per_el: int = 2) -> dict:
    """Per-device per-round traffic: synchronous CLEAVE exchanges gradients
    every step; DiLoCo-hybrid exchanges parameters once per H steps."""
    sync = inner_steps * n_params * bytes_per_el
    diloco = 2 * n_params * bytes_per_el      # pull new θ + push local θ
    return {"sync_bytes": sync, "diloco_bytes": diloco,
            "reduction_x": sync / diloco}


# ------------------------------------------------- PS-sharded outer state --

class ParamPartition(NamedTuple):
    """Leaf-wise assignment of the parameter tree to K PS shards: shard k
    *owns* its leaves' outer state (anchor + velocity) and reduces them at
    round boundaries.  The outer update is elementwise per leaf, so the
    sharded round is numerically identical to the monolithic one — the
    partition only decides *where* each reduction happens and therefore
    what crosses the PS-to-PS links."""
    shard_of: tuple                # leaf index -> owning shard
    shard_bytes: tuple             # per-shard owned bytes
    n_shards: int


def partition_params(params, n_shards: int) -> ParamPartition:
    """Greedy size-balanced leaf assignment over the sorted-key leaf order
    (``tree.leaves``, as ``jax.tree.leaves`` orders a dict): largest
    leaves first onto the lightest shard, deterministic for a given
    tree."""
    leaves = T.leaves(params)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    sizes = [float(l.numel() * l.element_size()) for l in leaves]
    shard_of = [0] * len(leaves)
    loads = [0.0] * n_shards
    for i in sorted(range(len(leaves)), key=lambda i: (-sizes[i], i)):
        k = min(range(n_shards), key=lambda j: (loads[j], j))
        shard_of[i] = k
        loads[k] += sizes[i]
    return ParamPartition(shard_of=tuple(shard_of),
                          shard_bytes=tuple(loads), n_shards=n_shards)


def sync_traffic(part: ParamPartition, n_islands: int = None) -> dict:
    """Cross-PS traffic of one sharded outer round: every island PS sends
    its local copy of shard k to its owner (reduce) and receives the
    updated shard back (gather), so PS k moves
    ``(K-1)·P_k + (T-P_k)`` bytes each way.  For equal partitions this is
    the familiar ``2·(K-1)/K·T`` all-reduce volume per PS."""
    k_i = n_islands if n_islands is not None else part.n_shards
    total = float(sum(part.shard_bytes))
    per_ps = [float((k_i - 1) * p + (total - p)) for p in part.shard_bytes]
    return {"per_ps_bytes": per_ps, "total_bytes": float(sum(per_ps)),
            "param_bytes": total}


def outer_step_sharded(state: OuterState, group_params: Sequence,
                       part: ParamPartition,
                       cfg: DiLoCoConfig = DiLoCoConfig(), *,
                       donate: bool = False):
    """The PS-sharded outer round: each shard applies :func:`outer_step`'s
    elementwise update to the leaves it owns, then the updated shards
    all-gather back onto every island.  Returns
    ``(new_params, new_state, traffic)``, bit-identical to
    :func:`outer_step` (the same per-leaf arithmetic), with ``traffic``
    from :func:`sync_traffic` for this partition.

    With ``donate`` the round runs in place: the state's velocity and
    anchor take their new values, every group's replica takes the new
    params, and the returned trees hold those tensors (``new_params`` is
    ``group_params[0]``'s).  The temporaries are one leaf's."""
    keys = T.paths(group_params[0])
    n_leaves = len(keys)
    if len(part.shard_of) != n_leaves:
        raise ValueError(
            f"partition covers {len(part.shard_of)} leaves, params have "
            f"{n_leaves} — repartition after any arch change")
    g_leaves = [T.leaves(g) for g in group_params]
    v_leaves = T.leaves(state.velocity)
    a_leaves = T.leaves(state.anchor)
    new_p = [None] * n_leaves
    new_v = [None] * n_leaves
    new_anchor = [None] * n_leaves
    for k in range(part.n_shards):
        for i in (j for j in range(n_leaves) if part.shard_of[j] == k):
            new_v[i], new_anchor[i], new_p[i] = _outer_leaf(
                a_leaves[i], v_leaves[i], [g[i] for g in g_leaves], cfg,
                donate)
    traffic = sync_traffic(part, n_islands=len(group_params))
    return (T.unflatten(keys, new_p),
            OuterState(velocity=T.unflatten(keys, new_v),
                       anchor=T.unflatten(keys, new_anchor)),
            traffic)
