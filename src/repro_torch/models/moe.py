"""Mixture-of-Experts FFN: top-k router and sort-based capacity dispatch
(port of ``src/repro/models/moe.py``, its global path).

Flatten the (token, k) assignments, sort them by expert id (stable),
number each assignment within its expert, scatter the kept ones into an
(E·C, d) buffer (over-capacity assignments land in a drop row, E·C, which
is cut off), run the per-expert SwiGLU as three batched products on the
batched block GEMM (``kernels.ops.expert_matmul``), and scatter-add the
weighted outputs back to their tokens.  Returns the Switch-style
load-balancing loss beside the output.

Under a mesh (``parallel.sharding`` rules active on DTensor inputs) the
dispatch runs on each rank's block (:func:`_moe_block_sharded`, the
reference's shard_map expert parallelism): tokens stay on their batch
shards, experts are partitioned over 'model', and the outputs combine
with a reduce-scatter.  Without one the global path runs.

Routing matches the reference's choices exactly where the probabilities
do: ``torch.topk(sorted=True)`` gives ``jax.lax.top_k``'s descending
order (ties to the lower index), the stable ``argsort`` keeps
``jnp.argsort``'s order within an expert, so the same assignments pass
the capacity cut.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spans import span
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (axis_names, axis_sizes,
                                           batch_axes, constrain,
                                           current_rules, is_dtensor)


def init_moe(cfg, gen, lead=()):
    """Router (d, E) in float32 whatever ``param_dtype`` is, as in the
    reference; w_gate, w_up (E, d, ff) and w_down (E, ff, d) in
    ``param_dtype``; ``lead`` prepends axes to every leaf."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = L.pdtype_of(cfg)
    lead = tuple(lead)
    p = {
        "router": L.dense_init(gen, d, E, torch.float32, lead=lead),
        "w_gate": L.normal(gen, lead + (E, d, ff), 1 / np.sqrt(d), dt),
        "w_up": L.normal(gen, lead + (E, d, ff), 1 / np.sqrt(d), dt),
        "w_down": L.normal(gen, lead + (E, ff, d), 1 / np.sqrt(ff), dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, cfg.n_shared_experts * ff, dt,
                                    lead)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` routed tokens (at least 4)."""
    c = int(np.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                    / cfg.n_experts))
    return max(c, 4)


def route(cfg, router, xt):
    """Top-k routing of the tokens xt (T, d): the router is an f32
    projection (``pdot``: lowered onto the fleet inside a session), then
    softmax, top-k and renormalisation.  Returns ``(probs (T, E), top_p
    (T, k) renormalised, top_e (T, k) expert ids)``."""
    logits = L.pdot(xt.float(), router)                      # (T, E)
    with span("moe.dispatch"):
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return probs, top_p, top_e


def moe_block(cfg, p, x):
    """x: (B,S,d) -> (out (B,S,d) in x's dtype, aux_loss f32 scalar).

    Under a mesh (DTensor x, rules active) every rank runs
    :func:`_moe_block_sharded` on its block, which needs 'model' to divide
    the experts; without one the global path below runs."""
    rules = current_rules()
    if is_dtensor(x) and rules is not None \
            and "model" in axis_names(rules.mesh):
        n_model = axis_sizes(rules.mesh)["model"]
        if cfg.n_experts % n_model:
            raise NotImplementedError(
                f"{cfg.n_experts} experts do not divide over the mesh's "
                f"{n_model} 'model' shards")
        return _moe_block_sharded(cfg, p, x, rules)
    return _moe_block_global(cfg, p, x)


def _moe_block_global(cfg, p, x):
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    dev = x.device

    probs, top_p, top_e = route(cfg, p["router"], xt)
    with span("moe.dispatch"):
        # Switch-style load balance; the one-hot carries no gradient
        me = torch.mean(probs, dim=0)
        ce = torch.mean(torch.nn.functional.one_hot(top_e[:, 0], E).float(),
                        dim=0)
        aux = cfg.router_aux_coef * E * torch.sum(me * ce)

        # sort-based dispatch: row E*C is the drop bin, cut off below
        TK = T * k
        flat_e = top_e.reshape(TK)
        flat_w = top_p.reshape(TK)
        tok_id = torch.arange(T, device=dev).repeat_interleave(k)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        counts = torch.bincount(flat_e, minlength=E)
        starts = torch.cumsum(counts, 0) - counts
        pos_in_e = torch.arange(TK, device=dev) - starts[sorted_e]
        keep = pos_in_e < C
        slot = torch.where(keep, sorted_e * C + pos_in_e,
                           torch.full_like(pos_in_e, E * C))
        src_tok = tok_id[order]
        # out of place: the drop row's gradient is cut off with the row, so
        # dropped assignments get none, as under the reference's .at[].set
        buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
        buf = buf.index_put((slot,), xt[src_tok])
        buf = buf[:-1].reshape(E, C, d)
        buf = constrain(buf, "experts", None, "embed")

    # the experts: batched SwiGLU on the batched block GEMM
    g = ops.expert_matmul(buf, p["w_gate"])
    u = ops.expert_matmul(buf, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    h = constrain(h, "experts", None, "ffn")
    eo = ops.expert_matmul(h, p["w_down"])
    eo = constrain(eo, "experts", None, "embed").reshape(E * C, d)

    with span("moe.dispatch"):
        gathered = torch.where(keep[:, None],
                               eo[torch.clamp(slot, max=E * C - 1)],
                               torch.zeros((), dtype=eo.dtype, device=dev))
        weighted = gathered * flat_w[order][:, None].to(x.dtype)
        # sums in x's dtype, as the reference's .at[tok].add; on the card
        # index_add sums with atomics, in an order that varies by run
        out = torch.zeros((T, d), dtype=x.dtype, device=dev) \
            .index_add(0, src_tok, weighted)

    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], x).reshape(T, d)
    return out.reshape(B, S, d), aux


def _moe_block_sharded(cfg, p, x, rules):
    """Expert-parallel MoE on each rank's block: tokens stay on their
    (pod, data) shards, the experts are partitioned over 'model'.  A batch
    that the batch axes do not divide (long_500k's single request) stays
    whole on every batch shard, which then routes all its tokens at the
    global path's capacity, as the reference's global path does.  A rank
    gathers its tokens' features over 'model' (when d shards), routes
    them, averages the load-balance statistics over the batch axes,
    dispatches to its E / n_model experts by the same sort as the global
    path, runs them on the batched block GEMM, and reduce-scatters the
    f32 sums over 'model' (an all-reduce when d does not shard)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import placements

    mesh = rules.mesh
    baxes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n_model = sizes["model"]
    E, k = cfg.n_experts, cfg.moe_top_k
    E_loc = E // n_model
    B, S, d = x.shape
    n_batch = int(np.prod([sizes[a] for a in baxes]))
    rows = baxes if B % n_batch == 0 else None
    T_loc = (B // n_batch if rows else B) * S
    C = capacity(cfg, T_loc)
    d_shard = d % n_model == 0

    def local(x_blk, router, wg, wu, wd):
        x_full = spmd.all_gather(x_blk, mesh, "model", 2) if d_shard \
            else x_blk
        xt = x_full.reshape(T_loc, d)
        dev = xt.device
        probs, top_p, top_e = route(cfg, router, xt)
        with span("moe.dispatch"):
            me = torch.mean(probs, dim=0)
            ce = torch.mean(torch.nn.functional.one_hot(top_e[:, 0], E)
                            .float(), dim=0)
            me = spmd.pmean(me, mesh, baxes)
            ce = spmd.pmean(ce, mesh, baxes)
            aux = cfg.router_aux_coef * E * torch.sum(me * ce)

            # local sort-based dispatch, keeping only this rank's experts
            TK = T_loc * k
            e0 = spmd.axis_index(mesh, "model") * E_loc
            flat_e = top_e.reshape(TK)
            flat_w = top_p.reshape(TK)
            tok_id = torch.arange(T_loc, device=dev).repeat_interleave(k)
            order = torch.argsort(flat_e, stable=True)
            sorted_e = flat_e[order]
            # bincount's counts, at a shape that does not depend on the
            # ids (the dry run traces this under FakeTensorMode)
            counts = torch.zeros(E, dtype=flat_e.dtype, device=dev) \
                .scatter_add_(0, flat_e, torch.ones_like(flat_e))
            starts = torch.cumsum(counts, 0) - counts
            pos_in_e = torch.arange(TK, device=dev) - starts[sorted_e]
            local_e = sorted_e - e0
            keep = (pos_in_e < C) & (local_e >= 0) & (local_e < E_loc)
            slot = torch.where(keep, local_e * C + pos_in_e,
                               torch.full_like(pos_in_e, E_loc * C))
            src_tok = tok_id[order]
            buf = torch.zeros((E_loc * C + 1, d), dtype=x_blk.dtype,
                              device=dev)
            buf = buf.index_put((slot,), xt[src_tok])
            buf = buf[:-1].reshape(E_loc, C, d)

        g = ops.expert_matmul(buf, wg)
        u = ops.expert_matmul(buf, wu)
        h = torch.nn.functional.silu(g.float()).to(x_blk.dtype) * u
        eo = ops.expert_matmul(h, wd).reshape(E_loc * C, d)

        with span("moe.dispatch"):
            gathered = torch.where(
                keep[:, None], eo[torch.clamp(slot, max=E_loc * C - 1)],
                torch.zeros((), dtype=eo.dtype, device=dev))
            weighted = gathered * flat_w[order][:, None].to(x_blk.dtype)
            out = torch.zeros((T_loc, d), dtype=torch.float32, device=dev) \
                .index_add(0, src_tok, weighted.float())
        if d_shard:
            out = spmd.reduce_scatter(out, mesh, "model", 1)
        else:
            out = spmd.psum(out, mesh, "model")
        return out.to(x_blk.dtype).reshape(x_blk.shape), aux

    x_spec = (rows, None, "model" if d_shard else None)
    xp = placements(x_spec, mesh)
    ep = tuple(Shard(0) if a == "model" else Replicate()
               for a in axis_names(mesh))
    rep = (Replicate(),) * len(ep)
    out, aux = spmd.region(local, mesh, (xp, rep, ep, ep, ep), [xp, rep],
                           [tuple(x.shape), ()])(
        x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], x)
    return out, aux
