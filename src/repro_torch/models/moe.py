"""Mixture-of-Experts FFN: top-k router and sort-based capacity dispatch
(port of ``src/repro/models/moe.py``, its global path).

Flatten the (token, k) assignments, sort them by expert id (stable),
number each assignment within its expert, scatter the kept ones into an
(E·C, d) buffer (over-capacity assignments land in a drop row, E·C, which
is cut off), run the per-expert SwiGLU as three batched products on the
batched block GEMM (``kernels.ops.expert_matmul``), and scatter-add the
weighted outputs back to their tokens.  Returns the Switch-style
load-balancing loss beside the output.

The reference's ``_moe_block_sharded`` (shard_map expert parallelism:
tokens on their data shards, experts over the 'model' axis) waits for the
port's mesh layer (ROADMAP A.7); ``moe_block`` here is its global path,
which the reference also runs without a mesh.

Routing matches the reference's choices exactly where the probabilities
do: ``torch.topk(sorted=True)`` gives ``jax.lax.top_k``'s descending
order (ties to the lower index), the stable ``argsort`` keeps
``jnp.argsort``'s order within an expert, so the same assignments pass
the capacity cut.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L


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
    with torch.profiler.record_function("moe.dispatch"):
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return probs, top_p, top_e


def moe_block(cfg, p, x):
    """x: (B,S,d) -> (out (B,S,d) in x's dtype, aux_loss f32 scalar)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    dev = x.device

    probs, top_p, top_e = route(cfg, p["router"], xt)
    with torch.profiler.record_function("moe.dispatch"):
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

    # the experts: batched SwiGLU on the batched block GEMM
    g = ops.expert_matmul(buf, p["w_gate"])
    u = ops.expert_matmul(buf, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    eo = ops.expert_matmul(h, p["w_down"]).reshape(E * C, d)

    with torch.profiler.record_function("moe.dispatch"):
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
