"""The port's step functions (port of ``src/repro/launch/steps.py``):
``make_train_step``, ``make_eval_step``, ``make_prefill_step`` and
``make_serve_step``, each running inside the mesh's ``use_rules`` when
given rules, and ``step_and_specs``, which places a step's inputs.

Every projection GEMM is a plain ``torch.matmul``, as the reference leaves
them to XLA; the fleet step (``train_loop.FleetTrainSession``) is held
against the monolithic one.  On a mesh the params, moments and inputs
are DTensors (``launch.specs``) and the model's ``constrain`` calls lay
out the activations; without rules every path runs as on one device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import ieee_f32
from repro_torch import tree as T
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.parallel.sharding import (Rules, axis_sizes, batch_axes,
                                           is_dtensor, make_rules,
                                           use_rules)


def _on_mesh(rules) -> bool:
    return rules is not None and rules.mesh is not None


def _microbatch(batch, i: int, n: int):
    """Microbatch ``i`` of ``n``: rows ``[i B/n, (i+1) B/n)`` of the
    global batch, contiguous as the reference's reshape takes them (MoE
    capacity depends on which tokens share a microbatch).  A DTensor
    leaf is gathered, cut and placed again on its batch shards."""
    out = {}
    for k, v in batch.items():
        if not is_dtensor(v):
            out[k] = torch.chunk(v, n)[i]
            continue
        from torch.distributed.tensor import distribute_tensor
        b = v.shape[0] // n
        part = v.full_tensor()[i * b:(i + 1) * b].contiguous()
        out[k] = distribute_tensor(part, v.device_mesh, v.placements,
                                   src_data_rank=None)
    return out


def _to_layout(grads, params):
    """Each gradient DTensor in its param's placements (pending sums
    reduced)."""
    def one(g, p):
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return T.map_tree(one, grads, params)


def full_metrics(metrics: dict) -> dict:
    """Metrics as plain tensors (a DTensor scalar read whole)."""
    return {k: (v.full_tensor() if is_dtensor(v) else v)
            for k, v in metrics.items()}


def make_train_step(cfg, opt_cfg: Optional[adam.AdamConfig] = None,
                    rules: Optional[Rules] = None, *, q_chunk=256,
                    k_chunk=512, loss_chunk=256, microbatches: int = 1,
                    donate: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    With ``microbatches > 1`` the global batch is split into contiguous
    chunks along its first axis and the gradients accumulate in f32
    (activation memory / microbatches).  ``donate`` updates the caller's
    params and moments in place (``adam.apply(donate=True)``), as the
    reference's driver jits the step with ``donate_argnums=(0, 1)``.
    With ``rules`` the step runs on the mesh: params, moments and batch
    are DTensors (``step_and_specs``), the gradients are reduced to their
    params' layout before the update, and the metrics come back whole."""
    opt_cfg = opt_cfg or adam.AdamConfig()
    chunks = dict(q_chunk=q_chunk, k_chunk=k_chunk, loss_chunk=loss_chunk)

    def train_step(params, opt_state, batch):
        # IEEE f32 products, as the fleet's f32 policy and XLA's CPU path
        ieee_f32()
        with use_rules(rules):
            if microbatches <= 1:
                (loss, metrics), grads = M.value_and_grad(cfg, params,
                                                          batch, **chunks)
                grads = _to_layout(grads, params)
            else:
                grads = T.map_tree(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                loss, ms = 0.0, []
                for i in range(microbatches):
                    (l, m), g = M.value_and_grad(
                        cfg, params, _microbatch(batch, i, microbatches),
                        **chunks)
                    grads = T.map_tree(torch.add, grads,
                                       _to_layout(g, params))
                    del g
                    loss = loss + l
                    ms.append(m)
                grads = T.map_tree(lambda g: g / microbatches, grads)
                loss = loss / microbatches
                metrics = {k: torch.mean(torch.stack(
                    [full_metrics(m)[k] for m in ms])) for k in ms[0]}
            params2, opt2, opt_metrics = adam.apply(
                params, grads, opt_state, opt_cfg, donate=donate)
            del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params2, opt2, full_metrics(metrics)

    return train_step


def make_eval_step(cfg, rules: Optional[Rules] = None, **chunks):
    """``step(params, batch) -> metrics`` (``loss_fn``'s, no gradient)."""
    def eval_step(params, batch):
        with torch.no_grad(), use_rules(rules):
            _, metrics = M.loss_fn(cfg, params, batch, **chunks)
        return full_metrics(metrics)

    return eval_step


def make_prefill_step(cfg, rules: Optional[Rules] = None, *, q_chunk=256,
                      k_chunk=512, cache_placements=None):
    """``step(params, batch) -> (last logits, cache)``.  On a mesh the
    cache's leaves leave the step in ``cache_placements`` ({name:
    placements}; ``step_and_specs`` gives the decode layout: batch on
    'data', sequence on 'model')."""
    def prefill_step(params, batch):
        with torch.no_grad(), use_rules(rules):
            logits, cache = M.prefill(cfg, params, batch, q_chunk=q_chunk,
                                      k_chunk=k_chunk)
        if cache_placements is not None:
            cache = _place_cache(cache, cache_placements, rules.mesh)
        return logits, cache

    return prefill_step


def _place_cache(cache, pls, mesh):
    """Every cache leaf a DTensor in ``pls[name]``: DTensors are
    redistributed, plain leaves (zeros) placed by local slicing; the
    position stays a plain scalar that every rank holds."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for name, t in cache.items():
        if name == "pos":
            out[name] = t
            continue
        pl = tuple(pls[name])
        if is_dtensor(t):
            out[name] = t if tuple(t.placements) == pl \
                else t.redistribute(mesh, pl)
        else:
            out[name] = distribute_tensor(t, mesh, pl, src_data_rank=None)
    return out


def make_serve_step(cfg, rules: Optional[Rules] = None):
    """One-token decode against the cache (the decode_32k / long_500k
    target): ``step(params, cache, tokens) -> (logits, cache)``."""
    def serve_step(params, cache, tokens):
        with torch.no_grad(), use_rules(rules):
            logits, cache = M.decode_step(cfg, params, cache, tokens)
        return logits, cache

    return serve_step


def default_microbatches(cfg, shape, rules: Optional[Rules] = None) -> int:
    """Grad-accumulation policy: keep the per-microbatch activation
    footprint roughly constant as models grow, capped so each microbatch
    still divides over the mesh's batch axes."""
    n = cfg.n_params()
    if n > 150e9:
        mb = 16
    elif n > 50e9:
        mb = 8
    elif n > 20e9:
        mb = 4
    elif n > 10e9:
        mb = 2
    else:
        mb = 1
    if _on_mesh(rules):
        sizes = axis_sizes(rules.mesh)
        shards = int(np.prod([sizes[a] for a in batch_axes(rules.mesh)]))
        mb = max(1, min(mb, shape.global_batch // shards))
    return mb


CHUNK_OVERRIDES = {
    # archs whose head counts don't shard over 16 mesh columns keep their
    # attention score chunks small (scores replicate across 'model')
    "hymba-1.5b": dict(q_chunk=64),
    "qwen1.5-32b": dict(q_chunk=128),
    "phi3-medium-14b": dict(q_chunk=128),
}


def step_and_specs(cfg, shape, rules: Optional[Rules] = None, *,
                   microbatches: Optional[int] = None,
                   kv_quant: bool = False, make_inputs=None,
                   donate: bool = True):
    """``(step, inputs, out_placements)`` for the given input shape.

    ``make_inputs(specs, rules)`` builds the step's inputs from their
    TensorSpecs (``specs`` a tuple: params and moments and batch for
    training, params and batch for prefill, params and cache and tokens
    for decode); without it the inputs are the specs themselves.  The
    output placements follow the reference's ``out_sh``: params and
    moments keep their input layout, and the prefill's cache leaves
    decode-sharded (batch on 'data', sequence on 'model')."""
    chunks = CHUNK_OVERRIDES.get(cfg.name, {})
    mesh_on = _on_mesh(rules)
    p = SP.param_specs(cfg, rules)
    if shape.kind == "train":
        mb = (default_microbatches(cfg, shape, rules)
              if microbatches is None else microbatches)
        fn = make_train_step(cfg, rules=rules, microbatches=mb,
                             donate=donate, **chunks)
        o = SP.opt_specs(p, rules)
        b = SP.input_specs(cfg, shape, rules)
        specs = (p, o, b)
        out = (SP.spec_tree(p), SP.spec_tree(o.mu), None) if mesh_on \
            else None
    elif shape.kind == "prefill":
        cache_pl = None
        out = None
        if mesh_on:
            from repro_torch.parallel.sharding import placements
            drules = make_rules(rules.mesh, mode="decode")
            cs = SP.cache_specs(cfg, shape, drules)
            cache_pl = {k: placements(s.spec, rules.mesh)
                        for k, s in cs.items()}
            out = (SP.logits_sharding(cfg, shape, drules),
                   {k: s.spec for k, s in cs.items()})
        fn = make_prefill_step(cfg, rules=rules, cache_placements=cache_pl,
                               **chunks)
        b = SP.input_specs(cfg, shape, rules)
        specs = (p, b)
    else:
        fn = make_serve_step(cfg, rules=rules)
        ins = SP.input_specs(cfg, shape, rules, kv_quant=kv_quant)
        specs = (p, ins["cache"], ins["tokens"])
        out = ((SP.logits_sharding(cfg, shape, rules),
                {k: s.spec for k, s in ins["cache"].items()})
               if mesh_on else None)
    inputs = make_inputs(specs, rules) if make_inputs is not None else specs
    return fn, inputs, out
