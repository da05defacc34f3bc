"""Shapes, dtypes and per-dim sharding specs of every step input, and the
functions that place trees on a mesh (port of
``src/repro/launch/specs.py``).

``input_specs(cfg, shape)`` describes every model input -- tokens and
labels for training, the request batch and the KV cache for serving --
with the modality frontends stubbed as precomputed embeddings.
``param_specs`` gives the weight tree's shapes with CLEAVE-style 2-D (row
x column) specs, built under ``FakeTensorMode`` so nothing is allocated.
A spec is a tuple with one entry per dim (``parallel.sharding``); a
:class:`TensorSpec` holds (shape, dtype, spec).  :func:`shard_params`
and :func:`shard_tree` place real tensors with ``distribute_tensor``.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (Rules, axis_names, axis_sizes,
                                           placements)

ENC_FRAMES = 8192          # fixed audio-encoder length (stubbed frontend)


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    spec: Optional[tuple] = None     # None: no mesh


def cache_len_for(cfg, shape) -> int:
    """Ring-buffer length: the 500k decode shape uses the sliding-window
    variant for attention-cache families (sub-quadratic requirement)."""
    if shape.seq_len > 65536 and cfg.long_context_variant == "sliding_window":
        return cfg.long_context_window
    if cfg.family == "hybrid":
        # Hymba attention is natively SWA; its SSM branch carries the rest
        return min(shape.seq_len, cfg.long_context_window)
    return shape.seq_len


def input_specs(cfg, shape, rules: Optional[Rules] = None, *,
                kv_quant: bool = False) -> dict:
    """TensorSpecs for one step of the given input shape."""
    B, S = shape.global_batch, shape.seq_len
    dt = L.dtype_of(cfg)

    def sds(shp, dtype, *logical):
        if rules is None or rules.mesh is None:
            return TensorSpec(tuple(shp), dtype)
        return TensorSpec(tuple(shp), dtype,
                          _divisible_spec(rules, shp, logical))

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": sds((B, S), torch.int32, "batch", None)}
        if shape.kind == "train":
            specs["labels"] = sds((B, S), torch.int32, "batch", None)
        if cfg.modality == "vision":
            svis = int(S * cfg.vision_tokens_ratio)
            specs["vision_embeds"] = sds((B, svis, cfg.d_model), dt,
                                         "batch", None, "embed")
            specs["positions_mrope"] = sds((B, S, 3), torch.int32,
                                           "batch", None, None)
        if cfg.enc_dec:
            frames = min(2 * S, ENC_FRAMES) if shape.kind == "train" \
                else ENC_FRAMES
            specs["encoder_feats"] = sds((B, frames, cfg.d_model), dt,
                                         "batch", None, "embed")
        return specs

    # decode: one new token against a seq_len-deep cache
    specs = {"tokens": sds((B, 1), torch.int32, "cache_batch", None)}
    specs["cache"] = cache_specs(cfg, shape, rules, kv_quant=kv_quant)
    return specs


CACHE_LOGICAL = {
    "k": ("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "k_scale": ("layers", "cache_batch", "cache_seq", "kv_heads"),
    "v_scale": ("layers", "cache_batch", "cache_seq", "kv_heads"),
    "ckv": ("layers", "cache_batch", "cache_seq", None),
    "kpe": ("layers", "cache_batch", "cache_seq", None),
    "cross_k": ("layers", "cache_batch", None, "kv_heads", "head_dim"),
    "cross_v": ("layers", "cache_batch", None, "kv_heads", "head_dim"),
    "wkv_state": ("layers", "cache_batch", "heads", None, None),
    "tm_prev": ("layers", "cache_batch", None),
    "cm_prev": ("layers", "cache_batch", None),
    "ssm_h": ("layers", "cache_batch", "ffn", None),
    "ssm_conv": ("layers", "cache_batch", None, "ffn"),
    "pos": (),
}


def cache_specs(cfg, shape, rules: Optional[Rules] = None, *,
                kv_quant: bool = False) -> dict:
    from repro_torch.models import model as M
    B = shape.global_batch
    clen = cache_len_for(cfg, shape)
    enc_len = ENC_FRAMES if cfg.enc_dec else 0
    cache = M.init_cache(cfg, B, clen, enc_len=enc_len, kv_quant=kv_quant,
                         device="meta")
    specs = {}
    for name, t in cache.items():
        if rules is None:
            specs[name] = TensorSpec(tuple(t.shape), t.dtype)
            continue
        logical = CACHE_LOGICAL.get(name, tuple(None for _ in t.shape))
        logical = [None if n == "layers" else n for n in logical]
        specs[name] = TensorSpec(tuple(t.shape), t.dtype,
                                 _divisible_spec(rules, t.shape, logical))
    return specs


def _divisible_spec(rules: Rules, shp, logical) -> tuple:
    parts = []
    used = set()
    sizes = axis_sizes(rules.mesh)
    for dim, name in zip(shp, logical):
        if name is None:
            parts.append(None)
            continue
        sub = rules.spec(name)[0]
        if sub is None:
            parts.append(None)
            continue
        axes = (sub,) if isinstance(sub, str) else tuple(sub)
        axes = tuple(a for a in axes if a not in used)
        if not axes:
            parts.append(None)
            continue
        n = int(np.prod([sizes[a] for a in axes]))
        if dim % n != 0:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes[0] if len(axes) == 1 else axes)
    return tuple(parts)


def logits_sharding(cfg, shape, rules: Rules) -> tuple:
    """The spec of the (B, 1, padded_vocab) step-output logits: batch on
    the data axes, vocab on 'model'."""
    shp = (shape.global_batch, 1, L.padded_vocab(cfg))
    return _divisible_spec(rules, shp, ["cache_batch", None, "vocab"])


# -------------------------------------------------------------- parameters --

_IN_PROJ = re.compile(
    r"(wq|wk|wv|w_gate|w_up|w_uq|w_dq|w_dkv|w_uk|w_uv|w_q|w_in|w_bc|w_dt1"
    r"|w_r|w_k|w_g|wA)$")
_OUT_PROJ = re.compile(r"(wo|w_down|w_out|w_o|w_v|wB|w_dt2)$")


def _leaf_spec(path: str, shp, rules: Rules) -> tuple:
    """CLEAVE 2-D weight sharding: in-projections (d -> X) put rows on
    'data' and columns on 'model' (the PS dispatching A-rows / B-cols);
    out-projections are the transpose."""
    stacked = ("layers/" in path or "/cross/" in path
               or path.startswith("cross/"))
    lead = [None] if stacked else []
    name = path.rsplit("/", 1)[-1]
    core_ndim = len(shp) - len(lead)

    if name == "tok":
        spec = ["model", None]                       # vocab-sharded embed
    elif path.endswith("head/w") or (name == "w" and "head" in path):
        spec = [rules.table.get("w_in"), "model"]    # d -> vocab
    elif name == "router":
        spec = [rules.table.get("w_in"), None]
    elif name in ("w_gate", "w_up", "w_down") and core_ndim == 3:
        # MoE expert-stacked weights: experts -> 'model'
        if name == "w_down":
            spec = ["model", None, rules.table.get("w_in")]
        else:
            spec = ["model", rules.table.get("w_in"), None]
    elif _IN_PROJ.search(name) and core_ndim == 2:
        spec = [rules.table.get("w_in"), "model"]
    elif _OUT_PROJ.search(name) and core_ndim == 2:
        spec = ["model", rules.table.get("w_in")]
    else:
        spec = [None] * core_ndim
    spec = lead + spec
    # drop shardings that don't divide
    names, sizes = axis_names(rules.mesh), axis_sizes(rules.mesh)
    parts = []
    for dim, ax in zip(shp, spec):
        if ax is None:
            parts.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in names)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        parts.append(ax if (axes and dim % n == 0) else None)
    return tuple(parts)


def param_shapes(cfg) -> dict:
    """The param tree's shapes and dtypes, built under ``FakeTensorMode``
    (nothing is allocated, at any width)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import model as M
    with FakeTensorMode():
        params = M.init_params(cfg, torch.Generator(device="cpu"))
    return T.map_tree(lambda t: (tuple(t.shape), t.dtype), params)


def param_specs(cfg, rules: Optional[Rules] = None) -> dict:
    """The param tree as TensorSpecs, with specs on a mesh."""
    shapes = param_shapes(cfg)
    keys = T.paths(shapes)
    out = []
    for path, (shp, dt) in zip(keys, T.leaves(shapes)):
        spec = None
        if rules is not None and rules.mesh is not None:
            spec = _leaf_spec("/".join(path), shp, rules)
        out.append(TensorSpec(shp, dt, spec))
    return _with_empty(shapes, T.unflatten(keys, out))


def _with_empty(template, tree):
    """Keep the template's empty dicts (a tied model's ``head``)."""
    if isinstance(template, dict):
        return {k: _with_empty(v, tree.get(k, {})) for k, v in
                template.items()}
    return tree


def opt_specs(param_specs_tree, rules: Optional[Rules] = None):
    """AdamState specs: f32 moments sharded like their weights, plus a
    ZeRO 'pod'-axis shard on the first dim that takes it when a pod axis
    exists (the moments are touched only by the elementwise Adam update,
    so the extra shard is free of hot-path gathers)."""
    from repro_torch.optim.adam import AdamState

    mesh = rules.mesh if rules else None
    has_pod = mesh is not None and "pod" in axis_names(mesh)
    sizes = axis_sizes(mesh) if mesh is not None else {}

    def moment(s: TensorSpec) -> TensorSpec:
        spec = s.spec
        if has_pod and spec is not None:
            spec = list(spec) + [None] * (len(s.shape) - len(spec))
            for i, (ax, dim) in enumerate(zip(spec, s.shape)):
                axes = () if ax is None else (
                    (ax,) if isinstance(ax, str) else tuple(ax))
                if "pod" in axes:
                    break
                n = int(np.prod([sizes[a] for a in axes])) if axes else 1
                if dim % (n * sizes["pod"]) == 0:
                    axes = ("pod",) + axes
                    # a one-axis tuple is its name, as PartitionSpec has it
                    spec[i] = axes[0] if len(axes) == 1 else axes
                    break
            spec = tuple(spec)
        return TensorSpec(s.shape, torch.float32, spec)

    mu = T.map_tree(moment, param_specs_tree)
    nu = T.map_tree(moment, param_specs_tree)
    step = TensorSpec((), torch.int32, () if mesh is not None else None)
    return AdamState(step=step, mu=mu, nu=nu)


# ------------------------------------------------------------- placement --

def shard_params(params, rules: Rules) -> dict:
    """``params`` (the same full tree on every rank) as DTensors with
    :func:`_leaf_spec`'s placements (each rank keeps its blocks; nothing
    moves)."""
    from torch.distributed.tensor import distribute_tensor
    keys = T.paths(params)
    out = [distribute_tensor(t, rules.mesh, placements(
               _leaf_spec("/".join(k), t.shape, rules), rules.mesh),
               src_data_rank=None)
           for k, t in zip(keys, T.leaves(params))]
    return _with_empty(params, T.unflatten(keys, out))


def shard_tree(tree, specs, mesh):
    """Each leaf of ``tree`` (the same full tensor on every rank) as a
    DTensor with its spec's placements (each rank keeps its blocks);
    ``specs`` is a tree of the same nesting holding TensorSpecs or
    per-dim spec tuples."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, s):
        spec = s.spec if isinstance(s, TensorSpec) else s
        return distribute_tensor(t.contiguous(), mesh,
                                 placements(spec, mesh), src_data_rank=None)
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh) for k in tree}
    return place(tree, specs)


def spec_tree(tree) -> dict:
    """The per-dim specs of a tree of TensorSpecs."""
    return T.map_tree(lambda s: s.spec, tree)
