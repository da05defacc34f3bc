"""Shared layer primitives in PyTorch: projection GEMM hook, norms (RMS,
layer and group), rotary embeddings (incl. M-RoPE), SwiGLU, embeddings,
init helpers (port of
``src/repro/models/layers.py``).  Params are nested dicts of tensors in the
reference's layout; every ``init_*`` draws from a ``torch.Generator`` on
the target device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.sharding import constrain, is_dtensor
from repro_torch.train_loop import hook as _gemm_hook

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on the PS, mixed float types promoted as in JAX.  On a
    mesh (DTensors) :func:`matmul_sharded`."""
    if is_dtensor(x) or is_dtensor(w):
        return matmul_sharded(x, w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def matmul_sharded(x, w):
    """``x @ w`` for DTensors x (..., K) and w (K, N), each rank
    multiplying its blocks: per mesh dim, w's rows sharded meet x's
    contraction sharded alike (sliced locally where x is replicated) and
    leave a pending sum; w's columns shard the output; where x's rows are
    sharded over the dim that also shards w, w is gathered over it (the
    per-layer weight gather of CLEAVE's 2-D layout), and an x whose
    contraction is sharded against w's columns is gathered (the
    activation gather).  The products are exact; the layout is chosen
    here, not by DTensor's propagation, which may replicate the whole
    activation."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel import spmd
    mesh = w.device_mesh
    kx = x.dim() - 1
    xpl, wpl, opl = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_partial():
            xp = Replicate()
        if isinstance(wp, Shard) and wp.dim == 0:              # rows
            if isinstance(xp, Shard) and xp.dim != kx:
                wp, out = Replicate(), xp
            else:
                xp, out = Shard(kx), Partial()
        elif isinstance(wp, Shard):                            # columns
            if isinstance(xp, Shard) and xp.dim != kx:
                wp, out = Replicate(), xp
            else:
                xp, out = Replicate(), Shard(kx)
        else:
            if isinstance(xp, Shard) and xp.dim == kx:
                wp, out = Shard(0), Partial()
            else:
                out = xp
        xpl.append(xp)
        wpl.append(wp)
        opl.append(out)
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    return spmd.region(matmul, mesh, (tuple(xpl), tuple(wpl)), tuple(opl),
                       shape)(x, w)


def reshape(t, shape):
    """``t.reshape(shape)``; on a mesh a dim being split or merged whose
    shard count does not divide the reshaped dim's new size (8 kv heads
    over 16 ranks, 25 heads over 16) is gathered first, as the reference's
    constraint drops such a sharding."""
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    shape = tuple(shape)
    lead = 0
    while lead < min(t.dim(), len(shape)) and t.shape[lead] == shape[lead]:
        lead += 1
    if lead < len(shape):
        mesh = t.device_mesh
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim >= lead
                   and shape[lead] % mesh.size(d) else p
                   for d, p in enumerate(t.placements))
        if pl != tuple(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(shape)


def pdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection matmul ``x @ w`` (x: (..., n), w: (n, q)).

    With no hook installed this is :func:`matmul`; inside a fleet session
    the installed hook executes the GEMM on the fleet executors."""
    hook = _gemm_hook.active()
    if hook is None:
        return matmul(x, w)
    return hook(x, w)


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def padded_vocab(cfg) -> int:
    """Pad vocab to a multiple of 256 (the reference's layout)."""
    return int(np.ceil(cfg.vocab_size / 256) * 256)


# ------------------------------------------------------------------- inits --

def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """Standard normal draws times ``std`` in f32, cast to ``dtype``, on
    the generator's device."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return (x * std).to(dtype)


def dense_init(gen, fan_in, fan_out, dtype, scale=1.0, lead=()):
    return normal(gen, tuple(lead) + (fan_in, fan_out),
                  scale / np.sqrt(fan_in), dtype)


def embed_init(gen, vocab, d, dtype):
    return normal(gen, (vocab, d), 0.02, dtype)


# ------------------------------------------------------------------- norms --

def init_rmsnorm(d, dtype, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params, x, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(d, dtype, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device),
            "bias": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def layernorm(params, x, eps=1e-5):
    """LayerNorm over the last dim, in f32 inside (biased variance)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def init_groupnorm(n_groups, d, dtype, device, lead=()):
    del n_groups  # static; passed to `groupnorm` at apply time
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device),
            "bias": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def groupnorm(params, x, groups, eps=1e-5):
    """GroupNorm over the last dim split into ``groups`` groups (RWKV
    head-wise ln_x), in f32 inside.  x: (..., d)."""
    d = x.shape[-1]
    xg = x.float().reshape(x.shape[:-1] + (groups, d // groups))
    mu = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.var(xg, dim=-1, keepdim=True, unbiased=False)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# -------------------------------------------------------------------- RoPE --

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))


def _rope_region(fn, x, positions, *args):
    """``fn(x, positions, *args)`` on each rank's block of a DTensor x
    (B,S,H,D), positions laid out as x's first two dims: the rotation is
    elementwise over (b, s, head), so every block rotates alone."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import spmd
    mesh = x.device_mesh
    # a pending sum (a product over a sharded contraction) is reduced
    # first: the block rotates values, not shares of them
    xp = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    pp = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
               for p in xp)
    if not is_dtensor(positions):
        from torch.distributed.tensor import distribute_tensor
        positions = distribute_tensor(positions.contiguous(), mesh, pp,
                                      src_data_rank=None)
    return spmd.region(lambda a, b: fn(a, b, *args), mesh, (xp, pp), xp,
                       tuple(x.shape))(x, positions)


def apply_rope(x, positions, theta: float):
    """x: (B,S,H,D), positions: (B,S) int -> rotated x (rotate-half)."""
    if is_dtensor(x):
        return _rope_region(apply_rope, x, positions, theta)
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    ang = positions.float()[..., None] * freqs            # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_m_rope(x, positions, theta: float, sections):
    """Multimodal RoPE (Qwen2-VL): positions (B,S,3) = (t, h, w) indices;
    ``sections`` are half-dim section sizes summing to head_dim // 2, and
    frequency i turns with the position of its section."""
    if is_dtensor(x):
        return _rope_region(apply_m_rope, x, positions, theta, sections)
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"head_dim // 2 = {half}")
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    sec_id = torch.as_tensor(np.concatenate(
        [np.full(s, i) for i, s in enumerate(sections)]), device=x.device)
    ang = positions.float()[..., sec_id] * freqs          # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def default_m_positions(batch, seq, device=None):
    """Text-only M-RoPE positions: t = h = w = the linear position."""
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :, None] \
        .expand(batch, seq, 3)


# ------------------------------------------------------------------ SwiGLU --

def init_swiglu(gen, d, d_ff, dtype, lead=()):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, lead=lead),
        "w_up": dense_init(gen, d, d_ff, dtype, lead=lead),
        "w_down": dense_init(gen, d_ff, d, dtype, lead=lead),
    }


def swiglu_hidden(params, x):
    """silu(x W_gate) * (x W_up): the input of the ``down`` projection."""
    x = constrain(x, "batch", "seq", "embed_use")
    g = pdot(x, constrain(params["w_gate"], "w_in_use", "w_out"))
    u = pdot(x, constrain(params["w_up"], "w_in_use", "w_out"))
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return constrain(h, "batch", "seq", "ffn")


def swiglu(params, x):
    return constrain(pdot(swiglu_hidden(params, x),
                          constrain(params["w_down"], "w_out", "w_in_use")),
                     "batch", "seq", "embed")


# -------------------------------------------------------------- embeddings --

def init_embedding(gen, cfg):
    return {"tok": embed_init(gen, padded_vocab(cfg), cfg.d_model,
                              pdtype_of(cfg))}


def embed_tokens(params, tokens, cfg):
    """The token embeddings; on a mesh :func:`_embed_sharded`."""
    e = constrain(params["tok"], "vocab", "embed")
    if is_dtensor(e):
        return _embed_sharded(e, tokens, cfg)
    return constrain(e[tokens.long()].to(dtype_of(cfg)), "batch", "seq",
                     "embed")


def _embed_sharded(e, tokens, cfg):
    """The vocab-parallel embedding on each rank's block: a rank reads the
    rows of its vocab shard for its batch shard's tokens (zeros for the
    others), and the sums over 'model' are reduce-scattered onto the
    feature dim (all-reduced where that dim is not sharded): one row is
    non-zero in each sum, so the result is exact."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import (constrained_spec,
                                               current_rules, placements)
    rules = current_rules()
    mesh = rules.mesh
    B, S = tokens.shape
    d = e.shape[1]
    spec = constrained_spec(rules, (B, S, d), "batch", "seq", "embed")
    vocab_axis = rules.spec("vocab")[0]
    ep = tuple(Shard(0) if a == vocab_axis else Replicate()
               for a in mesh.mesh_dim_names)
    tp = placements((spec[0], None), mesh)
    xp = placements(spec, mesh)
    embed_axis = spec[2]

    def body(tok, table):
        lo, hi = spmd.block_range(e.shape[0], mesh, vocab_axis) \
            if vocab_axis else (0, e.shape[0])
        t = tok.long()
        mine = (t >= lo) & (t < hi)
        x = table[torch.clamp(t - lo, 0, hi - lo - 1)] * mine[..., None]
        x = x.to(dtype_of(cfg))
        if not vocab_axis:
            return x
        if embed_axis == vocab_axis:
            return spmd.reduce_scatter(x, mesh, vocab_axis, 2)
        return spmd.psum(x, mesh, vocab_axis)

    return spmd.region(body, mesh, (tp, ep), xp, (B, S, d))(tokens, e)


def init_lm_head(gen, cfg):
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, cfg.d_model, padded_vocab(cfg),
                            pdtype_of(cfg))}


def lm_logits(head_params, embed_params, x, cfg):
    w = embed_params["tok"].T if cfg.tie_embeddings else head_params["w"]
    w = constrain(w, "w_in_use", "vocab")
    return constrain(pdot(x, w), "batch", "seq", "vocab")
