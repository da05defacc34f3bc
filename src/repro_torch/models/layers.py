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

from repro_torch.train_loop import hook as _gemm_hook

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on the PS, mixed float types promoted as in JAX."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


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


def apply_rope(x, positions, theta: float):
    """x: (B,S,H,D), positions: (B,S) int -> rotated x (rotate-half)."""
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
    g = pdot(x, params["w_gate"])
    u = pdot(x, params["w_up"])
    return torch.nn.functional.silu(g.float()).to(x.dtype) * u


def swiglu(params, x):
    return pdot(swiglu_hidden(params, x), params["w_down"])


# -------------------------------------------------------------- embeddings --

def init_embedding(gen, cfg):
    return {"tok": embed_init(gen, padded_vocab(cfg), cfg.d_model,
                              pdtype_of(cfg))}


def embed_tokens(params, tokens, cfg):
    return params["tok"][tokens.long()].to(dtype_of(cfg))


def init_lm_head(gen, cfg):
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, cfg.d_model, padded_vocab(cfg),
                            pdtype_of(cfg))}


def lm_logits(head_params, embed_params, x, cfg):
    w = embed_params["tok"].T if cfg.tie_embeddings else head_params["w"]
    return pdot(x, w)
