"""GQA/MHA attention in PyTorch: prefill/training attention through the
flash-attention kernel, decode attention against (per-request) KV caches,
qk-norm and QKV bias (port of the GQA path of
``src/repro/models/attention.py``).  MLA, M-RoPE, Hymba meta tokens and
cross-attention belong to later slices of the port.

Every contraction runs in f32 on the operands' values (the reference's
``preferred_element_type=float32``); bf16 operands are upcast, which is
exact, rather than multiplied in bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import ieee_f32
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def _chunk_sizes(sq, sk, q_chunk, k_chunk):
    qc = q_chunk if (q_chunk and sq % q_chunk == 0 and sq >= q_chunk) else sq
    kc = k_chunk if (k_chunk and sk % k_chunk == 0 and sk >= k_chunk) else sk
    return qc, kc


def _chunked_reference(q, k, v, *, causal, window, q_offset, q_chunk,
                       k_chunk):
    """The torch body of :func:`chunked_attention`, in f32: query chunks
    one after another, each against the full key set.  The attention
    backward differentiates it (recomputing the forward, as the reference's
    remat'd chunks do)."""
    B, Sq, H, Dk = q.shape
    K = k.shape[2]
    G = H // K
    Dv = v.shape[-1]
    Sk = k.shape[1]
    scale = 1.0 / np.sqrt(Dk)
    qc, _ = _chunk_sizes(Sq, Sk, q_chunk, k_chunk)
    nq = Sq // qc
    dev = q.device

    qr = (q.float() * scale).reshape(B, nq, qc, H, Dk)
    kf = k.float()
    vf = v.float()
    if G > 1:
        kf = torch.repeat_interleave(kf, G, dim=2)
        vf = torch.repeat_interleave(vf, G, dim=2)
    kpos = torch.arange(Sk, device=dev)
    outs = []
    for qi in range(nq):
        s = torch.einsum("bqhd,bshd->bhqs", qr[:, qi], kf)
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        mask = torch.ones((qc, Sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m = s.max(dim=-1, keepdim=True).values
        p = torch.exp(s - m) * mask[None, None]
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        outs.append(torch.einsum("bhqs,bshd->bqhd", p / l, vf))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash-attention kernel (``ops.mha_flash``) on f32
    operands.  Backward: the gradient of :func:`_chunked_reference`,
    recomputed from the saved inputs -- the flash kernel has no backward
    kernel (neither has the TPU one), and the reference differentiates
    through a remat of its query chunks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, k_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        q_chunk=q_chunk, k_chunk=k_chunk)
        return ops.mha_flash(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        if g.is_cuda:
            ieee_f32()          # the recompute's einsums, in IEEE f32
        with torch.enable_grad():
            out = _chunked_reference(*leaves, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None, None


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      q_chunk=256, k_chunk=512):
    """q: (B,Sq,H,Dk); k: (B,Sk,K,Dk); v: (B,Sk,K,Dv) with H % K == 0.
    Returns (B,Sq,H,Dv) in v's dtype.  ``window > 0`` keeps only the last
    ``window`` keys; ``q_offset`` shifts query positions.  The forward is
    the flash-attention kernel on q, k and v upcast to f32 (the
    reference's upcast, so the kernel's rounding of p to v's type is
    exact); ``q_chunk``/``k_chunk`` shape the backward's recompute."""
    out = _FlashAttention.apply(q.float(), k.float(), v.float(), causal,
                                window, q_offset, q_chunk, k_chunk)
    return out.to(v.dtype)


def decode_attention(q, k_cache, v_cache, valid):
    """Single-token attention against a cache.  q: (B,1,H,Dk);
    k_cache: (B,Smax,K,Dk); v_cache: (B,Smax,K,Dv); valid: (Smax,) bool or
    (B,Smax) per-request occupancy.  Returns (B,1,H,Dv) in the cache
    dtype.  On the card it runs the flash-decode kernel
    (``ops.gqa_flash_decode``), which keeps the TPU kernel's roundings:
    q scaled in f32, the un-normalised probabilities rounded to the cache
    dtype; on the CPU it is :func:`decode_attention_plain`, the
    reference's function and roundings.  The two agree to summation order
    in f32; a row with no valid slot (which ``decode_step`` never forms)
    gives zeros on the card and the mean of V here.  int8 caches, which
    the reference reads without their scales (ROADMAP.md, faults), take
    the plain body on both devices: no kernel of either package reads
    them."""
    if q.is_cuda and k_cache.is_floating_point():
        return ops.gqa_flash_decode(q, k_cache, v_cache, valid)
    return decode_attention_plain(q, k_cache, v_cache, valid)


def decode_attention_plain(q, k_cache, v_cache, valid):
    """The reference's ``decode_attention`` in plain torch: scores take q
    scaled and rounded to the cache dtype, probabilities are normalised
    and rounded to it before the V product."""
    B, _, H, Dk = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(Dk)
    qc = (q.reshape(B, K, G, Dk) * scale).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qc.float(), k_cache.float())
    vmask = valid[:, None, None, :] if valid.dim() == 2 \
        else valid[None, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pw = (p / l).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", pw.float(), v_cache.float())
    return out.reshape(B, 1, H, -1).to(v_cache.dtype)


# --------------------------------------------------------------- GQA block --

def init_attention(cfg, gen, lead=()):
    if cfg.n_meta_tokens:
        raise NotImplementedError("Hymba meta tokens come with the hymba "
                                  "slice of the port")
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = L.pdtype_of(cfg)
    dev = gen.device
    p = {
        "wq": L.dense_init(gen, d, H * hd, dt, lead=lead),
        "wk": L.dense_init(gen, d, K * hd, dt, lead=lead),
        "wv": L.dense_init(gen, d, K * hd, dt, lead=lead),
        "wo": L.dense_init(gen, H * hd, d, dt, lead=lead),
    }
    if cfg.qkv_bias:
        for nm, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[nm] = torch.zeros(tuple(lead) + (width,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, dt, dev, lead)
        p["k_norm"] = L.init_rmsnorm(hd, dt, dev, lead)
    return p


def _project_qkv(cfg, p, x):
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.pdot(x, p["wq"])
    k = L.pdot(x, p["wk"])
    v = L.pdot(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _rope_qk(cfg, q, k, positions):
    if cfg.m_rope:
        raise NotImplementedError("M-RoPE comes with the qwen2-vl slice of "
                                  "the port")
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta))


def attention_block(cfg, p, x, positions, *, causal=True, window=0,
                    q_chunk=256, k_chunk=512):
    """Causal (or bidirectional) self-attention over a full sequence.
    Returns (out, (k, v))."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, positions)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk, k_chunk=k_chunk)
    out = out.reshape(B, S, -1)
    return L.pdot(out, p["wo"]), (k, v)


def _decode_positions(cfg, pos, B):
    """RoPE positions of the incoming token: a scalar ``pos`` broadcasts to
    the batch, a (B,) vector gives each slot its own position."""
    pos = pos.long()
    if pos.dim() == 1:
        return pos.reshape(B, 1)
    return pos.reshape(1, 1).expand(B, 1)


def attention_decode(cfg, p, x, pos, cache_k, cache_v, slot, valid):
    """One-token decode.  x: (B,1,d); cache_k/v: (B,Smax,K,hd), the
    layer's cache slice (read, not modified).  Returns (out, k_new, v_new)
    with the (B,1,K,hd) new-token entries for the caller to write back.
    ``pos``/``slot`` are scalars or (B,) vectors with a (B,Smax)
    ``valid`` mask."""
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rope_qk(cfg, q, k, _decode_positions(cfg, pos, B))
    cache_k = _write_slot(cache_k, k, slot)
    cache_v = _write_slot(cache_v, v, slot)
    out = decode_attention(q, cache_k, cache_v, valid)
    out = out.reshape(B, 1, -1)
    return L.pdot(out, p["wo"]), k, v


def _write_slot(cache, kv, slot):
    """A copy of ``cache`` (B,Smax,K,hd) with ``kv`` (B,1,K,hd) written at
    sequence index ``slot`` (scalar: same for the batch; (B,) vector: one
    index per slot)."""
    out = cache.clone()
    if slot.dim() == 1:
        B = cache.shape[0]
        out[torch.arange(B, device=cache.device), slot.long()] = \
            kv[:, 0].to(cache.dtype)
    else:
        s = int(slot)
        out[:, s:s + 1] = kv.to(cache.dtype)
    return out
