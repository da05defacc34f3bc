"""GQA/MHA and MLA attention in PyTorch: prefill/training attention
through the flash-attention kernel, decode attention against
(per-request) KV caches, qk-norm and QKV bias, M-RoPE, cross-attention
against an encoder's K/V, and DeepSeek-V2's multi-head latent attention
with its absorbed decode, and Hymba's learned meta-token K/V prefixes
(port of ``src/repro/models/attention.py`` but its mesh-sharded decode,
``_decode_attention_sharded``).

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
                      prefix_kv=None, q_chunk=256, k_chunk=512):
    """q: (B,Sq,H,Dk); k: (B,Sk,K,Dk); v: (B,Sk,K,Dv) with H % K == 0.
    Returns (B,Sq,H,Dv) in v's dtype.  ``window > 0`` keeps only the last
    ``window`` keys; ``q_offset`` shifts query positions.  The forward is
    the flash-attention kernel on q, k and v upcast to f32 (the
    reference's upcast, so the kernel's rounding of p to v's type is
    exact); ``q_chunk``/``k_chunk`` shape the backward's recompute.

    ``prefix_kv = (pk, pv)``, pk: (B,P,K,Dk), is an always-visible prefix
    at positions < 0 (Hymba's meta tokens).  It is put before k and v and
    the queries shifted by P: key j of the concatenation is then visible
    to query i iff j <= P + q_offset + i, the reference's mask without a
    window.  With a window the shift would hide prefix keys that the
    reference keeps, so a prefix and a window together raise (the
    mesh layer's long-context specs, ROADMAP A.7)."""
    dtype = v.dtype
    k, v = k.float(), v.float()
    if prefix_kv is not None:
        if window:
            raise NotImplementedError(
                "attention with a meta-token prefix and a sliding window is "
                "not ported (the mesh layer's long-context specs, ROADMAP "
                "A.7)")
        pk, pv = prefix_kv
        k = torch.cat([pk.float(), k], dim=1)
        v = torch.cat([pv.float(), v], dim=1)
        q_offset = q_offset + pk.shape[1]
    out = _FlashAttention.apply(q.float(), k, v, causal, window, q_offset,
                                q_chunk, k_chunk)
    return out.to(dtype)


def decode_attention(q, k_cache, v_cache, valid, prefix_kv=None):
    """Single-token attention against a cache.  q: (B,1,H,Dk);
    k_cache: (B,Smax,K,Dk); v_cache: (B,Smax,K,Dv); valid: (Smax,) bool or
    (B,Smax) per-request occupancy; ``prefix_kv = (pk, pv)`` (B,P,K,·)
    always-visible keys before the cache (Hymba's meta tokens).  Returns
    (B,1,H,Dv) in the cache dtype.  On the card it runs the flash-decode
    kernel (``ops.gqa_flash_decode``; with a prefix over [prefix cast to
    the cache dtype; cache] and [P x True; valid], a copy of the layer's
    cache a step), which keeps the TPU kernel's roundings: q scaled in
    f32, the un-normalised probabilities rounded to the cache dtype; on
    the CPU it is :func:`decode_attention_plain`, the reference's
    function and roundings.  The two agree to summation order in f32; a
    row with no valid slot (which ``decode_step`` never forms) gives zeros
    on the card and the mean of V here.  int8 caches, which the reference
    reads without their scales (ROADMAP.md, faults), take the plain body
    on both devices: no kernel of either package reads them."""
    if not (q.is_cuda and k_cache.is_floating_point()):
        return decode_attention_plain(q, k_cache, v_cache, valid, prefix_kv)
    if prefix_kv is not None:
        pk, pv = prefix_kv
        k_cache = torch.cat([pk.to(k_cache.dtype), k_cache], dim=1)
        v_cache = torch.cat([pv.to(v_cache.dtype), v_cache], dim=1)
        seen = torch.ones(valid.shape[:-1] + (pk.shape[1],),
                          dtype=torch.bool, device=valid.device)
        valid = torch.cat([seen, valid], dim=-1)
    return ops.gqa_flash_decode(q, k_cache, v_cache, valid)


def decode_attention_plain(q, k_cache, v_cache, valid, prefix_kv=None):
    """The reference's ``decode_attention`` in plain torch: scores take q
    scaled and rounded to the cache dtype, the prefix's scores (against
    its keys cast to the cache dtype) come before the cache's,
    probabilities are normalised and rounded to the cache dtype before
    the V product."""
    B, _, H, Dk = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(Dk)
    qc = (q.reshape(B, K, G, Dk) * scale).to(k_cache.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qc, k_cache.float())
    vmask = valid[:, None, None, :] if valid.dim() == 2 \
        else valid[None, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    if prefix_kv is not None:
        pk, pv = prefix_kv
        sp = torch.einsum("bkgd,bskd->bkgs", qc,
                          pk.to(k_cache.dtype).float())
        s = torch.cat([sp, s], dim=-1)
        v_cache = torch.cat([pv.to(v_cache.dtype), v_cache], dim=1)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pw = (p / l).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", pw.float(), v_cache.float())
    return out.reshape(B, 1, H, -1).to(v_cache.dtype)


# --------------------------------------------------------------- GQA block --

def init_attention(cfg, gen, lead=()):
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
    if cfg.n_meta_tokens:
        for nm in ("meta_k", "meta_v"):
            p[nm] = L.normal(gen, tuple(lead) + (cfg.n_meta_tokens, K, hd),
                             0.02, dt)
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
    """Rotate q and k: M-RoPE over (B,S,3) positions when ``cfg.m_rope``,
    else RoPE over (B,S) positions."""
    if cfg.m_rope:
        secs = cfg.m_rope_sections
        return (L.apply_m_rope(q, positions, cfg.rope_theta, secs),
                L.apply_m_rope(k, positions, cfg.rope_theta, secs))
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta))


def _meta_kv(cfg, p, B):
    """The meta tokens' K/V broadcast over the batch, (B,P,K,hd) each, or
    None without them."""
    if not cfg.n_meta_tokens:
        return None
    return tuple(p[nm][None].expand((B,) + tuple(p[nm].shape))
                 for nm in ("meta_k", "meta_v"))


def attention_block(cfg, p, x, positions, *, causal=True, window=0,
                    q_chunk=256, k_chunk=512, cross_kv=None):
    """Causal (or bidirectional) self-attention over a full sequence, or
    cross-attention when ``cross_kv=(k, v)`` is given (always
    non-causal, no rotation).  Returns (out, (k, v)).  As in the
    reference, cross-attention still projects x to k and v and drops
    them: those two fleet GEMMs run in the forward and have no
    backward.  With meta tokens every query also attends over their K/V
    (:func:`_meta_kv`); the (k, v) returned for a cache leave them out."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    if cross_kv is not None:
        k, v = cross_kv
        causal = False
    else:
        q, k = _rope_qk(cfg, q, k, positions)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            prefix_kv=_meta_kv(cfg, p, B),
                            q_chunk=q_chunk, k_chunk=k_chunk)
    out = out.reshape(B, S, -1)
    return L.pdot(out, p["wo"]), (k, v)


def project_cross_kv(cfg, p, enc_x):
    """Cross-attention K/V (B,Se,K,hd) from the encoder output: once per
    decode session, and for every decoder layer in training."""
    B, S, _ = enc_x.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    k = L.pdot(enc_x, p["wk"]).reshape(B, S, K, hd)
    v = L.pdot(enc_x, p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm:
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def _decode_positions(cfg, pos, B):
    """RoPE positions of the incoming token: a scalar ``pos`` broadcasts to
    the batch, a (B,) vector gives each slot its own position.  Under
    M-RoPE the position is repeated as (t, h, w), (B,1,3), as the
    reference does whatever grid the prefill used (Qwen2-VL would go on
    from the prefill's largest position + 1; ROADMAP.md records the
    difference)."""
    pos = pos.long()
    if pos.dim() == 1:
        base = pos.reshape(B, 1)
    else:
        base = pos.reshape(1, 1).expand(B, 1)
    if cfg.m_rope:
        return base[..., None].expand(B, 1, 3)
    return base


def attention_decode(cfg, p, x, pos, cache_k, cache_v, slot, valid,
                     cross_kv=None):
    """One-token decode.  x: (B,1,d); cache_k/v: (B,Smax,K,hd), the
    layer's cache slice (read, not modified).  Returns (out, k_new, v_new)
    with the (B,1,K,hd) new-token entries for the caller to write back.
    ``pos``/``slot`` are scalars or (B,) vectors with a (B,Smax)
    ``valid`` mask.  With meta tokens the self-attention reads their K/V
    before the cache.  With ``cross_kv=(k, v)`` (B,Se,K,hd) the token
    attends over every encoder slot instead (the flash-decode kernel
    on the card, an all-valid mask) and k_new = v_new = None."""
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)
    if cross_kv is None:
        q, k = _rope_qk(cfg, q, k, _decode_positions(cfg, pos, B))
        cache_k = _write_slot(cache_k, k, slot)
        cache_v = _write_slot(cache_v, v, slot)
        out = decode_attention(q, cache_k, cache_v, valid,
                               prefix_kv=_meta_kv(cfg, p, B))
    else:
        ck, cv = cross_kv
        valid_c = torch.ones((ck.shape[1],), dtype=torch.bool,
                             device=ck.device)
        out = decode_attention(q, ck, cv, valid_c)
        k = v = None
    out = out.reshape(B, 1, -1)
    return L.pdot(out, p["wo"]), k, v


def _write_slot(cache, kv, slot):
    """A copy of ``cache`` (B,Smax,...) with ``kv`` (B,1,...) written at
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


# ----------------------------------------------------------------- MLA -------

def init_mla(cfg, gen, lead=()):
    """MLA params in the reference's layout: the low-rank query path
    (``w_dq``, ``q_norm``, ``w_uq``; ``w_q`` when ``q_lora_rank`` is 0),
    the joint latent and rope-key projection ``w_dkv``, ``kv_norm``, the
    key and value up-projections ``w_uk``/``w_uv`` and ``wo``."""
    d, H = cfg.d_model, cfg.n_heads
    hd, rd, r, vd = (cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank,
                     cfg.v_dim)
    dt = L.pdtype_of(cfg)
    dev = gen.device
    p = {}
    if cfg.q_lora_rank:
        p["w_dq"] = L.dense_init(gen, d, cfg.q_lora_rank, dt, lead=lead)
        p["q_norm"] = L.init_rmsnorm(cfg.q_lora_rank, dt, dev, lead)
        p["w_uq"] = L.dense_init(gen, cfg.q_lora_rank, H * (hd + rd), dt,
                                 lead=lead)
    else:
        p["w_q"] = L.dense_init(gen, d, H * (hd + rd), dt, lead=lead)
    p["w_dkv"] = L.dense_init(gen, d, r + rd, dt, lead=lead)
    p["kv_norm"] = L.init_rmsnorm(r, dt, dev, lead)
    p["w_uk"] = L.dense_init(gen, r, H * hd, dt, lead=lead)
    p["w_uv"] = L.dense_init(gen, r, H * vd, dt, lead=lead)
    p["wo"] = L.dense_init(gen, H * vd, d, dt, lead=lead)
    return p


def _mla_q(cfg, p, x):
    """(q_nope (B,S,H,hd), q_pe (B,S,H,rd)), q_pe not yet rotated."""
    B, S, _ = x.shape
    H, hd, rd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        qc = L.rmsnorm(p["q_norm"], L.pdot(x, p["w_dq"]), cfg.norm_eps)
        q = L.pdot(qc, p["w_uq"])
    else:
        q = L.pdot(x, p["w_q"])
    q = q.reshape(B, S, H, hd + rd)
    return q[..., :hd], q[..., hd:]


def _mla_ckv(cfg, p, x, positions):
    """The normed latent c_kv (B,S,r) and the rotated rope key k_pe
    (B,S,rd), shared by every head."""
    r = cfg.kv_lora_rank
    ckv_kpe = L.pdot(x, p["w_dkv"])
    c_kv = L.rmsnorm(p["kv_norm"], ckv_kpe[..., :r], cfg.norm_eps)
    k_pe = L.apply_rope(ckv_kpe[..., None, r:], positions, cfg.rope_theta)
    return c_kv, k_pe[:, :, 0]


def mla_block(cfg, p, x, positions, *, window=0, q_chunk=256, k_chunk=512):
    """MLA training/prefill attention on materialised K/V: q and k of hd +
    rd columns (the rope key broadcast over heads), v of vd, through the
    flash-attention kernel at Dk = hd + rd, Dv = vd.  Returns
    ``(out, (c_kv, k_pe))``, the latent cache entries."""
    B, S, _ = x.shape
    H, hd, rd, vd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.v_dim
    q_nope, q_pe = _mla_q(cfg, p, x)
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv, k_pe = _mla_ckv(cfg, p, x, positions)
    k_nope = L.pdot(c_kv, p["w_uk"]).reshape(B, S, H, hd)
    v = L.pdot(c_kv, p["w_uv"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, rd)], dim=-1)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            q_chunk=q_chunk, k_chunk=k_chunk)
    out = out.reshape(B, S, H * vd)
    return L.pdot(out, p["wo"]), (c_kv, k_pe)


def mla_decode(cfg, p, x, pos, cache_ckv, cache_kpe, slot, valid):
    """Absorbed MLA decode: the queries are projected into the latent space
    (q·W_uk) and score the cached c_kv directly, and the context is
    lifted by W_uv after the probability product, so a step reads (r +
    rd) values a cached position.  x: (B,1,d); cache_ckv (B,Smax,r) and
    cache_kpe (B,Smax,rd) are the layer's cache slices (read, not
    modified).  Returns ``(out, c_kv_new (B,1,r), k_pe_new (B,1,rd))`` in
    the cache dtype for the caller to write back.  The reference's
    roundings are kept: q_c formed in f32 and cast to the cache dtype for
    the score product, the probabilities normalised and then cast to it,
    the context and its product with W_uv in f32, the output cast to x's
    dtype.  Every einsum runs in f32 on upcast operands (IEEE f32 on the
    card), as the reference's ``preferred_element_type``; none reaches a
    Pallas kernel there, so none is a kernel here."""
    B = x.shape[0]
    H, hd, rd, r, vd = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                        cfg.kv_lora_rank, cfg.v_dim)
    positions = _decode_positions(cfg, pos, B)
    q_nope, q_pe = _mla_q(cfg, p, x)
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)      # (B,1,H,rd)
    c_kv_new, k_pe_new = _mla_ckv(cfg, p, x, positions)
    cache_ckv = _write_slot(cache_ckv, c_kv_new, slot)
    cache_kpe = _write_slot(cache_kpe, k_pe_new, slot)
    if x.is_cuda:
        ieee_f32()
    with torch.profiler.record_function("mla.decode"):
        dt = cache_ckv.dtype
        ckv = cache_ckv.float()
        w_uk = p["w_uk"].reshape(r, H, hd).float()
        q_c = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)
        scale = 1.0 / np.sqrt(hd + rd)
        s = (torch.einsum("bqhr,bsr->bhqs", q_c.to(dt).float(), ckv)
             + torch.einsum("bqhd,bsd->bhqs", q_pe.to(dt).float(),
                            cache_kpe.float())) * scale
        vmask = valid[:, None, None, :] if valid.dim() == 2 \
            else valid[None, None, None, :]
        s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
        m = s.max(dim=-1, keepdim=True).values
        pw = torch.exp(s - m)
        pw = pw / pw.sum(dim=-1, keepdim=True)
        ctx = torch.einsum("bhqs,bsr->bqhr", pw.to(dt).float(), ckv)
        w_uv = p["w_uv"].reshape(r, H, vd).float()
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    out = out.reshape(B, 1, H * vd).to(x.dtype)
    return (L.pdot(out, p["wo"]), c_kv_new.to(cache_ckv.dtype),
            k_pe_new.to(cache_kpe.dtype))
