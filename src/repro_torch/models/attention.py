"""GQA/MHA and MLA attention in PyTorch: prefill/training attention
through the flash-attention kernel, decode attention against
(per-request) KV caches, qk-norm and QKV bias, M-RoPE, cross-attention
against an encoder's K/V, and DeepSeek-V2's multi-head latent attention
with its absorbed decode, and Hymba's learned meta-token K/V prefixes
(port of ``src/repro/models/attention.py``).  On a mesh (DTensor inputs
under ``parallel.sharding`` rules) the attention runs on each rank's
block of batch and heads, and the decode through the sharded
flash-decode (:func:`_decode_attention_sharded`).

Every contraction runs in f32 on the operands' values (the reference's
``preferred_element_type=float32``); bf16 operands are upcast, which is
exact, rather than multiplied in bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import ieee_f32
from repro_torch.core.spans import span
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (constrain, current_rules,
                                           is_dtensor)

NEG_INF = -1e30


def _chunk_sizes(sq, sk, q_chunk, k_chunk):
    qc = q_chunk if (q_chunk and sq % q_chunk == 0 and sq >= q_chunk) else sq
    kc = k_chunk if (k_chunk and sk % k_chunk == 0 and sk >= k_chunk) else sk
    return qc, kc


def _chunked_reference(q, k, v, *, causal, window, q_offset, q_chunk,
                       k_chunk, prefix=0):
    """The torch body of :func:`chunked_attention`, in f32: query chunks
    one after another, each against the full key set.  The attention
    backward differentiates it (recomputing the forward, as the reference's
    remat'd chunks do).  Keys j < ``prefix`` are visible to every query."""
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
        if prefix:
            mask |= kpos[None, :] < prefix
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
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, k_chunk,
                prefix):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        q_chunk=q_chunk, k_chunk=k_chunk, prefix=prefix)
        return ops.mha_flash(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, prefix=prefix)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        if g.is_cuda:
            ieee_f32()          # the recompute's einsums, in IEEE f32
        with torch.enable_grad():
            out = _chunked_reference(*leaves, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None, None, None, None


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      prefix_kv=None, q_chunk=256, k_chunk=512):
    """q: (B,Sq,H,Dk); k: (B,Sk,K,Dk); v: (B,Sk,K,Dv) with H % K == 0.
    Returns (B,Sq,H,Dv) in v's dtype.  ``window > 0`` keeps only the last
    ``window`` keys; ``q_offset`` shifts query positions.  The forward is
    the flash-attention kernel on q, k and v upcast to f32 (the
    reference's upcast, so the kernel's rounding of p to v's type is
    exact); ``q_chunk``/``k_chunk`` shape the backward's recompute.

    ``prefix_kv = (pk, pv)``, pk: (B,P,K,Dk), is an always-visible prefix
    at positions < 0 (Hymba's meta tokens).  It is put before k and v,
    the queries shifted by P, and the kernel told that the first P keys
    pass every mask: the others keep the causal and window tests on the
    shifted positions, the reference's mask."""
    if is_dtensor(q):
        return _chunked_attention_sharded(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            prefix_kv=prefix_kv, q_chunk=q_chunk, k_chunk=k_chunk)
    dtype = v.dtype
    k, v = k.float(), v.float()
    P = 0
    if prefix_kv is not None:
        pk, pv = prefix_kv
        P = pk.shape[1]
        k = torch.cat([pk.float(), k], dim=1)
        v = torch.cat([pv.float(), v], dim=1)
        q_offset = q_offset + P
    out = _FlashAttention.apply(q.float(), k, v, causal, window, q_offset,
                                q_chunk, k_chunk, P)
    return out.to(dtype)


def _chunked_attention_sharded(q, k, v, *, prefix_kv, **opts):
    """:func:`chunked_attention` on a mesh: each rank runs the kernel on
    its block, batch on the batch axes and query heads on 'model' (heads
    are independent, so each block's launch is exact).  As the
    reference, k and v go to the full head count first (``repeat`` of
    the kv heads, then the head constraint): here each rank reads the
    kv heads whole and takes those its query heads use."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import constrained_spec, placements
    rules = current_rules()
    mesh = rules.mesh
    H, K = q.shape[2], k.shape[2]
    spec = constrained_spec(rules, q.shape, "batch", "seq", "heads",
                            "head_dim")
    qp = placements(spec, mesh)
    kvp = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in qp)
    head_axis = spec[2]
    args = [q, k, v]
    pls = [qp, kvp, kvp]
    if prefix_kv is not None:
        # the meta tokens broadcast over the batch: every rank reads them
        # whole and keeps as many rows as its block has
        args += list(prefix_kv)
        pls += [(Replicate(),) * len(qp)] * 2

    def body(ql, kl, vl, *pre):
        h0, h1 = (spmd.block_range(H, mesh, head_axis) if head_axis
                  else (0, H))
        idx = torch.arange(h0, h1, device=ql.device) // (H // K)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        pkv = None
        if pre:
            Bl = ql.shape[0]
            pkv = tuple(t[:Bl].index_select(2, idx) for t in pre)
        return chunked_attention(ql, kl, vl, prefix_kv=pkv, **opts)

    return spmd.region(body, mesh, tuple(pls), qp,
                       tuple(q.shape[:3]) + (v.shape[3],))(*args)


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
    on both devices: no kernel of either package reads them.  On a mesh
    (DTensors) :func:`_decode_attention_mesh` dispatches as the reference
    does."""
    if is_dtensor(q):
        return _decode_attention_mesh(q, k_cache, v_cache, valid, prefix_kv)
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
    q = L.pdot(x, constrain(p["wq"], "w_in_use", "w_out"))
    k = L.pdot(x, constrain(p["wk"], "w_in_use", "w_out"))
    v = L.pdot(x, constrain(p["wv"], "w_in_use", "w_out"))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = L.reshape(q, (B, S, H, hd))
    k = L.reshape(k, (B, S, K, hd))
    v = L.reshape(v, (B, S, K, hd))
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
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            prefix_kv=_meta_kv(cfg, p, B),
                            q_chunk=q_chunk, k_chunk=k_chunk)
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    out = L.reshape(out, (B, S, out.shape[2] * out.shape[3]))
    out = constrain(L.pdot(out, constrain(p["wo"], "w_out", "w_in_use")),
                    "batch", "seq", "embed")
    return out, (k, v)


def project_cross_kv(cfg, p, enc_x):
    """Cross-attention K/V (B,Se,K,hd) from the encoder output: once per
    decode session, and for every decoder layer in training."""
    B, S, _ = enc_x.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    k = L.reshape(L.pdot(enc_x, constrain(p["wk"], "w_in_use", "w_out")),
                  (B, S, K, hd))
    v = L.reshape(L.pdot(enc_x, constrain(p["wv"], "w_in_use", "w_out")),
                  (B, S, K, hd))
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
    out = L.reshape(out, (B, 1, out.shape[2] * out.shape[3]))
    return L.pdot(out, constrain(p["wo"], "w_out", "w_in_use")), k, v


def _decode_attention_mesh(q, k_cache, v_cache, valid, prefix_kv):
    """:func:`decode_attention` on a mesh, each rank on its block, with
    the reference's dispatch: with the cache sequence on 'model', no
    prefix and one mask for the batch, the sharded flash-decode
    (:func:`_decode_attention_sharded`); otherwise the cache is gathered
    over 'model' and the unsharded decode (the flash-decode kernel on the
    card) runs on the whole of it."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import (axis_sizes, batch_axes,
                                               placements)
    mesh = current_rules().mesh
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    nb = int(np.prod([sizes[a] for a in baxes]))
    Smax = k_cache.shape[1]
    sharded = (prefix_kv is None and valid.dim() == 1
               and "model" in sizes and q.shape[0] % nb == 0
               and Smax % sizes["model"] == 0)
    bspec = baxes if q.shape[0] % nb == 0 else None
    bp = placements((bspec,), mesh)
    cp = placements((bspec, "model" if sharded else None), mesh)

    def body(ql, ck, cv, *pre):
        if sharded:
            lo, hi = spmd.block_range(Smax, mesh, "model")
            return _decode_attention_sharded(ql, ck, cv, valid[lo:hi],
                                             mesh)
        # the meta tokens broadcast over the batch: the block's rows
        pkv = tuple(t[:ql.shape[0]] for t in pre) if pre else None
        vl = valid if valid.dim() == 1 else valid[:ql.shape[0]]
        return decode_attention(ql, ck, cv, vl, prefix_kv=pkv)

    args, pls = [q, k_cache, v_cache], [bp, cp, cp]
    if prefix_kv is not None:
        args += list(prefix_kv)
        pls += [(Replicate(),) * len(bp)] * 2
    return spmd.region(body, mesh, tuple(pls), bp,
                       tuple(q.shape[:3]) + (v_cache.shape[3],))(*args)


def _decode_attention_sharded(q, k_cache, v_cache, valid, mesh):
    """The reference's explicit flash-decode, on this rank's block: it
    scores its cache-sequence slice in f32 (multiply and reduce, as the
    reference's shard_map body), then the max, the denominator and the
    output combine over 'model' (a max all-reduce, then sum
    all-reduces).  q: (Bl,1,H,Dk); k_cache, v_cache: (Bl,Sl,K,·);
    valid: (Sl,) bool.  Returns (Bl,1,H,Dv) in the cache dtype."""
    from repro_torch.parallel import spmd
    Bl, _, H, Dk = q.shape
    K = k_cache.shape[2]
    G = H // K
    Dv = v_cache.shape[-1]
    scale = 1.0 / np.sqrt(Dk)
    qc = (q.reshape(Bl, K, G, Dk) * scale).float()
    s = torch.sum(qc[:, None] * k_cache[:, :, :, None, :].float(), dim=-1)
    vm = valid[None, :, None, None]
    s = torch.where(vm, s, torch.full_like(s, NEG_INF))   # (Bl, Sl, K, G)
    m = spmd.pmax(s.amax(dim=1), mesh, "model")            # (Bl, K, G)
    p = torch.exp(s - m[:, None])
    p = torch.where(vm, p, torch.zeros_like(p))
    l = spmd.psum(p.sum(dim=1), mesh, "model")
    o = torch.sum(p[..., None] * v_cache[:, :, :, None, :].float(), dim=1)
    o = spmd.psum(o, mesh, "model")                        # (Bl, K, G, Dv)
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(v_cache.dtype)
    return out.reshape(Bl, 1, H, Dv)


def _write_slot(cache, kv, slot):
    """A copy of ``cache`` (B,Smax,...) with ``kv`` (B,1,...) written at
    sequence index ``slot`` (scalar: same for the batch; (B,) vector: one
    index per slot).  On a mesh each rank writes its block
    (``spmd.write_at``)."""
    if is_dtensor(cache):
        from repro_torch.parallel import spmd
        return spmd.write_at(cache, kv, slot, 1)
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
        q = L.pdot(qc, constrain(p["w_uq"], "w_in_use", "w_out"))
    else:
        q = L.pdot(x, constrain(p["w_q"], "w_in_use", "w_out"))
    q = L.reshape(q, (B, S, H, hd + rd))
    return q[..., :hd], q[..., hd:]


def _mla_ckv(cfg, p, x, positions):
    """The normed latent c_kv (B,S,r) and the rotated rope key k_pe
    (B,S,rd), shared by every head."""
    r = cfg.kv_lora_rank
    ckv_kpe = L.pdot(x, constrain(p["w_dkv"], "w_in_use", None))
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
    k_nope = L.reshape(L.pdot(c_kv, constrain(p["w_uk"], None, "w_out")),
                       (B, S, H, hd))
    v = L.reshape(L.pdot(c_kv, constrain(p["w_uv"], None, "w_out")),
                  (B, S, H, vd))
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, rd)], dim=-1)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "heads", "head_dim")
    v = constrain(v, "batch", "seq", "heads", "head_dim")
    out = chunked_attention(q, k, v, causal=True, window=window,
                            q_chunk=q_chunk, k_chunk=k_chunk)
    out = L.reshape(out, (B, S, H * vd))
    out = constrain(L.pdot(out, constrain(p["wo"], "w_out", "w_in_use")),
                    "batch", "seq", "embed")
    return out, (c_kv, k_pe)


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
    Pallas kernel there, so none is a kernel here.  On a mesh each rank
    decodes its batch rows over the whole latent cache
    (``spmd.on_batch_rows``)."""
    if is_dtensor(x):
        from repro_torch.parallel import spmd
        return tuple(spmd.on_batch_rows(
            lambda xl, cl, kl, pl: mla_decode(cfg, pl, xl, pos, cl, kl, slot,
                                              valid),
            [x, cache_ckv, cache_kpe], p, 3))
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
    with span("mla.decode"):
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
    return (L.pdot(out, constrain(p["wo"], "w_out", "w_in_use")),
            c_kv_new.to(cache_ckv.dtype), k_pe_new.to(cache_kpe.dtype))
