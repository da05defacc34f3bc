"""The LM in PyTorch (port of ``src/repro/models/model.py``: the dense
GQA, M-RoPE (with the vision stub), MoE, MLA, RWKV-6, encoder-decoder
(with the audio stub) and hybrid (attention beside selective-SSM heads,
learned meta tokens) families, and the pure selective SSM).  Parameters
keep the reference's layout, with the layers stacked on a leading axis,
so ``interop.from_jax_params`` maps the reference's params one to one.
The layer loop is a Python loop.

Public API
----------
init_params(cfg, generator)              -> params dict
forward(cfg, params, batch, ...)         -> (final hidden, aux, kv)
loss_fn(cfg, params, batch, ...)         -> (loss, metrics)
value_and_grad(cfg, params, batch, ...)  -> ((loss, metrics), grads)
prefill(cfg, params, batch)              -> (last_logits, cache)
decode_step(cfg, params, cache, tokens)  -> (logits, cache)
init_cache(cfg, batch, cache_len, ...)   -> cache dict
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM


def _has_ssm(cfg) -> bool:
    """Whether a layer carries selective-SSM heads: Hymba's beside its
    attention, or a pure SSM's in its place."""
    return cfg.hybrid_parallel or (cfg.ssm and not cfg.rwkv)


# ------------------------------------------------------------------- inits --

def init_layer(cfg, gen, lead=()):
    """One decoder layer's params; ``lead`` prepends axes to every leaf
    (``(n_layers,)`` gives the stacked layout)."""
    dt = L.pdtype_of(cfg)
    dev = gen.device
    if cfg.rwkv:
        return {
            "ln1": L.init_rmsnorm(cfg.d_model, dt, dev, lead),
            "time_mix": R.init_time_mix(cfg, gen, lead),
            "ln2": L.init_rmsnorm(cfg.d_model, dt, dev, lead),
            "channel_mix": R.init_channel_mix(cfg, gen, lead),
        }
    p = {"ln1": L.init_rmsnorm(cfg.d_model, dt, dev, lead)}
    if cfg.mla:
        p["attn"] = A.init_mla(cfg, gen, lead)
    elif not cfg.attn_free:
        p["attn"] = A.init_attention(cfg, gen, lead)
    if _has_ssm(cfg):
        p["ssm"] = SSM.init_ssm(cfg, gen, lead)
    p["ln2"] = L.init_rmsnorm(cfg.d_model, dt, dev, lead)
    if cfg.moe:
        p["moe"] = MOE.init_moe(cfg, gen, lead)
    else:
        p["mlp"] = L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, lead)
    return p


def init_params(cfg, generator: torch.Generator):
    """Random params with the reference's shapes and scales, drawn from
    ``generator`` on its device (the bits differ from ``jax.random``)."""
    params = {
        "embed": L.init_embedding(generator, cfg),
        "layers": init_layer(cfg, generator, lead=(cfg.n_layers,)),
        "final_norm": L.init_rmsnorm(cfg.d_model, L.pdtype_of(cfg),
                                     generator.device),
        "head": L.init_lm_head(generator, cfg),
    }
    if cfg.enc_dec:
        params["encoder"] = ED.init_encoder(cfg, generator)
        # the decoder's cross-attention sublayers, stacked over its layers
        params["cross"] = ED.init_cross_layer(cfg, generator,
                                              lead=(cfg.n_layers,))
    return params


def layer_params(params, i: int, name: str = "layers"):
    """Layer ``i``'s slice of the stacked ``params[name]`` (the decoder
    layers, or ``"cross"``, their cross-attention sublayers)."""
    return T.map_tree(lambda t: t[i], params[name])


# ------------------------------------------------------------ layer bodies --

def layer_forward(cfg, p, x, positions, *, window=0, q_chunk=256,
                  k_chunk=512, causal=True, ssm_chunk=64, cross_fn=None):
    """One decoder layer over a full sequence.  Returns (x, aux, (k, v)),
    for MLA (x, aux, (c_kv, k_pe)), the latent cache entries, for RWKV
    (x, aux, (s_last, tm_last, cm_last)): the layer's final WKV state and
    the last normed inputs of its two token shifts, and for a pure SSM
    (x, aux, ()).  The hybrid branch is 0.5 (attention + SSM), the SSM
    scanned in chunks of ``ssm_chunk`` (:func:`ssm.ssm_block`).  ``aux`` is
    the MoE load-balancing loss (f32 zero for the other families).
    ``cross_fn``, if given, applies cross-attention between the
    self-attention and FFN sublayers (the encoder-decoder's decoder)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.rwkv:
        B = x.shape[0]
        H = cfg.d_model // cfg.rwkv_head_dim
        hd = cfg.rwkv_head_dim
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)
        zt = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        # the reference normalises with rmsnorm's default eps here and
        # with cfg.norm_eps in decode_step; mirrored as written
        h1 = L.rmsnorm(p["ln1"], x)
        tm, tm_last, s_last = R.time_mix(cfg, p["time_mix"], h1, zt, s0,
                                         chunk=32)
        x = x + tm
        h2 = L.rmsnorm(p["ln2"], x)
        cm, cm_last = R.channel_mix(cfg, p["channel_mix"], h2, zt)
        return x + cm, aux, (s_last, tm_last, cm_last)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    branch, kv = None, ()
    if cfg.mla:
        branch, kv = A.mla_block(cfg, p["attn"], h, positions,
                                 window=window, q_chunk=q_chunk,
                                 k_chunk=k_chunk)
    elif not cfg.attn_free:
        branch, kv = A.attention_block(cfg, p["attn"], h, positions,
                                       causal=causal, window=window,
                                       q_chunk=q_chunk, k_chunk=k_chunk)
    if cfg.hybrid_parallel:
        so = SSM.ssm_block(cfg, p["ssm"], h, chunk=ssm_chunk)
        branch = 0.5 * (branch + so)
    elif cfg.ssm and branch is None:
        branch = SSM.ssm_block(cfg, p["ssm"], h, chunk=ssm_chunk)
    x = x + branch
    if cross_fn is not None:
        x = cross_fn(x)
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe:
        mo, a = MOE.moe_block(cfg, p["moe"], h2)
        return x + mo, aux + a, kv
    return x + L.swiglu(p["mlp"], h2), aux, kv


def fuse_inputs(cfg, params, batch):
    """Token embedding and the modality stubs -> (x, positions).  Vision:
    ``vision_embeds`` (B,Svis,d), precomputed patch embeddings, replace
    the first Svis token embeddings.  M-RoPE positions are the batch's
    ``positions_mrope`` (B,S,3) when it carries them, else
    ``default_m_positions``; other families take (B,S) positions."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.modality == "vision" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    if cfg.m_rope:
        positions = batch.get("positions_mrope")
        if positions is None:
            positions = L.default_m_positions(B, S, x.device)
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


def forward(cfg, params, batch, *, window=0, q_chunk=256, k_chunk=512,
            collect_kv=False):
    """Full forward to the final hidden states.  Returns (x, aux, kv): the
    layers' summed MoE load-balancing loss, and the layers' ``(k, v)`` --
    for MLA ``(c_kv, k_pe)``, for RWKV ``(wkv_state, tm_prev, cm_prev)``
    -- stacked over layers when ``collect_kv``.  The encoder-decoder
    encodes ``batch["encoder_feats"]`` first and runs each decoder
    layer's cross-attention over the encoder output."""
    x, positions = fuse_inputs(cfg, params, batch)
    enc_out = None
    if cfg.enc_dec:
        # the reference encodes at encode's own default chunks
        enc_out = ED.encode(cfg, params["encoder"], batch["encoder_feats"])
    per_layer = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        cross_fn = None
        if enc_out is not None:
            cp = layer_params(params, i, "cross")
            cross_fn = lambda y, cp=cp: ED.cross_layer(  # noqa: E731
                cfg, cp, y, enc_out, q_chunk=q_chunk, k_chunk=k_chunk)
        x, a, kv = layer_forward(
            cfg, layer_params(params, i), x, positions, window=window,
            q_chunk=q_chunk, k_chunk=k_chunk, cross_fn=cross_fn)
        aux = aux + a
        if collect_kv:
            per_layer.append(kv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    kv = tuple(torch.stack(t) for t in zip(*per_layer)) if collect_kv \
        else ()
    return x, aux, kv


def _head(params):
    """The LM head's params; ``{}`` under tied embeddings, where the
    reference's empty ``head`` dict holds no leaf, so a tree rebuilt from
    leaves (``tree.unflatten``: gradients, Adam's update) has no key for
    it."""
    return params.get("head", {})


def _vocab_mask(cfg, device):
    vp = L.padded_vocab(cfg)
    m = torch.zeros((vp,), dtype=torch.float32, device=device)
    m[cfg.vocab_size:] = A.NEG_INF
    return m


def loss_fn(cfg, params, batch, *, window=0, q_chunk=256, k_chunk=512,
            loss_chunk=256):
    """Mean cross-entropy over valid labels (labels < 0 are masked),
    computed over ``S // loss_chunk`` sequence chunks one after another so
    the (B, S, V) logits never exist at once.  Returns
    ``(loss + aux, {"loss", "aux_loss", "tokens"})``, ``aux`` the MoE
    load-balancing loss summed over layers (zero for the dense and RWKV
    families)."""
    x, aux, _ = forward(cfg, params, batch, window=window, q_chunk=q_chunk,
                        k_chunk=k_chunk)
    labels = batch["labels"].long()
    B, S = labels.shape
    c = loss_chunk if (S % loss_chunk == 0 and S >= loss_chunk) else S
    nc = S // c
    xr = x.reshape(B, nc, c, -1).transpose(0, 1)
    lr = labels.reshape(B, nc, c).transpose(0, 1)
    vmask = _vocab_mask(cfg, x.device)
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for j in range(nc):
        logits = L.lm_logits(_head(params), params["embed"], xr[j], cfg)
        logits = logits.float() + vmask
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.clamp(lr[j], min=0)
        picked = torch.gather(logits, -1, lab[..., None])[..., 0]
        w = (lr[j] >= 0).float()
        tot = tot + torch.sum((lse - picked) * w)
        cnt = cnt + torch.sum(w)
        del logits, lse, picked
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": cnt}


def value_and_grad(cfg, params, batch, **chunks):
    """``loss_fn`` and its gradient with respect to every param (the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``): autograd
    over detached leaves, so nothing accumulates in ``.grad`` across
    calls.  Returns ``((loss, metrics), grads)`` with grads nested like
    params.  On the card the embedding gather's backward sums with
    atomics, in another order than the reference's scatter-add: the sums
    agree to f32 (or bf16) rounding, within the parity tolerances."""
    keys = T.paths(params)
    leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
    loss, metrics = loss_fn(cfg, T.unflatten(keys, leaves), batch, **chunks)
    grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), T.unflatten(keys, list(grads))


# ------------------------------------------------------------------- cache --

def init_cache(cfg, batch, cache_len, *, enc_len=0, kv_quant=False,
               device="cuda"):
    """Decode cache, stacked over layers.  ``kv_quant`` stores K/V int8 with
    per-(token, head) float16 scales.  MLA caches the latent ``ckv``
    (L,B,S,r) and the rope key ``kpe`` (L,B,S,rd) instead (``kv_quant``
    does not apply, as in the reference); RWKV keeps its recurrent states:
    ``wkv_state`` (L,B,H,hd,hd) f32 and the token-shift inputs
    ``tm_prev``/``cm_prev`` (L,B,d).  SSM heads add their state ``ssm_h``
    (L,B,d_inner,N) f32 and conv window ``ssm_conv`` (L,B,K-1,d_inner)
    (a pure SSM has no K/V).  The encoder-decoder adds the read-only
    cross K/V ``cross_k``/``cross_v`` (L,B,enc_len,K,hd)."""
    dt = L.dtype_of(cfg)
    c = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.rwkv:
        hd = cfg.rwkv_head_dim
        H = cfg.d_model // hd
        Lc = cfg.n_layers
        c["wkv_state"] = torch.zeros((Lc, batch, H, hd, hd),
                                     dtype=torch.float32, device=device)
        c["tm_prev"] = torch.zeros((Lc, batch, cfg.d_model), dtype=dt,
                                   device=device)
        c["cm_prev"] = torch.zeros_like(c["tm_prev"])
        return c
    Lc, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla:
        c["ckv"] = torch.zeros((Lc, batch, cache_len, cfg.kv_lora_rank),
                               dtype=dt, device=device)
        c["kpe"] = torch.zeros((Lc, batch, cache_len, cfg.rope_head_dim),
                               dtype=dt, device=device)
    elif not cfg.attn_free:
        kv_dt = torch.int8 if kv_quant else dt
        c["k"] = torch.zeros((Lc, batch, cache_len, K, hd), dtype=kv_dt,
                             device=device)
        c["v"] = torch.zeros_like(c["k"])
        if kv_quant:
            c["k_scale"] = torch.zeros((Lc, batch, cache_len, K),
                                       dtype=torch.float16, device=device)
            c["v_scale"] = torch.zeros_like(c["k_scale"])
    if _has_ssm(cfg):
        c["ssm_h"] = torch.zeros((Lc, batch, cfg.d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=device)
        c["ssm_conv"] = torch.zeros(
            (Lc, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt,
            device=device)
    if cfg.enc_dec:
        c["cross_k"] = torch.zeros((Lc, batch, enc_len, K, hd), dtype=dt,
                                   device=device)
        c["cross_v"] = torch.zeros_like(c["cross_k"])
    return c


def _kv_quantize(x):
    """Symmetric int8 over the trailing (head_dim) axis with per-(token,
    head) float16 scales; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


# ------------------------------------------------------------- decode step --

def decode_step(cfg, params, cache, tokens, *, window=0):
    """One-token decode.  tokens: (B,1).  ``cache["pos"]`` is the absolute
    position of the incoming token (scalar, or a (B,) vector for
    continuous batching); slot = pos % cache_len.  Returns
    ``(logits (B,1,V_padded) f32, new_cache)``; the input cache is not
    modified.  MLA runs the absorbed decode against the latent cache;
    RWKV runs the recurrence one step (``time_mix`` with ``chunk=1``) and
    replaces its states wholesale, as SSM heads replace ``ssm_h`` and
    ``ssm_conv`` (``ssm.ssm_decode``); the encoder-decoder's
    cross-attention reads ``cross_k``/``cross_v``, which pass through
    unchanged."""
    if cfg.rwkv:
        return _rwkv_decode_step(cfg, params, cache, tokens)
    B = tokens.shape[0]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    pos = cache["pos"]
    vec_pos = pos.dim() == 1
    slot = valid = None
    kv_name = "ckv" if cfg.mla else "k"
    if kv_name in cache:             # a pure SSM caches no K/V
        cache_len = cache[kv_name].shape[2]
        slot = pos % cache_len
        n_valid = torch.clamp(pos + 1, max=cache_len)
        ar = torch.arange(cache_len, device=x.device)
        valid = ar[None, :] < n_valid[:, None] if vec_pos else ar < n_valid
    # int8 caches: the reference's decode_step never hands the scale pools
    # to its layer body (they are not among its per-layer inputs), so int8
    # K/V are read as raw values and new entries are cast to int8 without
    # scales.  The port keeps that behaviour for parity; ROADMAP.md (faults
    # found against the reference) records it.
    news, states = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        branch = None
        if cfg.mla:
            branch, nckv, nkpe = A.mla_decode(
                cfg, lp["attn"], h, pos, cache["ckv"][i], cache["kpe"][i],
                slot, valid)
            news.append({"ckv": nckv, "kpe": nkpe})   # (B,1,·) new entries
        elif not cfg.attn_free:
            branch, nk, nv = A.attention_decode(
                cfg, lp["attn"], h, pos, cache["k"][i], cache["v"][i], slot,
                valid)
            news.append({"k": nk, "v": nv})       # (B,1,K,hd) new entries
        if _has_ssm(cfg):
            so, nh, nconv = SSM.ssm_decode(cfg, lp["ssm"], h,
                                           cache["ssm_h"][i],
                                           cache["ssm_conv"][i])
            states.append((nh, nconv))
            branch = so if branch is None else 0.5 * (branch + so)
        x = x + branch
        if cfg.enc_dec:
            x = ED.cross_layer_decode(
                cfg, layer_params(params, i, "cross"), x,
                (cache["cross_k"][i], cache["cross_v"][i]))
        h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if cfg.moe:
            # the step's B tokens route together: C = max(ceil(B k cf / E),
            # 4) slots per expert
            x = x + MOE.moe_block(cfg, lp["moe"], h2)[0]
        else:
            x = x + L.swiglu(lp["mlp"], h2)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.lm_logits(_head(params), params["embed"], x, cfg)
    logits = logits.float() + _vocab_mask(cfg, x.device)

    new_cache = dict(cache)
    bidx = torch.arange(B, device=x.device)
    for nm in (news[0] if news else ()):
        upd = torch.stack([n[nm] for n in news]).to(cache[nm].dtype)
        out = cache[nm].clone()
        if vec_pos:
            out[:, bidx, slot.long()] = upd[:, :, 0]
        else:
            s = int(slot)
            out[:, :, s:s + 1] = upd
        new_cache[nm] = out
    # recurrent states are replaced wholesale (they are small)
    for nm, vals in zip(("ssm_h", "ssm_conv"), zip(*states)):
        new_cache[nm] = torch.stack(vals)
    new_cache["pos"] = pos + 1
    return logits, new_cache


def _rwkv_decode_step(cfg, params, cache, tokens):
    x = L.embed_tokens(params["embed"], tokens, cfg)
    news = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        hq = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        y, _, s_last = R.time_mix(cfg, lp["time_mix"], hq,
                                  cache["tm_prev"][i],
                                  cache["wkv_state"][i], chunk=1)
        x = x + y
        h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        cm, _ = R.channel_mix(cfg, lp["channel_mix"], h2,
                              cache["cm_prev"][i])
        x = x + cm
        news.append((s_last, hq[:, -1], h2[:, -1]))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.lm_logits(_head(params), params["embed"], x, cfg)
    logits = logits.float() + _vocab_mask(cfg, x.device)
    new_cache = dict(cache)
    # recurrent states are replaced wholesale (they are small)
    for nm, vals in zip(("wkv_state", "tm_prev", "cm_prev"), zip(*news)):
        new_cache[nm] = torch.stack(vals).to(cache[nm].dtype)
    new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache


def prefill(cfg, params, batch, *, window=0, q_chunk=256, k_chunk=512):
    """Forward over a full prompt: last-position logits and the filled
    decode cache (MLA: the latent ``ckv``/``kpe``; RWKV: the final
    recurrent states).  The encoder-decoder's cross K/V stay empty
    (enc_len 0), as in the reference: a decode session fills them with
    ``encdec.prepare_cross_cache``.  SSM heads' ``ssm_h``/``ssm_conv``
    stay zero, as the reference leaves them (its fault, ROADMAP C): a
    decode after this prefill starts the SSM from an empty state."""
    x, _, kv = forward(cfg, params, batch, window=window, q_chunk=q_chunk,
                       k_chunk=k_chunk, collect_kv=True)
    logits = L.lm_logits(_head(params), params["embed"], x[:, -1:], cfg)
    logits = logits.float() + _vocab_mask(cfg, x.device)
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, S, device=x.device)
    names = (("wkv_state", "tm_prev", "cm_prev") if cfg.rwkv
             else ("ckv", "kpe") if cfg.mla else ("k", "v"))
    for nm, t in zip(names, kv):
        cache[nm] = t.to(cache[nm].dtype)
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return logits, cache
