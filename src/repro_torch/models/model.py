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
import torch.utils.checkpoint

from repro_torch import tree as T
from repro_torch.core.spans import span
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SSM
from repro_torch.parallel.sharding import (constrain, current_rules,
                                           is_dtensor, use_rules)


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
        if is_dtensor(x):
            # on a mesh each rank runs the recurrence over its batch rows
            from repro_torch.parallel import spmd
            x, *states = spmd.on_batch_rows(
                lambda xl, pl: _rwkv_layer(cfg, pl, xl), [x], p, 4)
        else:
            x, *states = _rwkv_layer(cfg, p, x)
        return x, aux, tuple(states)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    # fsdp mode: gather the residual's feature dim once per layer here
    h = constrain(h, "batch", "seq", "embed_use")
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
        return x + mo, (a if is_dtensor(a) else aux + a), kv
    return x + L.swiglu(p["mlp"], h2), aux, kv


def _rwkv_layer(cfg, p, x):
    """An RWKV layer over a full sequence from zero states: (x,
    s_last, tm_last, cm_last)."""
    B = x.shape[0]
    H = cfg.d_model // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    zt = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
    # the reference normalises with rmsnorm's default eps here and with
    # cfg.norm_eps in decode_step; mirrored as written
    h1 = L.rmsnorm(p["ln1"], x)
    tm, tm_last, s_last = R.time_mix(cfg, p["time_mix"], h1, zt, s0,
                                     chunk=32)
    x = x + tm
    h2 = L.rmsnorm(p["ln2"], x)
    cm, cm_last = R.channel_mix(cfg, p["channel_mix"], h2, zt)
    return x + cm, s_last, tm_last, cm_last


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
    if is_dtensor(x) and not is_dtensor(positions):
        positions = _batch_sharded(positions)
    return constrain(x, "batch", "seq", "embed"), positions


def _batch_sharded(t):
    """A tensor that every rank holds whole, as a DTensor with its first
    dim on the batch axes (each rank keeps its rows; nothing moves)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import constrained_spec, placements
    rules = current_rules()
    spec = constrained_spec(rules, t.shape, "batch")
    return distribute_tensor(t.contiguous(), rules.mesh,
                             placements(spec, rules.mesh),
                             src_data_rank=None)


def forward(cfg, params, batch, *, window=0, q_chunk=256, k_chunk=512,
            collect_kv=False, remat=True):
    """Full forward to the final hidden states.  Returns (x, aux, kv): the
    layers' summed MoE load-balancing loss, and the layers' ``(k, v)`` --
    for MLA ``(c_kv, k_pe)``, for RWKV ``(wkv_state, tm_prev, cm_prev)``
    -- stacked over layers when ``collect_kv``.  The encoder-decoder
    encodes ``batch["encoder_feats"]`` first and runs each decoder
    layer's cross-attention over the encoder output.

    ``remat`` (the reference's default, its ``jax.checkpoint`` of the
    scanned layer) keeps only each layer's input for the backward and
    recomputes the layer there; the values do not change.  The fleet
    path passes ``remat=False``, as the reference's unrolled
    ``scan_layers=False`` path runs without remat."""
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
        opts = dict(window=window, q_chunk=q_chunk, k_chunk=k_chunk,
                    cross_fn=cross_fn)
        if remat and torch.is_grad_enabled():
            x, a, kv = _checkpoint(layer_forward, cfg,
                                   layer_params(params, i), x, positions,
                                   **opts)
        else:
            x, a, kv = layer_forward(cfg, layer_params(params, i), x,
                                     positions, **opts)
        aux = a if is_dtensor(a) and not is_dtensor(aux) else aux + a
        if collect_kv:
            per_layer.append(kv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    kv = tuple(torch.stack(t) for t in zip(*per_layer)) if collect_kv \
        else ()
    return x, aux, kv


def _checkpoint(fn, *args, **kwargs):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant).  The
    recompute runs in the backward, on autograd's thread for the card,
    so it re-enters the mesh rules active now (they are thread-local)."""
    rules = current_rules()

    def run(*a, **k):
        with use_rules(rules):
            return fn(*a, **k)
    return torch.utils.checkpoint.checkpoint(run, *args,
                                             use_reentrant=False, **kwargs)


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
            loss_chunk=256, remat=True):
    """Mean cross-entropy over valid labels (labels < 0 are masked),
    computed over ``S // loss_chunk`` sequence chunks one after another so
    the (B, S, V) logits never exist at once.  Returns
    ``(loss + aux, {"loss", "aux_loss", "tokens"})``, ``aux`` the MoE
    load-balancing loss summed over layers (zero for the dense and RWKV
    families).  ``remat`` as in :func:`forward`."""
    x, aux, _ = forward(cfg, params, batch, window=window, q_chunk=q_chunk,
                        k_chunk=k_chunk, remat=remat)
    labels = batch["labels"].long()
    B, S = labels.shape
    c = loss_chunk if (S % loss_chunk == 0 and S >= loss_chunk) else S
    nc = S // c
    if is_dtensor(x):
        return _loss_sharded(cfg, params, x, aux, labels, c, remat)
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


def _loss_sharded(cfg, params, x, aux, labels, c, remat=True):
    """:func:`loss_fn`'s chunks on a mesh: each chunk's logits stay
    vocab-sharded (batch on the batch axes), and the cross-entropy runs on
    each rank's block (``_xent_block``): the max, the sum of exponentials
    and the picked logit combine over 'model'.  With ``remat`` each chunk
    is recomputed in the backward, as the reference's remat'd chunk scan,
    so one chunk's logits live at a time."""
    from repro_torch.parallel import spmd
    from repro_torch.parallel.sharding import constrained_spec, placements
    rules = current_rules()
    mesh = rules.mesh
    B, S = labels.shape
    tot = cnt = None

    def chunk(head, embed, xc, lc):
        logits = L.lm_logits(head, embed, xc, cfg)
        spec = constrained_spec(rules, logits.shape, "batch", "seq",
                                "vocab")
        tail = placements((spec[0],), mesh)
        fn = spmd.region(
            lambda lg, lb: _xent_block(cfg, mesh, spec[2], lg, lb), mesh,
            (placements(spec, mesh), placements((spec[0], None), mesh)),
            [_partial_over_batch(tail), _partial_over_batch(tail)])
        return tuple(fn(logits, lc))

    for j in range(S // c):
        args = (_head(params), params["embed"], x[:, j * c:(j + 1) * c],
                labels[:, j * c:(j + 1) * c])
        if remat and torch.is_grad_enabled():
            t, n = _checkpoint(chunk, *args)
        else:
            t, n = chunk(*args)
        tot = t if tot is None else tot + t
        cnt = n if cnt is None else cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": cnt}


def _partial_over_batch(pl):
    """Placements of a scalar summed over the batch axes' ranks:
    ``Partial`` where ``pl`` shards, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)


def _xent_block(cfg, mesh, vocab_axis, logits, labels):
    """One rank's share of a chunk's summed cross-entropy and label
    count: logits (Bl, c, V or V/n) hold this rank's vocab rows when
    ``vocab_axis`` names a mesh axis."""
    from repro_torch.parallel import spmd
    V = L.padded_vocab(cfg)
    lo, hi = (spmd.block_range(V, mesh, vocab_axis) if vocab_axis
              else (0, V))
    dev = logits.device
    s = logits.float() + _vocab_mask(cfg, dev)[lo:hi]
    m = s.amax(dim=-1).detach()
    if vocab_axis:
        m = spmd.pmax(m, mesh, vocab_axis)
    se = torch.exp(s - m[..., None]).sum(dim=-1)
    lab = torch.clamp(labels.long(), min=0)
    mine = (lab >= lo) & (lab < hi)
    picked = torch.gather(s, -1, torch.clamp(lab - lo, 0, hi - lo - 1)
                          [..., None])[..., 0] * mine
    if vocab_axis:
        se = spmd.psum(se, mesh, vocab_axis)
        picked = spmd.psum(picked, mesh, vocab_axis)
    lse = m + torch.log(se)
    w = (labels >= 0).float()
    return torch.sum((lse - picked) * w), torch.sum(w)


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
    with span("ps.forward"):
        loss, metrics = loss_fn(cfg, T.unflatten(keys, leaves), batch,
                                **chunks)
    with span("ps.backward"):
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
    cache = constrain_cache(cache)
    B = tokens.shape[0]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    pos_in = cache["pos"]
    # on a mesh the position is replicated: every rank reads it whole
    pos = pos_in.to_local() if is_dtensor(pos_in) else pos_in
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
    logits = _masked_logits(cfg, L.lm_logits(_head(params), params["embed"],
                                             x, cfg))

    new_cache = dict(cache)
    bidx = torch.arange(B, device=pos.device)
    for nm in (news[0] if news else ()):
        upd = torch.stack([n[nm] for n in news]).to(cache[nm].dtype)
        if is_dtensor(cache[nm]):
            from repro_torch.parallel import spmd
            new_cache[nm] = spmd.write_at(cache[nm], upd, slot, 2)
            continue
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
    new_cache["pos"] = pos_in + 1
    return logits, constrain_cache(new_cache)


def _masked_logits(cfg, logits):
    """Logits in f32 with the padded vocab rows at NEG_INF (a replicated
    mask on a mesh)."""
    vmask = _vocab_mask(cfg, logits.device)
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate, distribute_tensor
        vmask = distribute_tensor(vmask, logits.device_mesh,
                                  (Replicate(),) * logits.device_mesh.ndim,
                                  src_data_rank=None)
    return logits.float() + vmask


def constrain_cache(c):
    """The decode cache's leaves at their logical layout (a no-op
    outside a mesh)."""
    out = dict(c)
    for name in ("k", "v"):
        if name in c:
            out[name] = constrain(c[name], None, "cache_batch", "cache_seq",
                                  "kv_heads", "head_dim")
    for name in ("k_scale", "v_scale"):
        if name in c:
            out[name] = constrain(c[name], None, "cache_batch", "cache_seq",
                                  "kv_heads")
    for name in ("ckv", "kpe"):
        if name in c:
            out[name] = constrain(c[name], None, "cache_batch", "cache_seq",
                                  None)
    for name in ("cross_k", "cross_v"):
        if name in c:
            out[name] = constrain(c[name], None, "cache_batch", None,
                                  "kv_heads", "head_dim")
    if "wkv_state" in c:
        out["wkv_state"] = constrain(c["wkv_state"], None, "cache_batch",
                                     "heads", None, None)
    if "ssm_h" in c:
        out["ssm_h"] = constrain(c["ssm_h"], None, "cache_batch", "ffn",
                                 None)
    return out


def _rwkv_decode_step(cfg, params, cache, tokens):
    x = L.embed_tokens(params["embed"], tokens, cfg)
    news = []
    for i in range(cfg.n_layers):
        states = [cache[nm][i] for nm in ("tm_prev", "wkv_state",
                                          "cm_prev")]
        if is_dtensor(x):
            # on a mesh each rank steps its batch rows' states
            from repro_torch.parallel import spmd
            x, *new = spmd.on_batch_rows(
                lambda xl, tl, sl, cl, pl: _rwkv_decode_layer(
                    cfg, pl, xl, tl, sl, cl),
                [x] + states, layer_params(params, i), 4)
        else:
            x, *new = _rwkv_decode_layer(cfg, layer_params(params, i), x,
                                         *states)
        news.append(new)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _masked_logits(cfg, L.lm_logits(_head(params), params["embed"],
                                             x, cfg))
    new_cache = dict(cache)
    # recurrent states are replaced wholesale (they are small)
    for nm, vals in zip(("wkv_state", "tm_prev", "cm_prev"), zip(*news)):
        new_cache[nm] = torch.stack(vals).to(cache[nm].dtype)
    new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache


def _rwkv_decode_layer(cfg, lp, x, tm_prev, wkv_state, cm_prev):
    """One RWKV layer's decode step: (x, the new WKV state, the last
    normed inputs of the two token shifts)."""
    hq = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    y, _, s_last = R.time_mix(cfg, lp["time_mix"], hq, tm_prev, wkv_state,
                              chunk=1)
    x = x + y
    h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    cm, _ = R.channel_mix(cfg, lp["channel_mix"], h2, cm_prev)
    return x + cm, s_last, hq[:, -1], h2[:, -1]


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
    logits = _masked_logits(cfg, L.lm_logits(_head(params), params["embed"],
                                             x[:, -1:], cfg))
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, S, device=x.device)
    names = (("wkv_state", "tm_prev", "cm_prev") if cfg.rwkv
             else ("ckv", "kpe") if cfg.mla else ("k", "v"))
    for nm, t in zip(names, kv):
        cache[nm] = t.to(cache[nm].dtype)
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=x.device)
    return logits, cache
