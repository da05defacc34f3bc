"""Encoder-decoder backbone in PyTorch (SeamlessM4T-medium's text decoder
with its speech encoder; port of ``src/repro/models/encdec.py``).

The audio frontend (mel spectrogram and conv feature extractor) is
stubbed as in the reference: ``encoder_feats`` arrive as precomputed frame
embeddings (B, S_enc, d_model).  The encoder is a bidirectional
transformer; the decoder is ``model.py``'s stack with a cross-attention
sublayer in each layer, between self-attention and the FFN.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import constrain
from repro_torch.train_loop import hook as _gemm_hook


def init_encoder(cfg, gen):
    """The encoder's layers, stacked over ``n_enc_layers``, and its final
    norm, in the reference's layout."""
    dt, dev, lead = L.pdtype_of(cfg), gen.device, (cfg.n_enc_layers,)
    return {
        "layers": {
            "ln1": L.init_rmsnorm(cfg.d_model, dt, dev, lead),
            "attn": A.init_attention(cfg, gen, lead),
            "ln2": L.init_rmsnorm(cfg.d_model, dt, dev, lead),
            "mlp": L.init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, lead),
        },
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, dev),
    }


def init_cross_layer(cfg, gen, lead=()):
    """One cross-attention sublayer (``lead`` prepends axes, as
    ``model.init_layer``'s)."""
    return {"ln": L.init_rmsnorm(cfg.d_model, L.pdtype_of(cfg), gen.device,
                                 lead),
            "attn": A.init_attention(cfg, gen, lead)}


def _enc_span(cfg, lp, x, positions, q_chunk, k_chunk, hook):
    """An encoder layer up to the input of its ``down`` projection:
    returns the residual after attention and silu(gate) * up.  ``hook``
    is the projection hook the forward ran under: a recompute in the
    backward, which autograd may run on its own device thread (where the
    caller's context variables are unset), installs it again."""
    if hook is not None and _gemm_hook.active() is None:
        with _gemm_hook.use_hook(hook):
            return _enc_span(cfg, lp, x, positions, q_chunk, k_chunk, hook)
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    ao, _ = A.attention_block(cfg, lp["attn"], h, positions, causal=False,
                              q_chunk=q_chunk, k_chunk=k_chunk)
    x = x + ao
    return x, L.swiglu_hidden(lp["mlp"], L.rmsnorm(lp["ln2"], x,
                                                   cfg.norm_eps))


def encode(cfg, enc_params, feats, *, q_chunk=256, k_chunk=512):
    """feats: (B,S_enc,d) precomputed frame embeddings -> encoder output.

    The reference runs each layer under ``jax.checkpoint``, so its
    backward re-runs the layer's q, k, v, o, gate and up projections (on
    the fleet, in a fleet session) but not ``down``, whose output the
    backward never reads.  Here, when autograd records, each layer's span
    up to the input of ``down`` is checkpointed, and ``down`` runs outside
    it: the same six projections are recomputed.  The backward's order of
    GEMMs within a layer is autograd's (``down``'s dA and dW, the
    recompute, then the rest), where the reference's follows XLA's
    schedule; the set of GEMMs is the same."""
    x = constrain(feats.to(L.dtype_of(cfg)), "batch", "seq", "embed")
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    hook = _gemm_hook.active()
    for i in range(cfg.n_enc_layers):
        lp = T.map_tree(lambda t: t[i], enc_params["layers"])
        args = (cfg, lp, x, positions, q_chunk, k_chunk, hook)
        if torch.is_grad_enabled():
            x, hf = checkpoint(_enc_span, *args, use_reentrant=False)
        else:
            x, hf = _enc_span(*args)
        x = x + L.pdot(hf, lp["mlp"]["w_down"])
    return L.rmsnorm(enc_params["final_norm"], x, cfg.norm_eps)


def cross_layer(cfg, cp, x, enc_out, *, q_chunk=256, k_chunk=512):
    """Cross-attention sublayer (training, prefill): queries from the
    decoder stream, keys and values from the encoder output."""
    h = L.rmsnorm(cp["ln"], x, cfg.norm_eps)
    kv = A.project_cross_kv(cfg, cp["attn"], enc_out)
    B, S, _ = h.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ao, _ = A.attention_block(cfg, cp["attn"], h, positions, cross_kv=kv,
                              q_chunk=q_chunk, k_chunk=k_chunk)
    return x + ao


def cross_layer_decode(cfg, cp, x, cross_kv):
    """Decode-time cross-attention against precomputed (k, v)."""
    h = L.rmsnorm(cp["ln"], x, cfg.norm_eps)
    ao, _, _ = A.attention_decode(cfg, cp["attn"], h, None, None, None,
                                  None, None, cross_kv=cross_kv)
    return x + ao


def prepare_cross_cache(cfg, params, feats):
    """Each decoder layer's cross K/V from the encoder output, stacked
    (L,B,S_enc,K,hd) (a decode session's set-up)."""
    enc_out = encode(cfg, params["encoder"], feats)
    ks, vs = zip(*(A.project_cross_kv(cfg, attn, enc_out) for attn in (
        T.map_tree(lambda t: t[i], params["cross"]["attn"])
        for i in range(cfg.n_layers))))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_cache(cfg, params, toks, feats, cache_len, *, kv_quant=False):
    """The monolithic serving set-up: a decode cache of ``cache_len``
    slots holding the cross K/V of the encoder frames ``feats``, and the
    self-attention K/V and position of a prefill of ``toks`` (B,P) over
    them.  Returns (the prefill's logits, the cache).  With ``kv_quant``
    the cache is int8 and its self K/V stay empty at position 0, since
    only ``decode_step`` writes int8 K/V: the caller feeds the prompt
    through it."""
    from repro_torch.models import model as M   # model.py imports us
    B, P = toks.shape
    cache = M.init_cache(cfg, B, cache_len, enc_len=feats.shape[1],
                         kv_quant=kv_quant, device=toks.device)
    cache["cross_k"], cache["cross_v"] = prepare_cross_cache(cfg, params,
                                                             feats)
    logits, pre = M.prefill(cfg, params, {"tokens": toks,
                                          "encoder_feats": feats})
    if not kv_quant:
        for nm in ("k", "v"):
            cache[nm][:, :, :P] = pre[nm]
        cache["pos"] = pre["pos"]
    return logits, cache
