"""RWKV-6 "Finch" in PyTorch: time mix with a data-dependent per-channel
decay, and channel mix (port of ``src/repro/models/rwkv.py``).
Attention-free; the decode state is O(1).

Recurrence per head (hd x hd state S)::

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

:func:`wkv_chunked` runs it through the WKV kernel (``ops.wkv6``) forward
and differentiates the chunked torch body backward.  The mixing
projections are plain ``x @ w`` products, as in the reference: they are
not fleet GEMMs (``pdot``), so a fleet session leaves them on the PS.
"""
from __future__ import annotations

import torch

from repro_torch import ieee_f32
from repro_torch.core.spans import span
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models import layers as L


def _heads(cfg):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_time_mix(cfg, gen, lead=()):
    d = cfg.d_model
    H, hd = _heads(cfg)
    dt = L.pdtype_of(cfg)
    dev = gen.device
    lead = tuple(lead)
    lora = max(16, d // 64)

    def uniform(shape):
        return torch.rand(lead + shape, generator=gen, device=dev)

    return {
        # token-shift interpolation weights (static mu per stream)
        "mu": (uniform((5, d)) * 0.5 + 0.25).to(dt),
        "w_r": L.dense_init(gen, d, d, dt, lead=lead),
        "w_k": L.dense_init(gen, d, d, dt, lead=lead),
        "w_v": L.dense_init(gen, d, d, dt, lead=lead),
        "w_g": L.dense_init(gen, d, d, dt, lead=lead),
        # data-dependent decay (lora): w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full(lead + (d,), -2.0, dtype=torch.float32, device=dev),
        "wA": L.dense_init(gen, d, lora, dt, lead=lead),
        "wB": L.normal(gen, lead + (lora, d), 0.01, dt),
        "u": L.normal(gen, lead + (H, hd), 0.1, torch.float32),
        "w_o": L.dense_init(gen, d, d, dt, lead=lead),
        "ln_x": L.init_groupnorm(H, d, dt, dev, lead),
    }


def init_channel_mix(cfg, gen, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    dt = L.pdtype_of(cfg)
    lead = tuple(lead)
    mu = torch.rand(lead + (2, d), generator=gen, device=gen.device)
    return {
        "mu": (mu * 0.5 + 0.25).to(dt),
        "w_k": L.dense_init(gen, d, ff, dt, lead=lead),
        "w_v": L.dense_init(gen, ff, d, dt, lead=lead),
        "w_r": L.dense_init(gen, d, d, dt, lead=lead),
    }


def _token_shift(x, prev):
    """prev: (B,d) last token of the previous step or segment (zeros at the
    start)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


class _WKV(torch.autograd.Function):
    """Forward: the WKV kernel (``ops.wkv6``), y and the last state.
    Backward: the gradient of :func:`wkv6_plain` over the same chunks,
    recomputed from the saved inputs -- the counterpart of the reference's
    remat'd ``chunk_step``; the Pallas kernel has no backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.chunk = chunk
        return ops.wkv6(r, k, v, w, u, s0=s0, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        if gy.is_cuda:
            ieee_f32()          # the recompute's einsums, in IEEE f32
        with torch.enable_grad(), \
                span("rwkv.wkv_backward"):
            y, s = wkv6_plain(*leaves, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, s), leaves, (gy, gs))
        return (*grads, None)


def wkv_chunked(r, k, v, w, u, s0, chunk=32):
    """Chunked WKV-6.  r,k,v: (B,S,H,hd); w: (B,S,H,hd) decay in (0,1);
    u: (H,hd); s0: (B,H,hd,hd).  Returns (y (B,S,H,hd) float32, s_last).
    Chunks of ``c = chunk`` steps when S is a multiple of ``chunk``, else
    one chunk of S (the reference's rule); the CUDA kernel takes chunks of
    at most 32 steps whatever c is (the same recurrence, rounded in
    another order)."""
    S = r.shape[1]
    c = chunk if (S % chunk == 0 and S >= chunk) else S
    return _WKV.apply(r, k, v, w, u, s0.float(), c)


def _tm_streams(p, x, shifted):
    """Interpolate the 5 time-mix input streams (r,k,v,g,w)."""
    mu = p["mu"].float()
    xf, sf = x.float(), shifted.float()
    return [(xf + (sf - xf) * mu[i]).to(x.dtype) for i in range(5)]


def time_mix(cfg, p, x, prev_token, s0, chunk=32):
    """x: (B,S,d); prev_token: (B,d); s0: (B,H,hd,hd).
    Returns (out, last_token, s_last)."""
    B, S, d = x.shape
    H, hd = _heads(cfg)
    shifted = _token_shift(x, prev_token)
    xr, xk, xv, xg, xw = _tm_streams(p, x, shifted)
    r = L.matmul(xr, p["w_r"]).reshape(B, S, H, hd)
    k = L.matmul(xk, p["w_k"]).reshape(B, S, H, hd)
    v = L.matmul(xv, p["w_v"]).reshape(B, S, H, hd)
    g = torch.nn.functional.silu(L.matmul(xg, p["w_g"]).float())
    # Finch data-dependent decay, in f32
    ww = p["w0"] + torch.tanh(xw.float() @ p["wA"].float()) \
        @ p["wB"].float()
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, hd)    # in (0, 1)
    y, s_last = wkv_chunked(r, k, v, w, p["u"], s0, chunk)
    y = L.groupnorm(p["ln_x"], y.reshape(B, S, d), H, cfg.norm_eps)
    y = (y.float() * g).to(x.dtype)
    return L.matmul(y, p["w_o"]), x[:, -1], s_last


def channel_mix(cfg, p, x, prev_token):
    shifted = _token_shift(x, prev_token)
    mu = p["mu"].float()
    xf, sf = x.float(), shifted.float()
    xk = (xf + (sf - xf) * mu[0]).to(x.dtype)
    xr = (xf + (sf - xf) * mu[1]).to(x.dtype)
    k = torch.square(torch.relu(L.matmul(xk, p["w_k"]).float())).to(x.dtype)
    v = L.matmul(k, p["w_v"])
    rgate = torch.sigmoid(L.matmul(xr, p["w_r"]).float()).to(x.dtype)
    return v * rgate, x[:, -1]
