"""Mamba-style selective SSM, Hymba's SSM heads (port of
``src/repro/models/ssm.py``).

Recurrence: h_t = exp(-softplus(dt_t) * A) * h_{t-1} + dt_t * B_t * x_t,
y_t = C_t . h_t + D * x_t, with per-channel state size N.  Training runs
a chunked associative scan, decode carries (h, conv window) state.

The scan is plain torch: the reference has no Pallas kernel for it.
Inside a chunk it takes ``jax.lax.associative_scan``'s odd/even recursion
(:func:`_assoc_scan`), so the products combine in the reference's order;
across chunks a Python loop carries h, as ``lax.scan`` does.  Every
projection here multiplies with ``L.matmul``, not ``L.pdot``: as the
reference's ``@``, they run on the PS and never on the fleet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import ieee_f32
from repro_torch.core.spans import span
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import is_dtensor


def init_ssm(cfg, gen, lead=()):
    """The reference's leaves and dtypes: the projections, the conv and
    ``dt_bias`` in the param dtype, ``A_log`` (log 1..N per channel) and
    ``D`` (ones) in float32 whatever the param dtype is."""
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dt = L.pdtype_of(cfg)
    dev = gen.device
    lead = tuple(lead)
    dt_rank = max(1, d // 16)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "w_in": L.dense_init(gen, d, 2 * di, dt, lead=lead),
        "conv": L.normal(gen, lead + (K, di), 1.0 / np.sqrt(K), dt),
        "conv_b": torch.zeros(lead + (di,), dtype=dt, device=dev),
        "w_bc": L.dense_init(gen, di, 2 * N, dt, lead=lead),
        "w_dt1": L.dense_init(gen, di, dt_rank, dt, lead=lead),
        "w_dt2": L.dense_init(gen, dt_rank, di, dt, lead=lead),
        "dt_bias": torch.full(lead + (di,), -4.6, dtype=dt, device=dev),
        "A_log": a_log.expand(lead + (di, N)).clone(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "w_out": L.dense_init(gen, di, d, dt, lead=lead),
    }


def _conv1d(p, u, conv_state=None):
    """Depthwise causal conv.  u: (B,S,di); conv_state: (B,K-1,di) or
    None.  Returns (out, the last K-1 inputs); the taps sum in the
    reference's order."""
    K = p["conv"].shape[0]
    if conv_state is None:
        pad = torch.zeros(u.shape[:1] + (K - 1,) + u.shape[2:], dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = sum(up[:, i:i + S] * p["conv"][i] for i in range(K))
    new_state = up[:, -(K - 1):] if K > 1 else None
    return out + p["conv_b"], new_state


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _selective(cfg, p, u):
    """u: (B,S,di) post-conv activations -> (dt (B,S,di), A (di,N), u
    and B (B,S,N) and C (B,S,N)), all float32: what the decay and the
    drive are made of."""
    N = cfg.ssm_state
    bc = L.matmul(u, p["w_bc"])
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt_ = _softplus(L.matmul(L.matmul(u, p["w_dt1"]), p["w_dt2"]).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    return dt_, A, u.float(), Bm.float(), Cm.float()


def _decay_drive(dt_, A, uf, Bm):
    """The (B,S,di,N) decay a and drive b."""
    a = torch.exp(dt_[..., None] * A)
    b = (dt_ * uf)[..., None] * Bm[..., None, :]
    return a, b


def _ssm_inputs(cfg, p, u):
    """u: (B,S,di) post-conv activations -> (decay a, drive b, C)."""
    dt_, A, uf, Bm, Cm = _selective(cfg, p, u)
    a, b = _decay_drive(dt_, A, uf, Bm)
    return a, b, Cm


def _interleave(even, odd):
    """Elements of ``even`` at the even indices of dim 1, of ``odd`` at
    the odd ones (``even`` as long as ``odd`` or one longer)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def _combine(al, bl, ar, br):
    return al * ar, bl * ar + br


def _assoc_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the half-length sequence, then fill in the even positions.  Returns
    the scanned (a, b)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _scan_chunk(h, ac, bc, cc):
    """The reference's ``chunk_step``: the carry enters as a pseudo-step
    on the first drive, then the chunk's scan; with ``cc`` (B,c,N) the
    states are contracted against C.  Returns (h_last, y or states)."""
    bc0 = torch.cat([bc[:, :1] + ac[:, :1] * h[:, None], bc[:, 1:]], dim=1)
    _, hs = _assoc_scan(ac, bc0)
    if cc is None:
        return hs[:, -1], hs
    return hs[:, -1], torch.einsum("bcdn,bcn->bcd", hs, cc)


def _chunk_len(S, chunk):
    return chunk if (S % chunk == 0 and S >= chunk) else S


def ssm_scan_chunked(a, b, h0, chunk: int, Cm=None):
    """Linear recurrence h_t = a_t*h_{t-1} + b_t by chunked associative
    scan.  a, b: (B,S,di,N); h0: (B,di,N).  Chunks of ``chunk`` steps
    when S is a multiple of it, else one chunk of S.  With ``Cm`` (B,S,N)
    the states are contracted against C inside each chunk and (y
    (B,S,di), h_last) come back; otherwise (h_all (B,S,di,N), h_last).
    ``ssm_block`` builds a and b inside each chunk instead
    (:class:`_SelectiveScan`)."""
    if a.is_cuda:
        ieee_f32()
    c = _chunk_len(a.shape[1], chunk)
    h, ys = h0, []
    for j in range(0, a.shape[1], c):
        h, y = _scan_chunk(h, a[:, j:j + c], b[:, j:j + c],
                           None if Cm is None else Cm[:, j:j + c])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _drive_chunk(h, A, dt_, uf, Bm, Cm):
    """One chunk of the selective scan from its small inputs: a and b
    made here, then :func:`_scan_chunk` against C."""
    a, b = _decay_drive(dt_, A, uf, Bm)
    return _scan_chunk(h, a, b, Cm)


class _SelectiveScan(torch.autograd.Function):
    """The chunked selective scan from (dt, A, u, B, C), memory-bounded as
    the reference's remat'd ``chunk_step``.  Forward: the chunks one
    after another, each building its (B,c,di,N) decay and drive and
    dropping them; it saves its small inputs and the state entering each
    chunk.  Backward: the chunks in reverse order, each recomputed from
    those and differentiated alone, so no level of the scan, and no a or
    b beyond one chunk's, outlives its chunk."""

    @staticmethod
    def forward(ctx, dt_, A, uf, Bm, Cm, h0, c):
        h, ys, hs = h0, [], []
        with span("ssm.scan"):
            for j in range(0, dt_.shape[1], c):
                hs.append(h)
                h, y = _drive_chunk(h, A, dt_[:, j:j + c], uf[:, j:j + c],
                                    Bm[:, j:j + c], Cm[:, j:j + c])
                ys.append(y)
        ctx.save_for_backward(dt_, A, uf, Bm, Cm, *hs)
        ctx.c = c
        return torch.cat(ys, dim=1), h

    @staticmethod
    def backward(ctx, gy, gh):
        dt_, A, uf, Bm, Cm, *hs = ctx.saved_tensors
        c = ctx.c
        if gy.is_cuda:
            ieee_f32()          # the recompute's einsums, in IEEE f32
        g_seq = {n: [] for n in ("dt", "u", "B", "C")}
        gA = torch.zeros_like(A)
        with torch.enable_grad(), \
                span("ssm.scan_backward"):
            for i in reversed(range(len(hs))):
                j = i * c
                leaves = [t.detach().requires_grad_() for t in (
                    hs[i], A, dt_[:, j:j + c], uf[:, j:j + c],
                    Bm[:, j:j + c], Cm[:, j:j + c])]
                h, y = _drive_chunk(*leaves)
                g = torch.autograd.grad((h, y), leaves,
                                        (gh, gy[:, j:j + c]))
                gh = g[0]
                gA = gA + g[1]
                for n, t in zip(g_seq, g[2:]):
                    g_seq[n].insert(0, t)
        return (torch.cat(g_seq["dt"], 1), gA, torch.cat(g_seq["u"], 1),
                torch.cat(g_seq["B"], 1), torch.cat(g_seq["C"], 1), gh, None)


def ssm_block(cfg, p, x, chunk=64):
    """Training/prefill.  x: (B,S,d) -> (B,S,d).  On a mesh each rank
    scans its batch rows (``spmd.on_batch_rows``)."""
    if is_dtensor(x):
        from repro_torch.parallel import spmd
        return spmd.on_batch_rows(
            lambda xl, pl: ssm_block(cfg, pl, xl, chunk), [x], p, 1)[0]
    if x.is_cuda:
        ieee_f32()
    B = x.shape[0]
    di, N = cfg.d_inner, cfg.ssm_state
    xz = L.matmul(x, p["w_in"])
    u, z = torch.chunk(xz, 2, dim=-1)
    u, _ = _conv1d(p, u)
    u = torch.nn.functional.silu(u.float()).to(x.dtype)
    dt_, A, uf, Bm, Cm = _selective(cfg, p, u)
    h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    y, _ = _SelectiveScan.apply(dt_, A, uf, Bm, Cm, h0,
                                _chunk_len(x.shape[1], chunk))
    y = y + p["D"] * uf
    y = (y * torch.nn.functional.silu(z.float())).to(x.dtype)
    return L.matmul(y, p["w_out"])


def ssm_decode(cfg, p, x, h, conv_state):
    """One-step decode.  x: (B,1,d); h: (B,di,N); conv_state: (B,K-1,di).
    Returns (out, h, conv_state)."""
    if x.is_cuda:
        ieee_f32()
    with span("ssm.decode"):
        xz = L.matmul(x, p["w_in"])
        u, z = torch.chunk(xz, 2, dim=-1)
        u, conv_state = _conv1d(p, u, conv_state)
        u = torch.nn.functional.silu(u.float()).to(x.dtype)
        a, b, Cm = _ssm_inputs(cfg, p, u)
        h = a[:, 0] * h + b[:, 0]
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
        y = y + p["D"] * u.float()
        y = (y * torch.nn.functional.silu(z.float())).to(x.dtype)
        return L.matmul(y, p["w_out"]), h, conv_state


def init_ssm_cache(cfg, batch, dtype=torch.float32, device="cuda"):
    """One layer's decode state: h (B,d_inner,N) f32 and the conv window
    (B,K-1,d_inner) in ``dtype``."""
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }
