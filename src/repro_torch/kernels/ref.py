"""Plain PyTorch versions of the port's kernels (the allclose targets)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def matmul_ref(a, b, out_dtype=None):
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def bmm_ref(a, b, out_dtype=None):
    """C[g] = A[g] @ B[g] of the operands' values, summed in f32."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"bmm_ref needs (G,m,k)·(G,k,n); got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    out = torch.bmm(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def attention_ref(q, k, v, *, causal=True, window=0):
    """Naive masked softmax attention.  q: (BH,Sq,D); k,v: (BH,Sk,D).
    Returns q's dtype."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None], p, torch.zeros_like(p))
    out = torch.einsum("hqk,hkd->hqd", p, v.float())
    return out.to(q.dtype)


def paged_decode_ref(q, k_pool, v_pool, page_table, lengths):
    """Single-token GQA decode over paged pools: gather every request's
    pages into a contiguous view, then dense masked softmax attention in
    f32 (probabilities rounded to the pool dtype before the V product, as
    the kernels do).  q: (B,K,G,D); pools: (P,page,K,D); page_table:
    (B,maxp); lengths: (B,).  Returns (B,K,G,D) in the pool dtype; a
    request of length 0 gives zeros."""
    B, K, G, D = q.shape
    page = k_pool.shape[1]
    pt = page_table.long()
    S = pt.shape[1] * page
    k = k_pool[pt].reshape(B, S, K, D).float()
    v = v_pool[pt].reshape(B, S, K, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float() / math.sqrt(D), k)
    ok = (torch.arange(S, device=q.device)[None, :]
          < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.exp(s - m) * ok
    l = p.sum(dim=-1, keepdim=True)
    p = p.to(v_pool.dtype).float()
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return (out / torch.clamp(l, min=1e-30)).to(v_pool.dtype)


def wkv6_ref(r, k, v, w, u):
    """Step-exact RWKV-6 recurrence (the oracle of the WKV kernel).
    r,k,v,w: (BH,S,hd); u: (BH,hd).  Returns float32 (BH,S,hd):
    ``y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)``,
    ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``, from a zero state."""
    BH, S, hd = r.shape
    r_, k_, v_, w_ = (a.float() for a in (r, k, v, w))
    u_ = u.float()
    s = torch.zeros((BH, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = k_[:, t, :, None] * v_[:, t, None, :]      # (BH, hd, hd)
        ys.append(torch.einsum("bd,bde->be", r_[:, t],
                               s + u_[:, :, None] * kv))
        s = w_[:, t, :, None] * s + kv
    return torch.stack(ys, dim=1)
