"""Plain PyTorch versions of the port's kernels (the allclose targets)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def matmul_ref(a, b, out_dtype=None):
    out = torch.matmul(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


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
