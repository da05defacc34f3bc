"""Plain reference of a DeepSeek-V2 decoder (arXiv:2405.04434) as the
configuration file states it: multi-head latent attention (low-rank
queries and a shared latent key/value with a decoupled rotary key),
then a mixture of experts with shared experts.

Departures from the paper, as the configuration records them (its
``port_runs`` gives the port's values over the published ones): every
layer is a MoE layer; the top-k weights are renormalised to sum to 1 and
not scaled; routing is plain greedy top-k, with no expert groups; the
load-balancing loss is the Switch form over the batch; experts hold
``ceil(T k c / E)`` slots (c the capacity factor) and an assignment past
them is dropped, the first tokens in sequence order kept; RoPE is plain
(no YaRN) in the rotate-half convention.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from reference.common import BF16, F32, embed, lm_loss, remat, rmsnorm, rotate


# what this reference computes, in the configuration's keys: MoE layers
# alone, routed greedily
COMPUTES = {"first_k_dense_replace": 0, "topk_method": "greedy",
            "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
            "routed_scaling_factor": 1, "seq_aux": False}


def as_run(cfg: Dict) -> Dict:
    """The configuration with the port's departures (``port_runs``) over
    the published values; refuses a model this reference does not
    compute."""
    run = {**cfg, **cfg.get("port_runs", {})}
    wrong = {k: run[k] for k, v in COMPUTES.items()
             if k in run and run[k] != v}
    if wrong:
        raise NotImplementedError(f"the reference computes {COMPUTES}, "
                                  f"not {wrong}")
    return run


def dims(cfg: Dict) -> Dict:
    return dict(d=cfg["hidden_size"], H=cfg["num_attention_heads"],
                hd=cfg["qk_nope_head_dim"], rd=cfg["qk_rope_head_dim"],
                vd=cfg["v_head_dim"], r=cfg["kv_lora_rank"],
                rq=cfg["q_lora_rank"], E=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], ff=cfg["moe_intermediate_size"],
                ns=cfg["n_shared_experts"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"])


def layout(cfg: Dict):
    """Every leaf: (path, shape, dtype, init), init ("normal", std),
    ("const", value).  Layers are stacked on a leading axis."""
    n = dims(cfg)
    d, H, hd, rd, vd, r, rq = (n[x] for x in ("d", "H", "hd", "rd", "vd",
                                               "r", "rq"))
    E, ff, L, V = n["E"], n["ff"], n["L"], n["V"]
    sff = n["ns"] * ff

    def dense(fan_in, fan_out):
        return ((L, fan_in, fan_out), BF16, ("normal", 1 / math.sqrt(fan_in)))

    def ones(w):
        return ((L, w), BF16, ("const", 1.0))

    a, m = ("layers", "attn"), ("layers", "moe")
    rows = [
        (("embed", "tok"), (V, d), BF16, ("normal", 0.02)),
        (("final_norm", "scale"), (d,), BF16, ("const", 1.0)),
        (("head", "w"), (d, V), BF16, ("normal", 1 / math.sqrt(d))),
        (("layers", "ln1", "scale"),) + ones(d),
        (("layers", "ln2", "scale"),) + ones(d),
        (a + ("w_dq",),) + dense(d, rq),
        (a + ("q_norm", "scale"),) + ones(rq),
        (a + ("w_uq",),) + dense(rq, H * (hd + rd)),
        (a + ("w_dkv",),) + dense(d, r + rd),
        (a + ("kv_norm", "scale"),) + ones(r),
        (a + ("w_uk",),) + dense(r, H * hd),
        (a + ("w_uv",),) + dense(r, H * vd),
        (a + ("wo",),) + dense(H * vd, d),
        (m + ("router",), (L, d, E), F32, ("normal", 1 / math.sqrt(d))),
        (m + ("w_gate",), (L, E, d, ff), BF16, ("normal", 1 / math.sqrt(d))),
        (m + ("w_up",), (L, E, d, ff), BF16, ("normal", 1 / math.sqrt(d))),
        (m + ("w_down",), (L, E, ff, d), BF16, ("normal", 1 / math.sqrt(ff))),
        (m + ("shared", "w_gate"),) + dense(d, sff),
        (m + ("shared", "w_up"),) + dense(d, sff),
        (m + ("shared", "w_down"),) + dense(sff, d),
    ]
    return rows


# ------------------------------------------------------------ FLOPs --

def matmul_params(cfg: Dict) -> int:
    """Parameters a token multiplies by: the projections of every layer
    (the routed experts it is sent to, the shared experts, the router)
    and the LM head; the embedding's lookup is not a product."""
    n = dims(cfg)
    d, H, hd, rd, vd, r, rq = (n[x] for x in ("d", "H", "hd", "rd", "vd",
                                               "r", "rq"))
    attn = (d * rq + rq * H * (hd + rd) + d * (r + rd) + r * H * (hd + vd)
            + H * vd * d)
    moe = d * n["E"] + (n["k"] + n["ns"]) * 3 * d * n["ff"]
    return n["L"] * (attn + moe) + d * n["V"]


def mixer_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Forward FLOPs of causal attention's score and value products."""
    n = dims(cfg)
    pairs = seq * (seq + 1) / 2
    return n["L"] * 2.0 * batch * n["H"] * pairs * (n["hd"] + n["rd"]
                                                    + n["vd"])


# ------------------------------------------------------------ model --

def _attend(q, k, v, q0):
    """Causal softmax attention in f32 of the queries at positions
    q0 .. q0 + len(q) over every key; q (B,c,H,Dk), k (B,S,H,Dk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bshd->bhqs", q.float() * scale, k.float())
    qpos = q0 + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v.float()).to(v.dtype)


def mla(cfg, p, x, dot, eps, q_block=128):
    n = dims(cfg)
    B, S, _ = x.shape
    H, hd, rd, vd, r = n["H"], n["hd"], n["rd"], n["vd"], n["r"]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    theta = cfg["rope_theta"]
    q = dot(rmsnorm(p["q_norm"]["scale"], dot(x, p["w_dq"]), eps),
            p["w_uq"]).reshape(B, S, H, hd + rd)
    q = torch.cat([q[..., :hd], rotate(q[..., hd:], pos, theta)], dim=-1)
    ckv = dot(x, p["w_dkv"])
    c = rmsnorm(p["kv_norm"]["scale"], ckv[..., :r], eps)
    k_pe = rotate(ckv[..., None, r:], pos, theta)
    k = torch.cat([dot(c, p["w_uk"]).reshape(B, S, H, hd),
                   k_pe.expand(B, S, H, rd)], dim=-1)
    v = dot(c, p["w_uv"]).reshape(B, S, H, vd)
    qb = q_block if S % q_block == 0 else S
    out = torch.cat([remat(_attend, q[:, i:i + qb], k, v,
                           torch.tensor(i, device=x.device))
                     for i in range(0, S, qb)], dim=1)
    return dot(out.reshape(B, S, H * vd), p["wo"])


def swiglu(p, x, dot):
    g = dot(x, p["w_gate"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * dot(x, p["w_up"])
    return dot(h, p["w_down"])


def moe(cfg, p, x, dot):
    """Routed experts (capacity-cut) plus shared experts; returns the
    output and the Switch load-balancing loss."""
    n = dims(cfg)
    B, S, d = x.shape
    T, E, k = B * S, n["E"], n["k"]
    C = max(math.ceil(T * k * cfg["capacity_factor"] / E), 4)
    xt = x.reshape(T, d)
    logits = dot(xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    share = torch.zeros(E, device=x.device).index_add_(
        0, top_e[:, 0], torch.ones(T, device=x.device)) / T
    aux = cfg["router_aux_loss_coef"] * E * torch.sum(probs.mean(0) * share)

    # each expert keeps the first C tokens, in token order, sent to it
    tok = torch.arange(T, device=x.device)[:, None].expand(T, k).reshape(-1)
    exp_id = top_e.reshape(-1)
    weight = top_p.reshape(-1)
    order = torch.argsort(exp_id * T + tok)
    exp_sorted = exp_id[order]
    counts = torch.bincount(exp_id, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=x.device) - first[exp_sorted]
    kept = order[rank < C]
    out = torch.zeros((T, d), dtype=F32, device=x.device)
    ends = torch.cumsum(torch.bincount(exp_id[kept], minlength=E), 0).tolist()
    start = 0
    for e, end in enumerate(ends):
        sel = kept[start:end]
        start = end
        if not len(sel):
            continue
        xe = xt[tok[sel]]
        g = dot(xe, p["w_gate"][e])
        h = torch.nn.functional.silu(g.float()).to(x.dtype) \
            * dot(xe, p["w_up"][e])
        ye = dot(h, p["w_down"][e])
        out = out.index_add(0, tok[sel], ye.float() * weight[sel, None])
    out = out.to(x.dtype) + swiglu(p["shared"], xt, dot)
    return out.reshape(B, S, d), aux


def loss(cfg: Dict, P, batch, dot):
    """Mean next-token cross-entropy plus the layers' load-balancing
    losses."""
    eps = as_run(cfg)["rms_norm_eps"]
    x = embed(P["embed"]["tok"], batch["tokens"])
    aux = torch.zeros((), device=x.device)
    for i in range(dims(cfg)["L"]):
        p = _layer(P["layers"], i)
        x = x + mla(cfg, p["attn"], rmsnorm(p["ln1"]["scale"], x, eps), dot,
                    eps)
        mo, a = moe(cfg, p["moe"], rmsnorm(p["ln2"]["scale"], x, eps), dot)
        x = x + mo
        aux = aux + a
    x = rmsnorm(P["final_norm"]["scale"], x, eps)
    return lm_loss(x, P["head"]["w"], batch["labels"], dot) + aux


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
