"""Plain reference of an RWKV-6 "Finch" stack (arXiv:2404.05892) as the
configuration file states it: per layer a time mix (token shift, a
data-dependent per-channel decay through a low-rank projection, the WKV
recurrence with its bonus u, a head-wise group norm and a SiLU gate) and
a channel mix (token shift, squared ReLU, sigmoid receptance).

Per head, with an hd x hd state S:
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Departures from the paper, as the configuration records them: the
token-shift mixes are static (no data-dependent lerp); RMSNorm in place
of LayerNorm, and no norm after the embedding; the group norm's epsilon
and the final norm's is ``layer_norm_epsilon * head_size_divisor**2``,
as published for the group norm.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from reference.common import BF16, F32, embed, lm_loss, remat, rmsnorm


def dims(cfg: Dict) -> Dict:
    d = cfg["hidden_size"]
    return dict(d=d, hd=cfg["head_size"], H=d // cfg["head_size"],
                ff=cfg["intermediate_size"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"], lora=cfg["time_decay_lora_dim"])


def layout(cfg: Dict):
    n = dims(cfg)
    d, H, hd, ff, L, V, lo = (n[x] for x in ("d", "H", "hd", "ff", "L", "V",
                                              "lora"))

    def dense(fan_in, fan_out):
        return ((L, fan_in, fan_out), BF16, ("normal", 1 / math.sqrt(fan_in)))

    t, c = ("layers", "time_mix"), ("layers", "channel_mix")
    return [
        (("embed", "tok"), (V, d), BF16, ("normal", 0.02)),
        (("final_norm", "scale"), (d,), BF16, ("const", 1.0)),
        (("head", "w"), (d, V), BF16, ("normal", 1 / math.sqrt(d))),
        (("layers", "ln1", "scale"), (L, d), BF16, ("const", 1.0)),
        (("layers", "ln2", "scale"), (L, d), BF16, ("const", 1.0)),
        (t + ("mu",), (L, 5, d), BF16, ("uniform", 0.25, 0.75)),
        (t + ("w_r",),) + dense(d, d),
        (t + ("w_k",),) + dense(d, d),
        (t + ("w_v",),) + dense(d, d),
        (t + ("w_g",),) + dense(d, d),
        (t + ("w0",), (L, d), F32, ("const", -2.0)),
        (t + ("wA",),) + dense(d, lo),
        (t + ("wB",), (L, lo, d), BF16, ("normal", 0.01)),
        (t + ("u",), (L, H, hd), F32, ("normal", 0.1)),
        (t + ("w_o",),) + dense(d, d),
        (t + ("ln_x", "scale"), (L, d), BF16, ("const", 1.0)),
        (t + ("ln_x", "bias"), (L, d), BF16, ("const", 0.0)),
        (c + ("mu",), (L, 2, d), BF16, ("uniform", 0.25, 0.75)),
        (c + ("w_k",),) + dense(d, ff),
        (c + ("w_v",),) + dense(ff, d),
        (c + ("w_r",),) + dense(d, d),
    ]


# ------------------------------------------------------------ FLOPs --

def matmul_params(cfg: Dict) -> int:
    """Parameters a token multiplies by: the time mix's five square
    projections and its decay's low-rank pair, the channel mix's three,
    and the LM head."""
    n = dims(cfg)
    d, ff = n["d"], n["ff"]
    layer = 5 * d * d + 2 * d * n["lora"] + 2 * d * ff + d * d
    return n["L"] * layer + d * n["V"]


def mixer_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Forward FLOPs of the WKV recurrence's products: per token and
    head, the readout r^T S and the update k v^T, 2 hd^2 each."""
    n = dims(cfg)
    return n["L"] * batch * seq * n["H"] * 4.0 * n["hd"] ** 2


# ------------------------------------------------------------ model --

def wkv(r, k, v, w, u, chunk=64):
    """The WKV recurrence over chunks of ``chunk`` steps, in f32, from a
    zero state: inside a chunk the pairs (t, j < t) carry the decay
    exp(sum of log w over j < i < t), written as a difference of
    cumulative sums that is never positive."""
    B, S, H, hd = r.shape
    dev = r.device
    r, k, v = r.float(), k.float(), v.float()
    logw = torch.log(w.float().clamp(min=1e-12))
    s = torch.zeros((B, H, hd, hd), dtype=F32, device=dev)
    below = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=dev), diagonal=-1)
    eye = torch.eye(chunk, dtype=F32, device=dev)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lw = (x[:, c0:c0 + chunk] for x in (r, k, v, logw))
        c = rc.shape[1]
        incl = torch.cumsum(lw, dim=1)
        excl = incl - lw
        y = torch.einsum("bthd,bhde->bthe", rc * torch.exp(excl), s)
        gap = excl[:, :, None] - incl[:, None, :]
        gap = gap.masked_fill(~below[:c, :c, None, None], float("-inf"))
        a = torch.einsum("bthd,bjhd,btjhd->bhtj", rc, kc, torch.exp(gap))
        a = a + torch.einsum("bthd,bthd->bht", rc, u[None, None] * kc)[
            ..., None] * eye[:c, :c]
        ys.append(y + torch.einsum("bhtj,bjhd->bthd", a, vc))
        last = incl[:, -1]
        s = s * torch.exp(last)[..., None] + torch.einsum(
            "bjhd,bjhe->bhde", kc * torch.exp(last[:, None] - incl), vc)
    return torch.cat(ys, dim=1)


def group_eps(cfg: Dict) -> float:
    return cfg["layer_norm_epsilon"] * cfg["head_size_divisor"] ** 2


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _mix(x, sh, mu):
    xf = x.float()
    return (xf + (sh.float() - xf) * mu.float()).to(x.dtype)


def time_mix(cfg, p, x, dot):
    n = dims(cfg)
    B, S, d = x.shape
    H, hd = n["H"], n["hd"]
    sh = _shift(x)
    xr, xk, xv, xg, xw = (_mix(x, sh, p["mu"][i]) for i in range(5))
    r = dot(xr, p["w_r"]).reshape(B, S, H, hd)
    k = dot(xk, p["w_k"]).reshape(B, S, H, hd)
    v = dot(xv, p["w_v"]).reshape(B, S, H, hd)
    g = torch.nn.functional.silu(dot(xg, p["w_g"]).float())
    ww = p["w0"] + torch.tanh(xw.float() @ p["wA"].float()) @ p["wB"].float()
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, hd)
    y = wkv(r, k, v, w, p["u"]).reshape(B, S, H, hd)
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = ((y - mean) * torch.rsqrt(var + group_eps(cfg))
         ).reshape(B, S, d)
    y = y * p["ln_x"]["scale"].float() + p["ln_x"]["bias"].float()
    return dot((y * g).to(x.dtype), p["w_o"])


def channel_mix(p, x, dot):
    sh = _shift(x)
    xk, xr = _mix(x, sh, p["mu"][0]), _mix(x, sh, p["mu"][1])
    k = torch.square(torch.relu(dot(xk, p["w_k"]).float())).to(x.dtype)
    gate = torch.sigmoid(dot(xr, p["w_r"]).float()).to(x.dtype)
    return dot(k, p["w_v"]) * gate


def _block(cfg, dot, x, *leaves):
    paths, p = _BLOCK_PATHS, {}
    for path, t in zip(paths, leaves):
        node = p
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    eps = cfg["layer_norm_epsilon"]
    x = x + time_mix(cfg, p["time_mix"], rmsnorm(p["ln1"]["scale"], x, eps),
                     dot)
    return x + channel_mix(p["channel_mix"],
                           rmsnorm(p["ln2"]["scale"], x, eps), dot)


_BLOCK_PATHS = (("ln1", "scale"), ("ln2", "scale"),
                ("time_mix", "mu"), ("time_mix", "w_r"), ("time_mix", "w_k"),
                ("time_mix", "w_v"), ("time_mix", "w_g"), ("time_mix", "w0"),
                ("time_mix", "wA"), ("time_mix", "wB"), ("time_mix", "u"),
                ("time_mix", "w_o"), ("time_mix", "ln_x", "scale"),
                ("time_mix", "ln_x", "bias"), ("channel_mix", "mu"),
                ("channel_mix", "w_k"), ("channel_mix", "w_v"),
                ("channel_mix", "w_r"))


def loss(cfg: Dict, P, batch, dot):
    """Mean next-token cross-entropy; each layer is recomputed in the
    backward."""
    layers = P["layers"]
    x = embed(P["embed"]["tok"], batch["tokens"])
    for i in range(dims(cfg)["L"]):
        leaves = []
        for path in _BLOCK_PATHS:
            node = layers
            for key in path:
                node = node[key]
            leaves.append(node[i])
        x = remat(lambda y, *ls: _block(cfg, dot, y, *ls), x, *leaves)
    x = rmsnorm(P["final_norm"]["scale"], x, group_eps(cfg))
    return lm_loss(x, P["head"]["w"], batch["labels"], dot)
