"""Plain PyTorch pieces shared by the reference models: parameter trees,
norms, rotary embeddings, the matrix-product precisions, the chunked
cross-entropy and AdamW.

Written from the papers and the configuration files alone; nothing here
imports the program under test.  A configuration's stated precision is
bf16 parameters and gradients, bf16 activations between layers, every
projection a bf16 product with f32 accumulation, f32 Adam moments, and
norms, softmax, attention, routing and the loss in f32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.utils.checkpoint

BF16, F32 = torch.bfloat16, torch.float32


# --------------------------------------------------------------- trees --

def leaf_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Key paths of every leaf of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                             prefix + (k,))]
    return [prefix]


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def nest(paths, values) -> dict:
    out: dict = {}
    for path, val in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out


# ---------------------------------------------------------- precisions --

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to an fp8 format under one per-tensor scale (amax to
    the format's largest finite value), returned in f32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Dot(torch.autograd.Function):
    """x @ w with every operand of the forward and of both backward
    products rounded to fp8 (e4m3 for activations and weights, e5m2 for
    gradients), accumulated in f32: a training recipe one step below
    bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        e4 = torch.float8_e4m3fn
        return (_fp8(x, e4) @ _fp8(w, e4)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
        g8 = _fp8(g, e5)
        dx = (g8 @ _fp8(w, e4).T).to(x.dtype)
        dw = (_fp8(x, e4).reshape(-1, x.shape[-1]).T
              @ g8.reshape(-1, g.shape[-1])).to(w.dtype)
        return dx, dw


def make_dot(precision: str) -> Callable:
    """The projection product ``dot(x, w)`` of a precision.  ``bf16``:
    operands in bf16, f32 accumulation, the result in x's type (an f32
    operand pair, such as the router's, is rounded to bf16 and multiplied
    in f32).  ``fp8``: the control, operands rounded to fp8."""
    if precision == "bf16":
        def dot(x, w):
            if x.dtype == F32 or w.dtype == F32:
                return x.to(BF16).float() @ w.to(BF16).float()
            return x @ w
        return dot
    if precision == "fp8":
        def dot(x, w):
            out_dtype = F32 if (x.dtype == F32 or w.dtype == F32) else BF16
            return _Fp8Dot.apply(x.to(out_dtype), w.to(out_dtype))
        return dot
    raise ValueError(f"unknown precision {precision!r}")


# ---------------------------------------------------------- layer math --

def rmsnorm(scale, x, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rotate(x, positions, theta):
    """Rotary embedding, rotate-half convention; x (B,S,H,D)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs.float()
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.float()[..., :half], x.float()[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def embed(table, tokens):
    """The rows of ``table`` for ``tokens``; the backward sums each row's
    gradient in f32 (``F.embedding``), so a frequent token's sum does not
    lose its small terms to bf16 rounding."""
    return torch.nn.functional.embedding(tokens.long(), table)


def remat(fn, *args):
    """``fn(*args)`` recomputed in the backward, so that only its inputs
    are kept: the reference trades time for memory."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def lm_loss(x, head_w, labels, dot, chunk=256):
    """Mean cross-entropy of the bf16 logits ``dot(x, head_w)`` taken in
    f32, over chunks of ``chunk`` positions, each recomputed in the
    backward."""
    B, S, _ = x.shape
    c = chunk if S % chunk == 0 else S

    def part(xc, lc):
        logits = dot(xc, head_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              lc.clamp(min=0).long()[..., None])[..., 0]
        return torch.sum((lse - picked) * (lc >= 0).float())

    total = sum(remat(part, x[:, j:j + c], labels[:, j:j + c])
                for j in range(0, S, c))
    return total / torch.clamp((labels >= 0).sum().float(), min=1.0)


# -------------------------------------------------------------- AdamW --

def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``, in f32."""
    f = torch.float32
    t = torch.tensor(step, dtype=f)
    warm = torch.clamp(t / max(opt["warmup_steps"], 1), max=1.0)
    prog = torch.clamp((t - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f) * prog))
    r = opt["min_lr_ratio"]
    return float(opt["lr"] * warm * (r + (1 - r) * cos))


SLICE = 1 << 24


def _slices(t):
    flat = t.reshape(-1)
    return [flat[i:i + SLICE] for i in range(0, flat.numel(), SLICE)]


def adamw_step(params: Sequence[torch.Tensor], grads, mu, nu, opt: Dict,
               step: int) -> torch.Tensor:
    """One AdamW step in place: global-norm clipping, f32 moments, the
    update in f32, each parameter rounded back to its own type.  Returns
    the gradient's global norm."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(s.float()))
                           for g in grads for s in _slices(g)))
    clip = opt["grad_clip"]
    scale = torch.clamp(clip / (gnorm + 1e-12), max=1.0) if clip else None
    lr = lr_at(opt, step)
    f = torch.float32
    b1, b2 = opt["b1"], opt["b2"]
    b1c = float(1 - torch.tensor(b1, dtype=f) ** step)
    b2c = float(1 - torch.tensor(b2, dtype=f) ** step)
    for p, g, m, v in zip(params, grads, mu, nu):
        for ps, gs, ms, vs in zip(*(_slices(t) for t in (p, g, m, v))):
            g32 = gs.float() * scale if scale is not None else gs.float()
            ms.mul_(b1).add_(g32, alpha=1 - b1)
            vs.mul_(b2).add_(g32 * g32, alpha=1 - b2)
            u = (ms / b1c) / (torch.sqrt(vs / b2c) + opt["eps"])
            p32 = ps.float()
            u = u + opt["weight_decay"] * p32
            ps.copy_(p32 - lr * u)
    return gnorm


def leaf_norms(tensors) -> List[float]:
    """The L2 norm of each tensor, summed in f32 slice by slice."""
    return [float(torch.sqrt(sum(torch.sum(torch.square(s.float()))
                                 for s in _slices(t)))) for t in tensors]


def diff_norms(after, before) -> List[float]:
    """The L2 norm of each ``after - before``, in f32 slice by slice."""
    return [float(torch.sqrt(sum(torch.sum(torch.square(a.float() - b.float()))
                                 for a, b in zip(_slices(x), _slices(y)))))
            for x, y in zip(after, before)]


def train_readings(family, cfg: Dict, make_params: Callable, batches,
                   opt: Dict, precision: str = "bf16",
                   rows: slice = slice(None)) -> Dict:
    """Runs the reference through ``len(batches)`` AdamW steps from the
    parameters ``make_params()`` gives (a dict of leaves by path) and
    returns each step's loss, each leaf's norm of the first gradient as
    AdamW gets it (clipped), and each leaf's norm of the parameters'
    change over all the steps.  ``rows`` keeps a part of every batch
    (a fault to read, not a sound run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dot = make_dot(precision)
    params = make_params()
    paths = sorted(params)
    leaves = [params[p] for p in paths]
    mu = [torch.zeros_like(t, dtype=F32) for t in leaves]
    nu = [torch.zeros_like(t, dtype=F32) for t in leaves]
    losses, grad1, norms = [], None, []
    for step, batch in enumerate(batches, start=1):
        batch = {k: v[rows] for k, v in batch.items()}
        live = [t.detach().requires_grad_() for t in leaves]
        loss = family.loss(cfg, nest(paths, live), batch, dot)
        grads = torch.autograd.grad(loss, live)
        del live
        losses.append(float(loss.detach()))
        norms.append(float(adamw_step(leaves, grads, mu, nu, opt, step)))
        del grads
        if step == 1:
            grad1 = [n / (1 - opt["b1"]) for n in leaf_norms(mu)]
    del mu, nu
    before = make_params()
    change = diff_norms(leaves, [before[p] for p in paths])
    del before, leaves, params
    return {"paths": ["/".join(p) for p in paths], "losses": losses,
            "grad1": grad1, "change": change, "grad_norms": norms}
