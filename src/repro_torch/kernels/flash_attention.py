"""Flash attention (forward) with causal and sliding-window masks, GQA by
index, safe for fully masked rows.

Port of the Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py:64``).  On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (or raises); on a CPU tensor it runs
:func:`flash_attention_plain`, the same online softmax over key tiles in
plain PyTorch.  q and k may be wider than v (MLA's 192 / 128): the kernel
takes q/k head dims up to ``MAX_DK`` and v head dims up to ``MAX_DV``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.ref import NEG_INF

launches = 0                 # kernel launches since the last reset

BLOCK_K = 64                 # key tile of the kernel and the plain version
BLOCK_Q = 64                 # (position, head) rows of a kernel block
BLOCK_Q_MLA = 128            # the same at the (192, 128) tiles
MAX_DK, MAX_DV = 192, 128    # head dims the kernel is built for
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4 \
    + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def plan(dk: int, dv: int) -> tuple:
    """The kernel's (q/k tile, v tile, rows a block) for head dims dk, dv:
    both widths rounded up to 32 where they then agree, and (64, 32) for
    MLA's reduced 48 / 32, at ``BLOCK_Q`` rows; else (192, 128), which
    takes any dk <= 192 with dv <= 128, at ``BLOCK_Q_MLA``.  The launcher
    in ``csrc/flash_attention.cu`` is built for these triples and takes no
    other (apart from the f32 sweep's, :func:`attend`)."""
    pk, pv = -(-dk // 32) * 32, -(-dv // 32) * 32
    if pk == pv or (pk, pv) == (64, 32):
        return pk, pv, BLOCK_Q
    return MAX_DK, MAX_DV, BLOCK_Q_MLA


def _attend_plain(q, k, v, *, causal, window, q_offset, prefix=0):
    """(B, H, Sq, Dk) x (B, Hk, Sk, Dk), (B, Hk, Sk, Dv) -> (B, H, Sq, Dv)
    in q's dtype, scaled by 1/sqrt(Dk); query head h reads kv head
    h // (H // Hk).  Keys j < ``prefix`` are visible to every query."""
    B, H, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = H // Hk
    dev = q.device
    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, Hk, G, Sq, D)
    kf = k.float()[:, :, None]
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hk, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hk, G, Sq), device=dev)
    acc = torch.zeros((B, Hk, G, Sq, v.shape[-1]), device=dev)
    for k0 in range(0, Sk, BLOCK_K):
        k1 = min(k0 + BLOCK_K, Sk)
        s = torch.matmul(qf, kf[..., k0:k1, :].transpose(-1, -2))
        kpos = torch.arange(k0, k1, device=dev)
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        if prefix:
            mask |= kpos[None, :] < prefix
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask     # fully-masked-row safe
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        # the p·v product takes p in v's dtype, as the TPU kernel does
        pv = torch.matmul(p.to(v.dtype).float(),
                          v[:, :, None, k0:k1].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, -1).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          groups=1, prefix=0):
    """Plain version of :func:`flash_attention` (same arguments)."""
    del groups                   # implied by the head counts
    return _attend_plain(q[None], k[None], v[None], causal=causal,
                         window=window, q_offset=q_offset,
                         prefix=prefix)[0]


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 \
        else lib.flash_attention_f32
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def attend(q, k, v, out, *, causal=True, window=0, q_offset=0, prefix=0,
           _block_q=None):
    """Write attention of ``q`` over ``k``/``v`` into ``out``.  q is (B, H,
    Sq, Dk), k (B, Hk, Sk, Dk), v (B, Hk, Sk, Dv) and out (B, H, Sq, Dv),
    all views with unit stride along the head dim (any other strides; the
    model's (B, S, H, D) tensors pass as ``x.transpose(1, 2)``), with H %
    Hk == 0.  Query row i sits at position ``q_offset + i``; the scale is
    1/sqrt(Dk).  The first ``prefix`` keys pass every mask (Hymba's meta
    tokens, put before the sequence with ``q_offset`` raised by their
    count); the others keep the causal and window tests.  ``_block_q`` is
    for the block-shape sweep of
    ``chip_smoke.py --phases build,split`` alone: the kernel's rows a
    block in place of :func:`plan`'s (32 and 128 are also built, for f32
    at (128, 128) tiles; the CPU path ignores it)."""
    global launches
    B, H, Sq, Dk = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3] \
            or k.shape[0] != B or k.shape[3] != Dk or H % k.shape[1] != 0 \
            or tuple(out.shape) != (B, H, Sq, v.shape[3]):
        raise ValueError(f"flash attention needs q (B,H,Sq,Dk), k "
                         f"(B,Hk,Sk,Dk), v (B,Hk,Sk,Dv) with H % Hk == 0 "
                         f"and out (B,H,Sq,Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(out.shape)}")
    Dv = v.shape[3]
    devs = {t.device for t in (q, k, v, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if q.device.type == "cpu":
        out.copy_(_attend_plain(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, prefix=prefix))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    dts = {t.dtype for t in (q, k, v, out)}
    if len(dts) != 1 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes float32 or bfloat16 "
                         f"operands of one type; got {dts}")
    if any(t.stride(3) != 1 for t in (q, k, v, out)):
        raise ValueError("flash attention needs unit stride along D")
    if Dk > MAX_DK or Dv > MAX_DV:
        raise ValueError(f"flash attention is built for q/k head dims up "
                         f"to {MAX_DK} and v head dims up to {MAX_DV}, not "
                         f"{Dk} and {Dv}")
    dpk, dpv, bq = plan(Dk, Dv)
    if _block_q is not None:
        bq = int(_block_q)
    tiles = -(-(H // k.shape[1]) * Sq // bq)
    if tiles > 65535:
        raise ValueError(f"flash attention launches one grid row per "
                         f"{bq} (position, head) rows: {tiles} > 65535")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], Sq, k.shape[2], Dk, Dv, strides, int(bool(causal)),
            int(window), int(q_offset), int(prefix), 1.0 / math.sqrt(Dk),
            dpk, dpv, bq)
    # as the block GEMM's launch: the raw stream, and no device switch when
    # the card is already current
    idx = q.device.index
    if torch.cuda.current_device() == idx:
        err = _kernel(q.dtype)(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(q.device):
            err = _kernel(q.dtype)(
                *args, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    groups: int = 1, prefix: int = 0) -> torch.Tensor:
    """q: (BH, Sq, Dk); k: (BH // groups, Sk, Dk); v: (BH // groups, Sk,
    Dv), float32 or bfloat16.  Query row bh reads kv row bh // groups
    (heads flattened batch-major, as ``ops.mha_flash`` lays them out).
    Returns (BH, Sq, Dv) in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or q.shape[0] != k.shape[0] * groups:
        raise ValueError(f"flash attention needs q (BH,Sq,Dk) and k/v "
                         f"(BH/groups,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} with "
                         f"groups={groups}")
    out = torch.empty(q.shape[:2] + v.shape[2:], dtype=q.dtype,
                      device=q.device)
    attend(q[None], k[None], v[None], out[None], causal=causal,
           window=window, q_offset=q_offset, prefix=prefix)
    return out
