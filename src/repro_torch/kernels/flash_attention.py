"""Flash attention (forward) with causal and sliding-window masks, GQA by
index, safe for fully masked rows.

Port of the Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py:64``).  On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (or raises); on a CPU tensor it runs
:func:`flash_attention_plain`, the same online softmax over key tiles in
plain PyTorch.
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
MAX_D = 128                  # head dims the kernel is built for
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _attend_plain(q, k, v, *, causal, window, q_offset):
    """(B, H, Sq, D) x (B, Hk, Sk, D) -> (B, H, Sq, D) in q's dtype; query
    head h reads kv head h // (H // Hk)."""
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
                          groups=1):
    """Plain version of :func:`flash_attention` (same arguments)."""
    del groups                   # implied by the head counts
    return _attend_plain(q[None], k[None], v[None], causal=causal,
                         window=window, q_offset=q_offset)[0]


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 \
        else lib.flash_attention_f32
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def attend(q, k, v, out, *, causal=True, window=0, q_offset=0,
           _block_q=BLOCK_Q):
    """Write attention of ``q`` over ``k``/``v`` into ``out``.  All four
    are (B, heads, S, D) views with unit stride along D (any other
    strides; the model's (B, S, H, D) tensors pass as
    ``x.transpose(1, 2)``); k and v have Hk heads with H % Hk == 0.  Query
    row i sits at position ``q_offset + i``.  ``_block_q`` is for the
    block-shape sweep of ``chip_smoke.py --phases build,split`` alone: the
    kernel's rows a block, 32 and 128 built for f32 at D > 96 only (the
    CPU path ignores it)."""
    global launches
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[1] != 0 \
            or tuple(out.shape) != (B, H, Sq, D):
        raise ValueError(f"flash attention needs q (B,H,Sq,D), k/v "
                         f"(B,Hk,Sk,D) with H % Hk == 0 and out like q; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(out.shape)}")
    devs = {t.device for t in (q, k, v, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if q.device.type == "cpu":
        out.copy_(_attend_plain(q, k, v, causal=causal, window=window,
                                q_offset=q_offset))
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
    if D > MAX_D:
        raise ValueError(f"flash attention is built for head dims up to "
                         f"{MAX_D}, not {D}")
    tiles = -(-(H // k.shape[1]) * Sq // _block_q)
    if tiles > 65535:
        raise ValueError(f"flash attention launches one grid row per "
                         f"{_block_q} (position, head) rows: {tiles} > 65535")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], Sq, k.shape[2], D, strides, int(bool(causal)),
            int(window), int(q_offset), 1.0 / math.sqrt(D), int(_block_q))
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
                    groups: int = 1) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH // groups, Sk, D), float32 or bfloat16.
    Query row bh reads kv row bh // groups (heads flattened batch-major, as
    ``ops.mha_flash`` lays them out).  Returns (BH, Sq, D) in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] * groups:
        raise ValueError(f"flash attention needs q (BH,Sq,D) and k/v "
                         f"(BH/groups,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} with groups={groups}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    attend(q[None], k[None], v[None], out[None], causal=causal,
           window=window, q_offset=q_offset)
    return out
