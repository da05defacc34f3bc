"""The three block GEMMs, f32 accumulation, f32 out:

* :func:`block_gemm_batched_shared` -- C[g] = A[g] @ B for a stack of G row
  bands against ONE shared right operand, the fleet executor's band-bucket
  primitive (port of ``src/repro/kernels/block_gemm.py:59``);
* :func:`block_gemm_batched` -- C[g] = A[g] @ B[g], G independent products,
  the MoE routed experts' primitive (port of ``block_gemm.py:92``);
* :func:`block_gemm` -- C = A @ B (port of ``block_gemm.py:125``).

On CUDA tensors each wrapper launches its entry point of the hand-written
Hopper kernel in ``csrc/band_gemm.cu`` or raises; on CPU tensors it runs
its ``*_plain`` version, the same arithmetic in plain PyTorch.  The
operands' type picks the body: float32 runs the FMA body on the CUDA cores
(IEEE f32, never TF32), bfloat16 the wgmma/TMA body on the tensor cores.
For the bf16 body the wrapper brings each operand to TMA's 16-byte
alignment (:func:`tma_aligned`) and splits the contraction when the tile
grid cannot fill the card (:func:`split_plan`).  Each wrapper keeps its own
launch count; ``tc_launches`` and ``fma_launches`` count each body's
launches over all three.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import bmm_ref, matmul_ref

launches = 0                 # band GEMM launches since the last reset
batched_launches = 0         # block_gemm_batched launches
block_gemm_launches = 0      # block_gemm launches
tc_launches = 0              # launches of the bf16 wgmma/TMA body (all three)
fma_launches = 0             # launches of the f32 FMA body (all three)
split_launches = 0           # of the bf16 ones, with a split contraction
aligned_copies = 0           # bf16 operands copied to TMA-aligned strides

SMS = 132                    # streaming multiprocessors of an H100 SXM
TILE = 128                   # the bf16 body's output tile, rows and columns
KSPAN = 256                  # contraction steps per f32 partial sum
MAX_SLICES = 64              # contraction slices one bf16 launch takes
TMA_ALIGN = 16               # bytes: TMA's base and stride alignment

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
_ARGS_2D = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
# the bf16 entries also take the split-K scratch, the slice bounds and
# their number
_TC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_longlong] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
_TC_ARGS_2D = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]


@functools.lru_cache(maxsize=4096)
def split_plan(G: int, m: int, n: int, k: int, slices: int = 0) -> tuple:
    """The bounds ``(0, k_1, ..., k_S = k)`` of the contraction slices of
    one bf16 launch: slice s covers ``[k_s, k_{s+1})``.  The kernel takes
    these bounds as they are.

    A grid of G x ceil(m / 128) x ceil(n / 128) output tiles that covers
    more than a third of the 132 SMs takes the whole contraction in one
    slice: each split writes and reads back an f32 partial of the output
    and adds a launch, and a block's 5-stage TMA ring keeps enough bytes
    in flight that half the SMs already stream B at the memory's rate
    (``chip_smoke.py --phases build,split``, PERF.md).  A smaller grid
    (the decode products' 8-32 tiles) is split into S slices, S x tiles
    the multiple of tiles nearest half the SMs, at most one per KSPAN
    span: slice s covers the spans [s * spans / S, (s + 1) * spans / S),
    so every slice but the last is a whole number of spans.  ``slices``
    forces S (to measure each split)."""
    spans = max(1, -(-k // KSPAN))
    tiles = G * -(-m // TILE) * -(-n // TILE)
    S = slices or (1 if tiles == 0 else max(1, (SMS + tiles) // (2 * tiles)))
    S = min(S, spans, MAX_SLICES)
    return tuple(min(k, KSPAN * (s * spans // S)) for s in range(S + 1))


@functools.lru_cache(maxsize=4096)
def _bounds_arg(plan):
    return (ctypes.c_int * len(plan))(*plan)


def tma_ready(x: torch.Tensor) -> bool:
    """Whether TMA can read ``x`` as it lies: unit stride along the last
    dimension, a 16-byte-aligned base, and every other dimension longer
    than one with a 16-byte-aligned stride that clears the dimensions
    inside it."""
    if x.is_contiguous() and x.shape[-1] * x.element_size() % TMA_ALIGN == 0:
        return x.data_ptr() % TMA_ALIGN == 0
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        return False
    if x.data_ptr() % TMA_ALIGN:
        return False
    span = x.shape[-1]
    for d in range(x.dim() - 2, -1, -1):
        if x.shape[d] > 1:
            st = x.stride(d)
            if st * x.element_size() % TMA_ALIGN or st < span:
                return False
            span = st * x.shape[d]
    return True


def pad_inner(x: torch.Tensor) -> torch.Tensor:
    """A new contiguous tensor: ``x`` zero-padded along its last dimension
    to a multiple of 16 bytes."""
    per = TMA_ALIGN // x.element_size()
    n = x.shape[-1]
    out = torch.zeros(tuple(x.shape[:-1]) + (max(-(-n // per), 1) * per,),
                      dtype=x.dtype, device=x.device)
    out[..., :n] = x
    return out


def tma_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when :func:`tma_ready`, else a view of its zero-padded
    copy (:func:`pad_inner`) cut back to ``x``'s shape: the same values at
    aligned strides, so a product of it is exact."""
    return x if tma_ready(x) else pad_inner(x)[..., :x.shape[-1]]


def block_gemm_batched_shared_plain(a: torch.Tensor,
                                    b: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 products of the operands' values, f32 out."""
    return matmul_ref(a, b, torch.float32)


def block_gemm_batched_plain(a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`block_gemm_batched`."""
    return bmm_ref(a, b, torch.float32)


def block_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`block_gemm`."""
    return matmul_ref(a, b, torch.float32)


@functools.lru_cache(maxsize=None)
def _kernel(dtype, entry):
    from repro_torch.kernels import _build
    lib = _build.load("band_gemm")
    bf16 = dtype == torch.bfloat16
    fn = getattr(lib, f"{entry}_{'bf16' if bf16 else 'f32'}")
    if entry == "block_gemm":
        fn.argtypes = _TC_ARGS_2D if bf16 else _ARGS_2D
    else:
        fn.argtypes = _TC_ARGS if bf16 else _ARGS
    fn.restype = ctypes.c_int
    return fn


def _check_card(name, a, b):
    """Device, type and stride checks of the wrappers' CUDA path."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16 operands of "
                         f"one type; got {a.dtype} and {b.dtype}")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride along k for A and "
                         "along n for B")


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}"
                           + (" (from the tensor-map encode: 10000 + its "
                              "CUresult; 20000: the CUDA driver has no "
                              "cuTensorMapEncodeTiled)"
                              if err >= 10000 else ""))


def _launch(entry, a, b, c, slices=0):
    """One launch of ``entry`` into ``c``: ``a`` (G, m, k) or (m, k); ``b``
    (k, n), shared, or (G, k, n); ``c`` the f32 output, (G, m, n) or
    (m, n).  The operands' type picks the body.  For the bf16 body it
    copies an operand that TMA cannot read as it lies, plans the
    contraction's slices (``slices`` forces their number) and allocates
    the split-K scratch."""
    global tc_launches, fma_launches, split_launches, aligned_copies
    bf16 = a.dtype == torch.bfloat16
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    c3 = c if c.dim() == 3 else c.unsqueeze(0)
    G, m, k = a3.shape
    n = b.shape[-1]
    s_am, s_bk = a3.stride(1), b.stride(-2)
    tail = ()
    if bf16:
        if k:
            a2, b2 = tma_aligned(a3), tma_aligned(b)
            aligned_copies += (a2 is not a3) + (b2 is not b)
            a3, b = a2, b2
        plan = split_plan(G, m, n, k, slices)
        S = len(plan) - 1
        scratch = torch.empty((S, G, m, n), dtype=torch.float32,
                              device=c.device) if S > 1 else None
        # a row stride TMA never steps along (one row) still has to be
        # aligned
        s_am = a3.stride(1) if m > 1 else -(-k // 8) * 8
        s_bk = b.stride(-2) if k > 1 else -(-n // 8) * 8
        tail = (ctypes.addressof(_bounds_arg(plan)), S)
    s_bg = b.stride(0) if b.dim() == 3 and G > 1 else 0
    ptrs = (a3.data_ptr(), b.data_ptr(), c.data_ptr())
    if bf16:
        ptrs += (None if scratch is None else scratch.data_ptr(),)
    if entry == "block_gemm":
        args = (*ptrs, m, n, k, s_am, s_bk, c.stride(0), *tail)
    else:
        args = (*ptrs, G, m, n, k, a3.stride(0), s_am, s_bg, s_bk,
                c3.stride(0), c3.stride(1), *tail)
    # the decode path launches many small products, so the host's share of
    # a call counts: the raw stream handle, and no device switch when the
    # card is already current (a Stream object and a device guard each
    # cost the host more than the launch itself)
    fn, idx = _kernel(a.dtype, entry), c.device.index
    if torch.cuda.current_device() == idx:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(c.device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    _raise_on(err, entry)
    if bf16:
        tc_launches += 1
        split_launches += S > 1
    else:
        fma_launches += 1


def block_gemm_batched_shared(a: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """a: (G, m, k); b: (k, n), both float32 or both bfloat16.  Returns
    (G, m, n) float32 with f32 accumulation.  Unlike the Pallas kernel, no
    dimension has to tile: the CUDA kernel masks ragged edges."""
    global launches
    if a.dim() != 3 or b.dim() != 2 or a.shape[2] != b.shape[0]:
        raise ValueError(f"band GEMM needs (G,m,k)·(k,n); got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return block_gemm_batched_shared_plain(a, b)
    _check_card("band GEMM", a, b)
    c = torch.empty((a.shape[0], a.shape[1], b.shape[1]),
                    dtype=torch.float32, device=a.device)
    _launch("band_gemm", a, b, c)
    launches += 1
    return c


def block_gemm_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (G, m, k); b: (G, k, n), both float32 or both bfloat16.  Returns
    (G, m, n) float32, C[g] = A[g] @ B[g] with f32 accumulation: the band
    GEMM's template with B's batch stride.  No dimension has to tile."""
    global batched_launches
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"block_gemm_batched needs (G,m,k)·(G,k,n); got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return block_gemm_batched_plain(a, b)
    _check_card("block_gemm_batched", a, b)
    c = torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                    dtype=torch.float32, device=a.device)
    _launch("block_gemm_batched", a, b, c)
    batched_launches += 1
    return c


def block_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (m, k); b: (k, n), both float32 or both bfloat16.  Returns (m, n)
    float32 with f32 accumulation: the band GEMM's template with G = 1."""
    global block_gemm_launches
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block_gemm needs (m,k)·(k,n); got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return block_gemm_plain(a, b)
    _check_card("block_gemm", a, b)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    _launch("block_gemm", a, b, c)
    block_gemm_launches += 1
    return c
