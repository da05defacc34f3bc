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
operands' type picks the body: a float32 A runs the FMA body on the CUDA
cores (IEEE f32, never TF32), against a float32 B or, in
:func:`block_gemm_batched`, a bfloat16 B read as stored; bfloat16 operands
run the wgmma/TMA body on the tensor cores.  For the bf16 body the wrapper
brings each operand to TMA's 16-byte alignment (:func:`tma_aligned`) and
splits the contraction when the tile grid cannot fill the card
(:func:`split_plan`); for the f32 body :func:`fma_plan` picks the tiling
and the split.  Each wrapper keeps its own launch count; ``tc_launches``
and ``fma_launches`` count each body's launches over all three.
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
fma_split_launches = 0       # of the f32 ones, with a split contraction
aligned_copies = 0           # bf16 operands copied to TMA-aligned strides

SMS = 132                    # streaming multiprocessors of an H100 SXM
TILE = 128                   # the bf16 body's output tile, rows and columns
KSPAN = 256                  # contraction steps per f32 partial sum
MAX_SLICES = 64              # contraction slices one launch takes
TMA_ALIGN = 16               # bytes: TMA's base and stride alignment
# the f32 body's tilings (``csrc/band_gemm.cu``, ``simt::Tiling``): output
# tile (rows, columns) by number; the skinny one holds up to 16 rows, and
# 128 columns above 8 rows
SKINNY, WIDE_64, WIDE_128 = range(3)
FMA_TILES = {SKINNY: (16, 256), WIDE_64: (64, 64), WIDE_128: (128, 128)}
WIDE_128_SLICES = 8          # most slices of a 128 x 128 tiling's launch

# every entry takes A, B, C, the split-K scratch, the sizes, the strides,
# the slice bounds and their number; the f32 entries then the tiling; last
# the stream
_PTRS, _SLICES = [ctypes.c_void_p] * 4, [ctypes.c_void_p, ctypes.c_int]
_TC_ARGS = _PTRS + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + _SLICES \
    + [ctypes.c_void_p]
_TC_ARGS_2D = _PTRS + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 \
    + _SLICES + [ctypes.c_void_p]
_FMA_ARGS = _TC_ARGS[:-1] + [ctypes.c_int, ctypes.c_void_p]
_FMA_ARGS_2D = _TC_ARGS_2D[:-1] + [ctypes.c_int, ctypes.c_void_p]


def _slice_bounds(k: int, S: int) -> tuple:
    """``(0, k_1, ..., k_S = k)``: S slices of ``ceil(k / KSPAN)`` spans,
    capped at one slice per span and at MAX_SLICES; slice s covers the
    spans [s * spans / S, (s + 1) * spans / S), so every slice but the
    last is a whole number of spans."""
    spans = max(1, -(-k // KSPAN))
    S = min(S, spans, MAX_SLICES)
    return tuple(min(k, KSPAN * (s * spans // S)) for s in range(S + 1))


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
    the multiple of tiles nearest half the SMs (:func:`_slice_bounds`).
    ``slices`` forces S (to measure each split)."""
    tiles = G * -(-m // TILE) * -(-n // TILE)
    S = slices or (1 if tiles == 0 else max(1, (SMS + tiles) // (2 * tiles)))
    return _slice_bounds(k, S)


@functools.lru_cache(maxsize=4096)
def fma_plan(G: int, m: int, n: int, k: int, tiling: int = -1,
             slices: int = 0) -> tuple:
    """``(tiling, bounds)`` of one launch of the f32 body: the tiling's
    number (:data:`FMA_TILES`) and the slice bounds as in
    :func:`split_plan`.

    Up to 16 rows take the skinny tiling, whose FMAs are the product's
    own, so its launches are bound by B's bytes.  Wider bands take 128 x
    128 tiles (8 x 8 a thread: half the shared loads per FMA of 64 x 64,
    but one block an SM) where their grid, split into up to
    :data:`WIDE_128_SLICES` slices, can give every SM a block; else 64 x
    64, whose blocks fill the SMs of a small product.  A 128 x 128 grid of
    T < SMS tiles runs ceil(T x S / SMS) waves of 1 / S of the work, so it
    takes the fewest slices with the fewest waves for the work; a larger
    one is not split (that would save part of its last wave, against an
    f32 partial of the output written and read back per slice).  The other
    two split the contraction only while their grid covers fewer than half
    the SMs: each split adds a launch and an f32 partial written and read
    back.  Then S is the most spans allow up to 4 x SMS blocks (skinny:
    enough 16-byte copies in flight to stream B), or S x tiles nearest the
    SMs (64 x 64) (``chip_smoke.py --phases build,split``, PERF.md).
    ``tiling`` and ``slices`` force either (to measure each)."""
    most = min(max(1, -(-k // KSPAN)), WIDE_128_SLICES)
    if tiling < 0:
        tiling = (SKINNY if m <= FMA_TILES[SKINNY][0] else WIDE_128
                  if _tiles(G, m, n, WIDE_128) * most >= SMS else WIDE_64)
    tiles = _tiles(G, m, n, tiling)
    if slices:
        S = slices
    elif tiles == 0:
        S = 1
    elif tiling == WIDE_128 and tiles < SMS:
        S = min(range(1, most + 1), key=lambda s: -(-tiles * s // SMS) / s)
    elif 2 * tiles >= SMS:
        S = 1
    elif tiling == SKINNY:
        S = 4 * SMS // tiles
    else:
        S = (SMS + tiles // 2) // tiles
    return tiling, _slice_bounds(k, S)


def _tiles(G, m, n, tiling):
    rows, cols = FMA_TILES[tiling]
    if tiling == SKINNY and m > 8:
        cols //= 2
    return G * -(-m // rows) * -(-n // cols)


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
def _kernel(entry, types):
    """The C entry ``{entry}_{types}``: types ``bf16`` (the wgmma/TMA
    body), ``f32`` or ``f32_bf16`` (the FMA body)."""
    from repro_torch.kernels import _build
    fn = getattr(_build.load("band_gemm"), f"{entry}_{types}")
    flat = entry == "block_gemm"
    if types == "bf16":
        fn.argtypes = _TC_ARGS_2D if flat else _TC_ARGS
    else:
        fn.argtypes = _FMA_ARGS_2D if flat else _FMA_ARGS
    fn.restype = ctypes.c_int
    return fn


def _check_card(name, a, b, mixed=False):
    """Device, type and stride checks of the wrappers' CUDA path; with
    ``mixed`` an f32 A may meet a bf16 B."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")
    ok = a.dtype == b.dtype and a.dtype in (torch.float32, torch.bfloat16)
    if not ok and not (mixed and a.dtype == torch.float32
                       and b.dtype == torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16 operands of "
                         f"one type{' (or f32 A, bf16 B)' if mixed else ''};"
                         f" got {a.dtype} and {b.dtype}")
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


def _launch(entry, a, b, c, slices=0, tiling=-1):
    """One launch of ``entry`` into ``c``: ``a`` (G, m, k) or (m, k); ``b``
    (k, n), shared, or (G, k, n); ``c`` the f32 output, (G, m, n) or
    (m, n).  A's type picks the body.  It plans the contraction's slices
    (``slices`` forces their number) and, for the f32 body, the tiling
    (``tiling`` forces it), and allocates the split-K scratch; for the
    bf16 body it copies an operand that TMA cannot read as it lies."""
    global tc_launches, fma_launches, split_launches, fma_split_launches
    global aligned_copies
    bf16 = a.dtype == torch.bfloat16
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    c3 = c if c.dim() == 3 else c.unsqueeze(0)
    G, m, k = a3.shape
    n = b.shape[-1]
    s_am, s_bk = a3.stride(1), b.stride(-2)
    if bf16:
        if k:
            a2, b2 = tma_aligned(a3), tma_aligned(b)
            aligned_copies += (a2 is not a3) + (b2 is not b)
            a3, b = a2, b2
        plan = split_plan(G, m, n, k, slices)
        # a row stride TMA never steps along (one row) still has to be
        # aligned
        s_am = a3.stride(1) if m > 1 else -(-k // 8) * 8
        s_bk = b.stride(-2) if k > 1 else -(-n // 8) * 8
        types, tail = "bf16", ()
    else:
        tiling, plan = fma_plan(G, m, n, k, tiling, slices)
        types = "f32" if b.dtype == torch.float32 else "f32_bf16"
        tail = (tiling,)
    S = len(plan) - 1
    scratch = torch.empty((S, G, m, n), dtype=torch.float32,
                          device=c.device) if S > 1 else None
    tail = (ctypes.addressof(_bounds_arg(plan)), S, *tail)
    s_bg = b.stride(0) if b.dim() == 3 and G > 1 else 0
    ptrs = (a3.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    if entry == "block_gemm":
        args = (*ptrs, m, n, k, s_am, s_bk, c.stride(0), *tail)
    else:
        args = (*ptrs, G, m, n, k, a3.stride(0), s_am, s_bg, s_bk,
                c3.stride(0), c3.stride(1), *tail)
    # the decode path launches many small products, so the host's share of
    # a call counts: the raw stream handle, and no device switch when the
    # card is already current (a Stream object and a device guard each
    # cost the host more than the launch itself)
    fn, idx = _kernel(entry, types), c.device.index
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
        fma_split_launches += S > 1


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
    """a: (G, m, k); b: (G, k, n), both float32, both bfloat16, or a float32
    against a bfloat16 b, which the kernel reads as stored and widens
    exactly (the bits of the call on ``b.float()``).  Returns (G, m, n)
    float32, C[g] = A[g] @ B[g] with f32 accumulation: the band GEMM's
    template with B's batch stride.  No dimension has to tile."""
    global batched_launches
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"block_gemm_batched needs (G,m,k)·(G,k,n); got "
                         f"{tuple(a.shape)}·{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return block_gemm_batched_plain(a, b)
    _check_card("block_gemm_batched", a, b, mixed=True)
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
