"""The three block GEMMs, f32 accumulation, f32 out:

* :func:`block_gemm_batched_shared` -- C[g] = A[g] @ B for a stack of G row
  bands against ONE shared right operand, the fleet executor's band-bucket
  primitive (port of ``src/repro/kernels/block_gemm.py:59``);
* :func:`block_gemm_batched` -- C[g] = A[g] @ B[g], G independent products,
  the MoE routed experts' primitive (port of ``block_gemm.py:92``);
* :func:`block_gemm` -- C = A @ B (port of ``block_gemm.py:125``).

On CUDA tensors each wrapper launches its entry point of the hand-written
Hopper kernel in ``csrc/band_gemm.cu`` (one template, the batch strides as
arguments) or raises; on CPU tensors it runs its ``*_plain`` version, the
same arithmetic in plain PyTorch.  Each keeps its own launch count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import bmm_ref, matmul_ref

launches = 0                 # band GEMM launches since the last reset
batched_launches = 0         # block_gemm_batched launches
block_gemm_launches = 0      # block_gemm launches

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
_ARGS_2D = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


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
def _kernel(dtype, entry="band_gemm"):
    from repro_torch.kernels import _build
    lib = _build.load("band_gemm")
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"{entry}_{suffix}")
    fn.argtypes = _ARGS_2D if entry == "block_gemm" else _ARGS
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
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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
    G, m, k = a.shape
    n = b.shape[1]
    c = torch.empty((G, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel(a.dtype)(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), G, m, n, k,
            a.stride(0), a.stride(1), 0, b.stride(0), c.stride(0),
            c.stride(1), torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "band_gemm")
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
    G, m, k = a.shape
    n = b.shape[2]
    c = torch.empty((G, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel(a.dtype, "block_gemm_batched")(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), G, m, n, k,
            a.stride(0), a.stride(1), b.stride(0), b.stride(1), c.stride(0),
            c.stride(1), torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "block_gemm_batched")
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
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel(a.dtype, "block_gemm")(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
            b.stride(0), c.stride(0),
            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "block_gemm")
    block_gemm_launches += 1
    return c
