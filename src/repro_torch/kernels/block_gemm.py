"""Band GEMM: C[g] = A[g] @ B for a stack of G row bands against ONE shared
right operand -- the fleet executor's band-bucket primitive.

Port of the Pallas ``block_gemm_batched_shared``
(``src/repro/kernels/block_gemm.py:59``).  On a CUDA tensor the wrapper
launches the hand-written Hopper kernel in ``csrc/band_gemm.cu`` (or
raises); on a CPU tensor it runs :func:`block_gemm_batched_shared_plain`,
the same arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import matmul_ref

launches = 0                 # kernel launches since the last reset

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]


def block_gemm_batched_shared_plain(a: torch.Tensor,
                                    b: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 products of the operands' values, f32 out."""
    return matmul_ref(a, b, torch.float32)


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("band_gemm")
    fn = lib.band_gemm_bf16 if dtype == torch.bfloat16 else lib.band_gemm_f32
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


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
    if a.device.type != "cuda":
        raise ValueError(f"band GEMM runs on cuda or cpu, not {a.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"band GEMM takes float32 or bfloat16 operands of "
                         f"one type; got {a.dtype} and {b.dtype}")
    if a.stride(2) != 1 or b.stride(1) != 1:
        raise ValueError("band GEMM needs unit stride along k for A and "
                         "along n for B")
    G, m, k = a.shape
    n = b.shape[1]
    c = torch.empty((G, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _kernel(a.dtype)(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), G, m, n, k,
            a.stride(0), a.stride(1), 0, b.stride(0), c.stride(0),
            c.stride(1), torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"band_gemm kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return c
