"""Paged single-token GQA decode: attention reads the serving page pools in
place through per-request page tables.

Port of the Pallas ``flash_decode_paged``
(``src/repro/kernels/decode_attention.py:97``).  On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in
``csrc/paged_decode.cu`` (or raises); on a CPU tensor it runs
:func:`flash_decode_paged_plain`, which gathers the pages and runs dense
masked softmax attention.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.ref import paged_decode_ref

launches = 0                 # kernel launches since the last reset

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_SMEM_LIMIT = 48 * 1024


def flash_decode_paged_plain(q, k_pool, v_pool, page_table, lengths):
    """Plain version (gather + dense masked softmax), output in the pool
    dtype."""
    return paged_decode_ref(q, k_pool, v_pool, page_table, lengths)


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_bf16 if dtype == torch.bfloat16 \
        else lib.paged_decode_f32
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, K, G, D) grouped queries; k_pool/v_pool: (P, page, K, D) one
    layer's pools (float32 or bfloat16); page_table: (B, maxp) int32 page
    ids (entries past a request's pages are masked); lengths: (B,) int32
    occupied tokens.  Returns (B, K, G, D) in the pool dtype."""
    global launches
    B, K, G, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[2:] != (K, D):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("page_table must be (B, maxp) and lengths (B,)")
    devs = {t.device for t in (q, k_pool, v_pool, page_table, lengths)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, page_table,
                                        lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    if k_pool.dtype != v_pool.dtype \
            or k_pool.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pools must be float32 or bfloat16 of one type; "
                         f"got {k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths must be int32")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()
            and page_table.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("pools, page_table and lengths must be contiguous")
    page, maxp = k_pool.shape[1], page_table.shape[1]
    smem = 4 * (2 * G * D + 2 * page * D + G * page + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged decode needs {smem} B of shared memory "
                         f"(limit {_SMEM_LIMIT}); use smaller pages")
    qf = q.float().contiguous()      # the TPU kernel takes q in f32 too
    out = torch.empty((B, K, G, D), dtype=k_pool.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel(k_pool.dtype)(
            qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, K, G, D, page, maxp, 1.0 / math.sqrt(D), smem,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
