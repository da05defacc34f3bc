"""Single-token GQA decode attention: over a contiguous KV cache with a
validity mask (:func:`flash_decode`), and over the serving page pools read
in place through per-request page tables (:func:`flash_decode_paged`).

Ports of the Pallas ``flash_decode``
(``src/repro/kernels/decode_attention.py:144``) and ``flash_decode_paged``
(``:97``).  On a CUDA tensor each wrapper launches its hand-written Hopper
kernel, ``csrc/flash_decode.cu`` or ``csrc/paged_decode.cu`` (or raises);
on a CPU tensor it runs its plain version: :func:`flash_decode_plain`, the
same split online softmax in plain PyTorch, or
:func:`flash_decode_paged_plain`, which gathers the pages and runs dense
masked softmax attention.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.ref import NEG_INF, paged_decode_ref

launches = 0                 # paged kernel launches since the last reset
flash_decode_launches = 0    # contiguous-cache kernel launches, likewise
flash_decode_element_launches = 0   # of which took the element route

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


# ------------------------------------------------- contiguous-cache decode --

SPLIT_MAX = 1024             # cache slots per block of the kernel
SPLIT_QUANTUM = 64           # splits are multiples of this many slots
_SPLIT_BLOCKS = 264          # blocks to aim for: two per SM of an H100
GROUPS_MAX = 16              # query heads per kv head the kernel takes
# shared with csrc/flash_decode.cu
THREADS = 256                # threads of a block
WARPS = THREADS // 32
STAGES = 4                   # the K/V ring's depth
STAGE_CHUNKS = 4             # 16-byte slices a thread copies a tile
SMEM_MAX = 232448            # an H100 block's dynamic shared memory
_DEC_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_float] \
    + [ctypes.c_longlong] * 2 + [ctypes.POINTER(ctypes.c_longlong)] \
    + [ctypes.c_int] * 2


def decode_splits(B: int, K: int, S: int):
    """``(split, nsplit)``: the key axis of each (request, kv head) is cut
    into ``nsplit`` splits of ``split`` slots (the last one ragged), enough
    of them that B·K·nsplit blocks fill the card, each a multiple of
    :data:`SPLIT_QUANTUM` slots and at most :data:`SPLIT_MAX`.  The kernel
    and :func:`flash_decode_plain` cut alike, so they round alike."""
    want = max(1, -(-_SPLIT_BLOCKS // max(B * K, 1)))
    ns = max(1, min(want, -(-S // SPLIT_QUANTUM)))
    split = -(-S // ns)
    split = min(-(-split // SPLIT_QUANTUM) * SPLIT_QUANTUM, SPLIT_MAX)
    return split, max(1, -(-S // split))


def padded_head_dim(D: int, element_size: int) -> int:
    """D as the kernel lays it out: at least one 16-byte row slice."""
    return max(D, 16 // element_size)


def group_bucket(G: int) -> int:
    """The kernel's instantiation for G query rows (2, 4, 8 or 16)."""
    return next(b for b in (2, 4, 8, 16) if G <= b)


def decode_smem(G: int, D: int, element_size: int, split: int) -> int:
    """Dynamic shared-memory bytes of a block of the kernel: the ring of
    STAGES tiles (whose space later sums the p·V shares), the split's
    scores (split x GB f32), the scaled queries, the row partials, the
    warps' last slots and the split's mask."""
    DP = padded_head_dim(D, element_size)
    GB = group_bucket(G)
    cpt = min(STAGE_CHUNKS, DP * element_size // 16)
    region = max(STAGES * THREADS * cpt * 16, THREADS * 16 * G)
    return region + 4 * (split * GB + GB * DP + 2 * WARPS * GB + WARPS) \
        + split


def _valid_rows(valid, B, S):
    if valid.dim() == 1 and valid.shape[0] == S:
        return valid[None].expand(B, S)
    if valid.dim() == 2 and tuple(valid.shape) == (B, S):
        return valid
    raise ValueError(f"valid must be (Smax,) or (B, Smax) = ({S},) or "
                     f"({B}, {S}); got {tuple(valid.shape)}")


def flash_decode_plain(q, k_cache, v_cache, valid, *, split=None):
    """Plain version of :func:`flash_decode` (same arguments): per split of
    :func:`decode_splits` (or of ``split`` slots), scores of the f32-scaled
    query in f32, the split's max m, p = exp(s - m)·valid rounded to the
    cache type before the p·V product, then the splits combined with
    weights exp(m_i - max m); the output acc / max(l, 1e-30) in the cache
    type."""
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    if split is None:
        split, ns = decode_splits(B, K, S)
    else:
        ns = -(-S // split)
    pad = split * ns - S
    qf = q.float().reshape(B, K, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    ok = _valid_rows(valid, B, S)[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    v = v_cache.float()
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        ok = torch.nn.functional.pad(ok, (0, pad), value=False)
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = s.reshape(B, K, G, ns, split)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * ok.reshape(B, 1, 1, ns, split)
    l = p.sum(dim=-1)                                    # (B, K, G, ns)
    pr = p.to(v_cache.dtype).float()
    acc = torch.einsum("bkgnl,bnlkd->bkgnd", pr,
                       v.reshape(B, ns, split, K, D))
    wgt = torch.exp(m[..., 0] - m[..., 0].amax(dim=-1, keepdim=True))
    lt = (l * wgt).sum(dim=-1)
    out = (acc * wgt[..., None]).sum(dim=-2) \
        / torch.clamp(lt, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(v_cache.dtype)


@functools.lru_cache(maxsize=None)
def _flash_kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("flash_decode")
    if dtype == torch.bfloat16:
        fn = lib.flash_decode_bf16
        fn.argtypes = _DEC_ARGS + [ctypes.c_int, ctypes.c_void_p]
    else:
        fn = lib.flash_decode_f32
        fn.argtypes = _DEC_ARGS + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cp_async_route(k_cache, v_cache) -> bool:
    """The 16-byte cp.async route's rule: both caches' base addresses,
    (b, s, k) strides and rows of D elements are multiples of 16 bytes;
    otherwise the element route."""
    esz = k_cache.element_size()
    if (k_cache.shape[3] * esz) % 16:
        return False
    return all(t.data_ptr() % 16 == 0
               and all((x * esz) % 16 == 0 for x in t.stride()[:3])
               for t in (k_cache, v_cache))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid: torch.Tensor, *,
                 _split=None) -> torch.Tensor:
    """q: (B, 1, H, D); k_cache/v_cache: (B, Smax, K, D), float32 or
    bfloat16 of one type, H % K == 0; valid: (Smax,) or (B, Smax) bool.
    Returns (B, 1, H, D) in the cache type.  Query head h reads kv head
    h // (H // K) by index; q, the caches and the mask are read through
    their strides (unit stride along D and Smax).  A row with no valid slot
    gives zeros, as the TPU kernel's does
    (``models.attention.decode_attention`` gives the mean of V there;
    ``decode_step`` never forms such a row).  ``_split`` (slots a split)
    overrides the split rule, for the measurement of :func:`decode_splits`
    only."""
    global flash_decode_launches, flash_decode_element_launches
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[3] \
            or q.shape[2] % k_cache.shape[2] != 0:
        raise ValueError(f"flash decode needs q (B,1,H,D) and caches "
                         f"(B,Smax,K,D) with H % K == 0; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    _valid_rows(valid, B, S)             # checks the mask's shape
    if not (q.device == k_cache.device == v_cache.device == valid.device):
        raise ValueError(f"operands on several devices: "
                         f"{ {t.device for t in (q, k_cache, v_cache, valid)} }")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, valid, split=_split)
    if q.device.type != "cuda":
        raise ValueError(f"flash decode runs on cuda or cpu, not {q.device}")
    dt = k_cache.dtype
    if v_cache.dtype != dt or dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"caches must be float32 or bfloat16 of one type; "
                         f"got {dt}/{v_cache.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, not {valid.dtype}")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("flash decode needs unit stride along D")
    if G > GROUPS_MAX or D > THREADS or THREADS % D:
        raise ValueError(f"flash decode takes up to {GROUPS_MAX} query heads "
                         f"per kv head and D dividing {THREADS}; got G={G}, "
                         f"D={D}")
    if B > 65535 or S == 0:
        raise ValueError(f"flash decode needs 0 < Smax and B <= 65535; got "
                         f"B={B}, Smax={S}")
    if _split is None:
        split, ns = decode_splits(B, K, S)
    else:
        split, ns = _split, -(-S // _split)
    esz = k_cache.element_size()
    smem = decode_smem(G, D, esz, split)
    if smem > SMEM_MAX or split % 4:
        raise ValueError(f"flash decode: a split of {split} slots needs "
                         f"{smem} B of shared memory (limit {SMEM_MAX})")
    if q.dtype not in (torch.float32, dt) or q.stride(3) != 1:
        q = q.float().contiguous()
    if valid.stride(-1) != 1:
        valid = valid.contiguous()
    async16 = _cp_async_route(k_cache, v_cache)
    out = torch.empty((B, 1, H, D), dtype=dt, device=q.device)
    part = torch.empty((B * K * ns * (G * D + 2 * G),), dtype=torch.float32,
                       device=q.device) if ns > 1 else out
    strides = (ctypes.c_longlong * 6)(
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2))
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid.data_ptr(), valid.stride(0) if valid.dim() == 2 else 0,
            out.data_ptr(), part.data_ptr(), B, K, G, D,
            padded_head_dim(D, esz), S, split, ns, 1.0 / math.sqrt(D),
            q.stride(0), q.stride(2), strides, int(async16), smem)
    if dt == torch.bfloat16:
        args += (int(q.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        err = _flash_kernel(dt)(
            *args, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode_launches += 1
    flash_decode_element_launches += not async16
    return out
