"""Single-token GQA decode attention: over a contiguous KV cache with a
validity mask (:func:`flash_decode`), and over the serving page pools read
in place through per-request page tables (:func:`flash_decode_paged`).

Ports of the Pallas ``flash_decode``
(``src/repro/kernels/decode_attention.py:144``) and ``flash_decode_paged``
(``:97``).  On a CUDA tensor each wrapper launches its hand-written Hopper
kernel, ``csrc/flash_decode.cu`` or ``csrc/paged_decode.cu`` (or raises);
on a CPU tensor it runs its plain version: :func:`flash_decode_plain`, the
same split online softmax in plain PyTorch, or
:func:`flash_decode_paged_plain`, which gathers the pages and runs that
split online softmax cut as the paged kernel cuts.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.ref import NEG_INF

launches = 0                 # paged kernel launches since the last reset
paged_element_launches = 0   # of which took the paged element route
flash_decode_launches = 0    # contiguous-cache kernel launches, likewise
flash_decode_element_launches = 0   # of which took the element route

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


# -------------------------------------------------------------- paged decode --

# shared with csrc/paged_decode.cu
PAGED_CWARPS = 8             # consumer warps of a block
PAGED_THREADS = 32 * PAGED_CWARPS + 32   # and one producer warp
PAGED_STAGES = 3             # the K/V ring's depth
PAGED_STAGE_BYTES = 16384    # bytes a stage holds
PAGED_TILE_MAX = 128         # rows a stage holds at most
PAGED_D_MAX = 256            # head dims the fast route takes
PAGED_ELEM_THREADS = 256     # threads of a block of the element route
# the split rule's
PAGED_BLOCKS = 264           # blocks to aim for: two per SM of an H100
PAGED_SCORE_BYTES = 61440    # a split's f32 scores at most, so that two
                             # blocks of the fast route fit an SM
_PAGED_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _score_stride(G: int) -> int:
    """f32 scores a token keeps in shared memory: the fast route's group
    bucket, or G on the element route."""
    return group_bucket(G) if G <= GROUPS_MAX else G


def paged_splits(B: int, K: int, S: int, G: int):
    """``(split, nsplit)``: the token axis of a paged table of ``S`` tokens
    (``maxp * page``) is cut into ``nsplit`` splits of ``split`` tokens (the
    last one ragged), about :data:`PAGED_BLOCKS` blocks over the B·K
    (request, kv head) pairs, each a multiple of :data:`SPLIT_QUANTUM`
    tokens whatever the page size, and no longer than lets a split's f32
    scores fit :data:`PAGED_SCORE_BYTES`.  The kernel and
    :func:`flash_decode_paged_plain` cut alike, so they round alike."""
    q = SPLIT_QUANTUM
    cap = max(q, PAGED_SCORE_BYTES // (4 * _score_stride(G)) // q * q)
    want = max(1, -(-PAGED_BLOCKS // max(B * K, 1)))
    ns = max(1, min(want, -(-S // q)))
    split = min(-(-(-(-S // ns)) // q) * q, cap)
    return split, max(1, -(-S // split))


def paged_pages(split: int, page: int) -> int:
    """Page ids a split of ``split`` tokens can touch."""
    return (split - 1) // page + 2


def paged_smem(G: int, D: int, element_size: int, split: int,
               page: int) -> int:
    """Dynamic shared-memory bytes of a block of the fast route: the ring of
    PAGED_STAGES stages (whose space later sums the p·V shares), the
    split's scores (split x GB f32), the scaled queries (GB x D f32), the
    warps' maxima and sums, the ring's mbarriers and the split's page
    ids."""
    GB = group_bucket(G)
    region = max(PAGED_STAGES * PAGED_STAGE_BYTES,
                 32 * PAGED_CWARPS * 16 * G)
    return region + 4 * (split * GB + GB * D + 2 * PAGED_CWARPS * GB) \
        + 16 * PAGED_STAGES + 4 * paged_pages(split, page)


def paged_element_smem(G: int, D: int, split: int, page: int) -> int:
    """Dynamic shared-memory bytes of a block of the element route: the
    scaled queries, the split's scores, the rows' maxima and sums, the
    split's page ids."""
    return 4 * (G * D + split * G + 2 * G + paged_pages(split, page))


def paged_box(page: int, D: int, element_size: int) -> int:
    """Rows of the fast route's TMA box: a divisor of the page and of every
    tile's offset (tiles of a power of two of rows, at most PAGED_TILE_MAX,
    filling a PAGED_STAGE_BYTES stage, from multiples of 64 tokens), so that
    no box crosses a page."""
    fit = min(PAGED_TILE_MAX, PAGED_STAGE_BYTES // (D * element_size))
    tile = 1 << (fit.bit_length() - 1)
    return math.gcd(page, min(tile, 64))


def _paged_fast_route(k_pool, v_pool, G: int, D: int) -> bool:
    """The fast route's rule: G <= GROUPS_MAX, D <= PAGED_D_MAX, rows of D
    elements a multiple of 16 bytes, both pools 16-byte aligned and not
    empty, and boxes (:func:`paged_box`) that start on 128 bytes of shared
    memory, as TMA needs; otherwise the element route."""
    P, page = k_pool.shape[0], k_pool.shape[1]
    rowb = D * k_pool.element_size()
    return G <= GROUPS_MAX and D <= PAGED_D_MAX and rowb % 16 == 0 \
        and P * page > 0 \
        and paged_box(page, D, k_pool.element_size()) * rowb % 128 == 0 \
        and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0


def flash_decode_paged_plain(q, k_pool, v_pool, page_table, lengths, *,
                             split=None):
    """Plain version of :func:`flash_decode_paged` (same arguments): the
    pages gathered into a contiguous (B, maxp·page, K, D) view, then the
    split online softmax of :func:`flash_decode_plain` cut as the kernel
    cuts (:func:`paged_splits`, or ``split`` tokens): per split, scores of
    the f32-scaled query in f32, p = exp(s - m_split) for tokens below the
    request's length, rounded to the pool type before the p·V product, the
    splits combined in order; output in the pool type."""
    B, K, G, D = q.shape
    page = k_pool.shape[1]
    S = page_table.shape[1] * page
    if split is None:
        split, _ = paged_splits(B, K, S, G)
    pt = page_table.long()
    k = k_pool[pt].reshape(B, S, K, D)
    v = v_pool[pt].reshape(B, S, K, D)
    valid = torch.arange(S, device=q.device)[None, :] \
        < lengths.long()[:, None]
    out = flash_decode_plain(q.reshape(B, 1, K * G, D), k, v, valid,
                             split=split)
    return out.reshape(B, K, G, D)


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_bf16 if dtype == torch.bfloat16 \
        else lib.paged_decode_f32
    fn.argtypes = _PAGED_ARGS
    fn.restype = ctypes.c_int
    return fn


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *, _split=None) -> torch.Tensor:
    """q: (B, K, G, D) grouped queries; k_pool/v_pool: (P, page, K, D) one
    layer's pools (float32 or bfloat16), pages of any size; page_table:
    (B, maxp) int32 page ids (entries past a request's pages are masked;
    the kernel never reads them); lengths: (B,) int32 occupied tokens.  Returns (B, K, G, D) in
    the pool dtype; a request of length 0 gives zeros.  Pools that meet
    :func:`_paged_fast_route` take the producer-warp kernel, others the
    element route (counted in :data:`paged_element_launches`).
    ``_split`` (tokens a split) overrides :func:`paged_splits`, for the
    split sweep only."""
    global launches, paged_element_launches
    if q.dim() != 4:
        raise ValueError(f"q must be (B, K, G, D); got {tuple(q.shape)}")
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
                                        lengths, split=_split)
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
    P, page, maxp = k_pool.shape[0], k_pool.shape[1], page_table.shape[1]
    S = max(1, maxp * page)
    if B > 65535 or K > 65535 or max(P, maxp) * page >= 2 ** 31:
        raise ValueError(f"paged decode needs B, K <= 65535 and fewer than "
                         f"2^31 pool rows and table tokens; got B={B}, "
                         f"K={K}, {P * page} rows, {maxp * page} tokens")
    if _split is None:
        split, ns = paged_splits(B, K, S, G)
    else:
        split, ns = _split, -(-S // _split)
    fast = _paged_fast_route(k_pool, v_pool, G, D)
    smem = paged_smem(G, D, k_pool.element_size(), split, page) if fast \
        else paged_element_smem(G, D, split, page)
    if smem > SMEM_MAX or split % SPLIT_QUANTUM:
        raise ValueError(f"paged decode: a split of {split} tokens needs "
                         f"{smem} B of shared memory (limit {SMEM_MAX}) "
                         f"and must be a multiple of {SPLIT_QUANTUM}")
    qf = q.float().contiguous()      # the TPU kernel takes q in f32 too
    out = torch.empty((B, K, G, D), dtype=k_pool.dtype, device=q.device)
    part = torch.empty((B * K * ns * (G * D + 2 * G),), dtype=torch.float32,
                       device=q.device) if ns > 1 else out
    with torch.cuda.device(q.device):
        err = _kernel(k_pool.dtype)(
            qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), B, K, G, D, page, maxp, P, split, ns,
            1.0 / math.sqrt(D), int(fast), smem,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    paged_element_launches += not fast
    return out
