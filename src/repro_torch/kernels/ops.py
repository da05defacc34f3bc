"""Plan execution and the serving decode wrapper around the port's kernels:
operand padding and staging, band bucketing, device-side Freivalds
residuals, GQA grouping.

Port of ``src/repro/kernels/ops.py`` (``block_gemm``, ``PadCache``
through ``plan_gemm``, ``mha_flash``, ``gqa_flash_decode``,
``gqa_flash_decode_paged`` and ``wkv6``), plus ``expert_matmul``, the MoE
routed experts' products on the batched block GEMM.  Operands and results
stay on the operands' device; only the per-rectangle residual scalars come
back to the host.
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import ieee_f32, resolve_device
from repro_torch.core.spans import count, span
from repro_torch.kernels import block_gemm as _bg
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import freivalds as _fv
from repro_torch.kernels import wkv6 as _wkv

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def block_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B through the plain block GEMM, f32 out.  The reference pads
    to its tiles and crops; the CUDA kernel masks ragged edges, so nothing
    is padded here."""
    return _bg.block_gemm(a, b)


def _promote(a, b):
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a, b


class _ExpertMatmul(torch.autograd.Function):
    """C[g] = A[g] @ W[g] with dA[g] = dC[g] @ W[g]ᵀ and dW[g] = A[g]ᵀ @
    dC[g], all three through the batched block GEMM (f32 sums, one cast to
    the operands' dtype).  The transposed operands are contiguous copies
    (the kernel reads unit inner strides): per backward one copy of W and
    one of A, as large as the operands themselves, written and read once
    more."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        with span("moe.experts"):
            return _bg.block_gemm_batched(a.contiguous(), w.contiguous()) \
                .to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        da = dw = None
        with span("moe.experts"):
            if ctx.needs_input_grad[0]:
                da = _bg.block_gemm_batched(
                    g, w.transpose(1, 2).contiguous()).to(a.dtype)
            if ctx.needs_input_grad[1]:
                dw = _bg.block_gemm_batched(
                    a.transpose(1, 2).contiguous(), g).to(w.dtype)
        return da, dw


def expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The routed experts' einsum ``ecd,edf->ecf``: a (E, C, d) capacity
    buffers, w (E, d, f) expert weights.  Returns (E, C, f) in the
    operands' (promoted) dtype, like the reference's einsum; differentiable
    in both operands (:class:`_ExpertMatmul`).  With no gradient asked, an
    f32 buffer meets bf16 weights as they are stored (the serving decode
    step): the kernel widens them exactly, so the result has the bits of
    the promoted call without an f32 copy of every expert.  The operands
    are local tensors: under a mesh the caller runs this on each rank's
    block (``parallel.spmd.region``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor) or isinstance(w, DTensor):
        raise TypeError("expert_matmul takes local tensors, not DTensors: "
                        "run it on each rank's block "
                        "(repro_torch.parallel.spmd.region)")
    if a.dtype == torch.float32 and w.dtype == torch.bfloat16 and not (
            torch.is_grad_enabled() and (a.requires_grad or w.requires_grad)):
        with span("moe.experts"):
            return _bg.block_gemm_batched(a.contiguous(), w.contiguous())
    a, w = _promote(a, w)
    return _ExpertMatmul.apply(a, w)


# ------------------------------------------------------- plan execution ----

class PadCache:
    """Small keyed cache of device-resident zero-padded operands.

    Keyed by ``(role, source shape, padded shape, dtype, device)`` plus a
    content key that misses after an in-place update of the source:

    * a numpy source keys on adler32 over its raw bytes (as the reference
      does);
    * a tensor source keys on ``(data_ptr, strides, _version)``: every
      in-place write bumps the version counter, and the entry holds a
      reference to its source, so its memory cannot be freed and reused by
      another tensor while the entry lives.  Fingerprinting a device tensor
      by content would copy it to the host.

    Non-contiguous numpy sources skip the cache.  Access is serialized by
    an RLock, as in the reference."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._slots: list = []      # (key, (source, value)), MRU first
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def fingerprint(src) -> "tuple | None":
        if isinstance(src, torch.Tensor):
            return ("t", src.data_ptr(), tuple(src.stride()), src._version)
        if not src.flags.c_contiguous:
            return None
        return ("np", zlib.adler32(memoryview(src).cast("B")))

    def get(self, src, key, build):
        fp = self.fingerprint(src)
        if fp is None:
            return build()
        key = key + (fp,)
        with self._lock:
            for i, (k, (_, val)) in enumerate(self._slots):
                if k == key:
                    if i:
                        self._slots.insert(0, self._slots.pop(i))
                    self.hits += 1
                    return val
            val = build()
            self.misses += 1
            self._slots.insert(0, (key, (src, val)))
            del self._slots[self.capacity:]
            return val

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)


def _staged_pad(arr, rows: int, cols: int, role: str,
                cache: Optional[PadCache], dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """``arr`` zero-padded to (rows, cols) in ``dtype`` on ``device``.  A
    tensor that already has that shape, type, device and a row-major layout
    is used as it is (no copy, nothing cached); otherwise the padded copy
    goes through the cache when one is given.  Casting before or after the
    zero padding gives the same values."""
    if isinstance(arr, torch.Tensor) and tuple(arr.shape) == (rows, cols) \
            and arr.dtype == dtype and arr.device == device \
            and arr.is_contiguous():
        return arr

    def build():
        # span of every staging copy, the transposed operands of the dA
        # and dW GEMMs included (launch/profile_train.py)
        count("fleet.stage_copies")
        with span("ops.stage_copy"):
            src = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(arr))
            padded = torch.zeros((rows, cols), dtype=dtype, device=device)
            padded[:src.shape[0], :src.shape[1]] = src.to(device=device,
                                                          dtype=dtype)
            return padded
    if cache is None:
        return build()
    return cache.get(arr, (role, tuple(arr.shape), rows, cols, dtype,
                           str(device)), build)


def resolve_plan_kernel(kernel: str = "auto",
                        device: Union[str, torch.device] = "cuda") -> str:
    """``"cuda"`` (the hand-written band GEMM) for operands on a CUDA
    device, ``"torch"`` (its plain version) for operands on the CPU.
    ``"auto"`` picks by device; a name that does not fit the device
    raises.  No name selects a library GEMM on the card."""
    dev = torch.device(device)
    if kernel == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if kernel not in ("cuda", "torch"):
        raise ValueError(f"unknown plan_gemm kernel {kernel!r}; "
                         "expected 'auto', 'cuda', or 'torch'")
    if kernel == "torch" and dev.type != "cpu":
        raise ValueError("kernel='torch' is the plain version for CPU "
                         f"operands; operands on {dev} run the CUDA kernel")
    if kernel == "cuda" and dev.type != "cuda":
        raise ValueError(f"kernel='cuda' needs CUDA operands, not {dev}")
    return kernel


def _gather_bands(a_pad, r0s, pm, compute_dtype):
    """(Gb, pm, nk) stack of the row bands starting at ``r0s`` (a view for
    a single band, one copy of the band slices for several: no index
    array goes to the device)."""
    if len(r0s) == 1:
        r0 = int(r0s[0])
        return a_pad[r0:r0 + pm].unsqueeze(0).to(compute_dtype)
    return torch.stack([a_pad[r0:r0 + pm] for r0 in r0s.tolist()]) \
        .to(compute_dtype)


def _band_matmul(As, b_op, kernel):
    if kernel == "torch":
        return _bg.block_gemm_batched_shared_plain(As, b_op)
    return _bg.block_gemm_batched_shared(As, b_op)


def rademacher(seed: int, task_ids, iters: int, n: int, salt: int,
               device) -> torch.Tensor:
    """(len(task_ids), iters, n) float32 signs from a counter-based hash of
    ``(seed, salt, task_id, iter, index)``: the draw of a rectangle depends
    on its global task id, never on how rectangles were bucketed.  The
    per-(task, iter) keys are hashed on the host; the device runs two
    rounds over the index (``freivalds.signs``; the residual kernel draws
    the same signs in registers)."""
    key = _fv.probe_keys(seed, task_ids, iters, salt)
    return _fv.signs(torch.as_tensor(key.astype(np.int64), device=device), n)


def _bucket_gemm(a_pad, b_op, r0s, *, pm, kernel, compute_dtype):
    """One band bucket: gather its A row bands, cast to the policy compute
    dtype, and run the whole bucket as ONE band GEMM against the shared
    padded B (f32 accumulation)."""
    As = _gather_bands(a_pad, r0s, pm, compute_dtype)
    return _band_matmul(As, b_op, kernel)


def _bucket_gemm_verified(a_pad, b_op, r0s, meta, geom, *, pm, kernel,
                          compute_dtype):
    """:func:`_bucket_gemm` plus device-side batched Freivalds residuals
    (the reference's ``_bucket_gemm_verified``): per rectangle, sign
    vectors ``r`` (iters x band rows) and ``s`` (iters x output columns),
    ``lhs = r·(A (B s))`` against ``rhs = (r·C)·s`` and the noise scale
    Σ|C| over the rectangle, after the ``C[0,0] += 1 + |C[0,0]|``
    injection of poisoned rectangles.  ``meta`` is the bucket's packed
    host buffer (``freivalds.pack``), which goes to the device in one copy;
    on the card the residuals are the fused kernel's
    (``freivalds.residuals``), on the CPU its plain version.  Returns
    ``(C, residuals)``, the residuals ``(rects, 2 iters + 1)``."""
    As = _gather_bands(a_pad, r0s, pm, compute_dtype)
    C = _band_matmul(As, b_op, kernel)
    return C, _fv.residuals(As, b_op, C, _fv.to_device(meta, C.device),
                            geom)


@dataclasses.dataclass
class BucketRun:
    """One band bucket's batched launch result.  ``out`` stays on the
    operands' device; the residuals are host numpy."""
    idx: np.ndarray          # rect indices into the caller's rects
    pm: int                  # padded band height
    q: int                   # un-padded output width (out is (Gb, pm, qk))
    band_r0s: np.ndarray     # (Gb,) band origins
    band_hs: np.ndarray      # (Gb,) un-padded band heights
    bidx: np.ndarray         # (Gr,) band of each rect
    c0s: np.ndarray          # (Gr,) rect column windows
    c1s: np.ndarray
    out: torch.Tensor        # (Gb, pm, qk) float32 band products
    lhs: Optional[np.ndarray] = None     # (Gr, iters) Freivalds residuals
    rhs: Optional[np.ndarray] = None
    scale: Optional[np.ndarray] = None   # (Gr,) Σ|C| noise scale

    def block(self, g: int) -> torch.Tensor:
        """Rect ``g``'s un-padded block view into its band product."""
        b = self.bidx[g]
        return self.out[b, :self.band_hs[b], self.c0s[g]:self.c1s[g]]


def _bucket_geometry(a_shape, b_shape, rects, block):
    """Padded depths (nk, qk), row bands, and padded-height buckets of a
    rect set (the reference's geometry, unchanged)."""
    n = a_shape[1]
    q = b_shape[1]
    nk = max(-(-n // block) * block, block)
    qk = max(-(-q // block) * block, block)
    bands: dict = {}                     # (r0, r1) -> [rect index, ...]
    for i, (r0, r1, c0, c1) in enumerate(rects):
        if r1 - r0 <= 0 or c1 - c0 <= 0:
            continue
        bands.setdefault((r0, r1), []).append(i)
    buckets: dict = {}                   # pm -> [(r0, r1), ...]
    for (r0, r1) in bands:
        pm = -(-(r1 - r0) // block) * block
        buckets.setdefault(pm, []).append((r0, r1))
    return nk, qk, bands, buckets


def _device_of(a, b, device):
    """``device`` if given, else the operand tensors' device, else the card
    (numpy operands stage on the card unless the caller names the CPU)."""
    if device is not None:
        return resolve_device(device)
    for x in (a, b):
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device("cuda")


def stage_plan_operands(a, b, rects, *, block=128, compute_dtype="float32",
                        pad_cache: Optional[PadCache] = None, device=None):
    """Pre-stage the padded device operands :func:`plan_gemm_buckets`
    would build for ``rects`` -- same geometry, same cache keys.  Returns
    ``(a_pad, b_op)`` (or ``(None, None)`` for an empty rect set)."""
    dev = _device_of(a, b, device)
    cd = torch_dtype(compute_dtype)
    nk, qk, bands, buckets = _bucket_geometry(a.shape, b.shape, rects, block)
    if not bands:
        return None, None
    pmax = max(buckets)
    a_pad = _staged_pad(a, a.shape[0] + pmax, nk, "a", pad_cache, cd, dev)
    b_op = _staged_pad(b, nk, qk, "b", pad_cache, cd, dev)
    return a_pad, b_op


def plan_gemm_buckets(a, b, rects, *, block=128, kernel="auto",
                      compute_dtype=None, verify_seed=None,
                      freivalds_iters: int = 2, corrupt=None,
                      pad_cache: Optional[PadCache] = None, device=None):
    """Bucketed execution of output rectangles of C = A @ B -- the fleet
    executor's primitive (see the reference's ``plan_gemm_buckets``).

    ``a``/``b`` are numpy arrays or tensors; they are staged (padded, cast
    to ``compute_dtype``) on ``device`` (default: the tensors' device, else
    the card).  Rectangles sharing a row range form a band; bands are
    bucketed by padded height and each bucket runs as ONE band GEMM
    against the shared padded B.  With ``verify_seed`` set, each launch
    also yields per-rect Freivalds residuals; ``corrupt`` is an optional
    per-rect flag vector of simulated poisoning devices.  Returns a list of
    :class:`BucketRun`."""
    with span("fleet.stage"):
        dev = _device_of(a, b, device)
        kernel = resolve_plan_kernel(kernel, dev)
        if dev.type == "cuda":
            # the PS re-dispatch's f32 products are IEEE f32, never TF32
            ieee_f32()
        if compute_dtype is None:
            compute_dtype = "bfloat16" if dev.type == "cuda" else "float32"
        cd = torch_dtype(compute_dtype)
        m = a.shape[0]
        q = b.shape[1]
        nk, qk, bands, buckets = _bucket_geometry(a.shape, b.shape, rects,
                                                  block)
        if not bands:
            return []
        pmax = max(buckets)
        a_pad = _staged_pad(a, m + pmax, nk, "a", pad_cache, cd, dev)
        b_op = _staged_pad(b, nk, qk, "b", pad_cache, cd, dev)
    runs: list = []
    for pm, bucket_bands in buckets.items():
        with span("fleet.launch"):
            r0s = np.asarray([r0 for r0, _ in bucket_bands], np.int32)
            hs = np.asarray([r1 - r0 for r0, r1 in bucket_bands], np.int32)
            ia, bidx, slot = [], [], []
            for bi, bk_ in enumerate(bucket_bands):
                for si, i in enumerate(bands[bk_]):
                    ia.append(i)
                    bidx.append(bi)
                    slot.append(si)
            ia = np.asarray(ia, np.int64)
            bidx = np.asarray(bidx, np.int32)
            slot = np.asarray(slot, np.int32)
            c0s = np.asarray([rects[i][2] for i in ia], np.int32)
            c1s = np.asarray([rects[i][3] for i in ia], np.int32)
            if verify_seed is None:
                out = _bucket_gemm(a_pad, b_op, r0s, pm=pm, kernel=kernel,
                                   compute_dtype=cd)
                runs.append(BucketRun(idx=ia, pm=pm, q=q, band_r0s=r0s,
                                      band_hs=hs, bidx=bidx, c0s=c0s,
                                      c1s=c1s, out=out))
                continue
            corr = np.zeros(len(ia), np.float32) if corrupt is None \
                else np.asarray(corrupt, np.float32)[ia]
            meta, geom = _fv.pack(hs, bidx, slot, c0s, c1s, corr,
                                  verify_seed, ia, freivalds_iters)
            C, res = _bucket_gemm_verified(a_pad, b_op, r0s, meta, geom,
                                           pm=pm, kernel=kernel,
                                           compute_dtype=cd)
        with span("fleet.readback"):
            # one device-to-host copy of the per-rect residual scalars
            res = res.cpu().numpy()
        it = freivalds_iters
        runs.append(BucketRun(idx=ia, pm=pm, q=q, band_r0s=r0s,
                              band_hs=hs, bidx=bidx, c0s=c0s, c1s=c1s,
                              out=C, lhs=res[:, :it],
                              rhs=res[:, it:2 * it], scale=res[:, -1]))
    return runs


def plan_gemm(a, b, rects, *, block=128, kernel="auto", compute_dtype=None,
              pad_cache: Optional[PadCache] = None, device=None):
    """Execute output rectangles of C = A @ B as batched band GEMMs.
    Returns float32 blocks (tensors on the staging device) in ``rects``
    order; degenerate rectangles give empty blocks."""
    dev = _device_of(a, b, device)
    blocks: list = [None] * len(rects)
    for i, (r0, r1, c0, c1) in enumerate(rects):
        if r1 - r0 <= 0 or c1 - c0 <= 0:
            blocks[i] = torch.zeros((max(r1 - r0, 0), max(c1 - c0, 0)),
                                    device=dev)
    for run in plan_gemm_buckets(a, b, rects, block=block, kernel=kernel,
                                 compute_dtype=compute_dtype,
                                 pad_cache=pad_cache, device=dev):
        for g, i in enumerate(run.idx):
            blocks[i] = run.block(g)
    return blocks


def mha_flash(q, k, v, *, causal=True, window=0, q_offset=0, prefix=0):
    """GQA flash attention.  q: (B,Sq,H,Dk); k: (B,Sk,K,Dk); v: (B,Sk,K,Dv)
    with H % K == 0.  Returns (B,Sq,H,Dv) in q's dtype.  Query head h reads
    kv head h // (H // K) by index (no repeated copy of k and v), and the
    kernel reads the (B, S, heads, D) layout in place.  The first
    ``prefix`` keys are visible to every query (``flash_attention.attend``)."""
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    _fa.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               out.transpose(1, 2), causal=causal, window=window,
               q_offset=q_offset, prefix=prefix)
    return out


def gqa_flash_decode(q, k, v, valid):
    """Single-token GQA decode over a contiguous cache.  q: (B,1,H,D);
    k,v: (B,S,K,D); valid: (S,) or (B,S) bool.  Returns (B,1,H,D) in the
    cache dtype.  Query head h reads kv head h // (H // K) by index (no
    repeated copy of the cache)."""
    return _dec.flash_decode(q, k, v, valid)


def gqa_flash_decode_paged(q, k_pool, v_pool, page_table, lengths):
    """Paged-KV single-token GQA decode: attention reads the serving page
    pools in place through per-request page tables.  q: (B,1,H,D);
    k_pool/v_pool: (P,page,K,D) -- one layer's pools; page_table: (B,maxp)
    int32; lengths: (B,) int32.  Returns (B,1,H,D) in the pool dtype."""
    B, _, H, D = q.shape
    K = k_pool.shape[2]
    qf = q.reshape(B, K, H // K, D)
    out = _dec.flash_decode_paged(qf, k_pool, v_pool, page_table, lengths)
    return out.reshape(B, 1, H, D)


def wkv6(r, k, v, w, u, *, s0=None, chunk=32):
    """RWKV-6 recurrence.  r,k,v,w: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd)
    or None (zero state).  Returns ``(y (B,S,H,hd) float32, s_last)``.
    The reference's wrapper returns y alone, from a zero state; the port's
    carries the state in and out, as ``wkv_chunked`` (its jnp twin) does."""
    return _wkv.wkv6(r, k, v, w, u, s0=s0, chunk=chunk)
