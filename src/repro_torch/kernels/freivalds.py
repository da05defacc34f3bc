"""Freivalds residuals of one verified band bucket, fused.

For every rectangle of a bucket (band ``b``, its rows ``[0, h_b)`` of the
band product C, columns ``[c0, c1)``) and probe ``i``: ``lhs_i = r_i·(A_b
(B s_i))``, ``rhs_i = (r_i·C) s_i`` and the noise scale ``Σ|C|`` over the
rectangle, after the poisoning ``C[b, 0, c0] += corr (1 + |C[b, 0, c0]|)``
of a flagged rectangle, which stays in C.  The signs ``r_i`` (band rows)
and ``s_i`` (output columns) are :func:`repro_torch.kernels.ops.rademacher`'s,
drawn from the rectangle's global task id.

Everything a bucket needs on the device beside its operands travels in one
packed int32 buffer (:func:`pack`, one copy from pinned memory,
:func:`to_device`).  :func:`residuals` returns the ``(rects, 2 iters + 1)``
float32 result ``[lhs_0 .., rhs_0 .., scale]``.  On CUDA tensors it
launches the two kernels of ``csrc/freivalds.cu`` (:func:`residuals_cuda`,
through one op of the dispatcher, ``repro_torch::freivalds_residuals``)
or raises; on CPU tensors it runs :func:`residuals_plain`, the einsums the
port ran before the kernel (the reference's, ``src/repro/kernels/ops.py``
``_bucket_gemm_verified``), on the same packed buffer.  ``launches``
counts the kernel's calls, one a bucket (its two kernels), and each adds
one to the ``fleet.residual_launches`` counter of the current tally.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.spans import count

launches = 0                 # residuals_cuda calls since the last reset

# csrc/freivalds.cu
MAXIT = 4                    # probes a rectangle takes at most
KT = 64                      # t-block: rows of B
MR = 64                      # c- and operand blocks: band rows
NPART = MAXIT + 1            # a c-block's partial: rhs_i, scale
SPLIT_COLS = 1024            # a c-block's columns at most
PAIRS = (4, 8, 16, 32)       # (rectangle, probe) pairs an operand block holds

_M32 = 0xFFFFFFFF


class Geometry(NamedTuple):
    """The host's view of a packed bucket (what sizes the launch)."""
    bands: int               # Gb
    rects: int               # Gr
    most: int                # rectangles of the fullest band
    width: int               # columns of the widest rectangle
    iters: int               # probes a rectangle


# ---------------------------------------------------------- sign draws ----

def _mul32(h, c: int):
    """(h * c) mod 2^32 for integers below 2^32 held in int64 tensors or
    uint64 arrays, with every partial product below 2^49 (no overflow)."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(h):
    """A 32-bit avalanche hash (bijective on [0, 2^32))."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _mix32_u32(h: np.ndarray) -> np.ndarray:
    """:func:`_mix32` on a uint32 array, whose products wrap mod 2^32."""
    h = h ^ (h >> 16)
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * np.uint32(0x846CA68B)
    return h ^ (h >> 16)


def probe_keys(seed: int, task_ids, iters: int, salt) -> np.ndarray:
    """``shape(salt) + (len(task_ids), iters)`` uint32 keys of the probes
    of ``(seed, salt, task_id, iter)``, hashed on the host; ``salt`` an int
    or an array of them."""
    s = np.asarray(salt, np.int64) & _M32
    h = _mix32_u32(np.full(s.shape + (1, 1), (int(seed) & _M32) ^ 0x9E3779B9,
                           np.uint32))
    h = _mix32_u32(h ^ s.astype(np.uint32)[..., None, None])
    tid = (np.asarray(task_ids, np.int64) & _M32).astype(np.uint32)[:, None]
    return _mix32_u32(_mix32_u32(h ^ tid) ^ np.arange(iters, dtype=np.uint32))


def signs(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``keys.shape + (n,)`` float32 signs: two rounds of the hash over the
    index ``0 .. n - 1`` under each int64 key."""
    k = keys[..., None]
    ix = torch.arange(n, dtype=torch.int64, device=keys.device)
    h = _mix32(_mix32(k ^ ix) ^ k)
    return 1.0 - 2.0 * ((h >> 31) & 1).to(torch.float32)


# ------------------------------------------------------ packed buffer ----

_FIELDS = ("h", "first", "bidx", "slot", "c0", "c1", "corrupt", "key_r",
           "key_s", "counter")


def _sizes(Gb: int, Gr: int, iters: int) -> tuple:
    return (Gb, Gb + 1, Gr, Gr, Gr, Gr, Gr, Gr * iters, Gr * iters, 1)


def pack(hs, bidx, slot, c0s, c1s, corrupt, seed: int, task_ids,
         iters: int):
    """One bucket's int32 buffer and its :class:`Geometry`: band heights,
    each band's first rectangle, per rectangle its band, slot,
    columns, corrupt flag (f32 bits) and the probe keys of salt 0 (rows)
    and 1 (columns), and a zero word the kernel counts its blocks in.  The
    rectangles come band by band, each band's in slot order."""
    Gb, Gr = len(hs), len(bidx)
    bidx = np.asarray(bidx, np.int64)
    first = np.zeros(Gb + 1, np.int64)
    np.cumsum(np.bincount(bidx, minlength=Gb), out=first[1:])
    if np.any(np.diff(bidx) < 0) or not np.array_equal(
            np.asarray(slot, np.int64), np.arange(Gr) - first[bidx]):
        raise ValueError("pack takes the rectangles band by band, each "
                         "band's in slot order")
    if not 1 <= iters <= MAXIT:
        raise ValueError(f"the residual kernel takes 1 to {MAXIT} probes, "
                         f"not {iters}")
    parts = (hs, first, bidx, slot, c0s, c1s,
             np.asarray(corrupt, np.float32).view(np.int32),
             # the rows' keys (salt 0), then the columns' (salt 1)
             probe_keys(seed, task_ids, iters, (0, 1)).view(np.int32), (0,))
    meta = np.concatenate([np.asarray(p).astype(np.int32, copy=False)
                           .ravel() for p in parts])
    c0s, c1s = np.asarray(c0s), np.asarray(c1s)
    geom = Geometry(bands=Gb, rects=Gr, most=int(np.diff(first).max()),
                    width=int((c1s - c0s).max()), iters=iters)
    return meta, geom


def unpack(meta: np.ndarray, geom: Geometry) -> dict:
    """The fields :func:`pack` packed, by name (``corrupt`` float32, the
    keys uint32, the rest int32)."""
    out, at = {}, 0
    for name, n in zip(_FIELDS, _sizes(geom.bands, geom.rects, geom.iters)):
        out[name] = meta[at:at + n]
        at += n
    if at != len(meta):
        raise ValueError(f"packed buffer of {len(meta)} words; the geometry "
                         f"{geom} takes {at}")
    out["corrupt"] = out["corrupt"].view(np.float32)
    for k in ("key_r", "key_s"):
        out[k] = out[k].view(np.uint32).reshape(geom.rects, geom.iters)
    return out


def to_device(meta: np.ndarray, device: torch.device) -> torch.Tensor:
    """The packed buffer on ``device``: one copy from pinned host memory,
    queued on the stream (the host does not wait for it); on the CPU the
    array itself."""
    host = torch.from_numpy(meta)
    if device.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


# ------------------------------------------------------------ residuals --

def residuals(As: torch.Tensor, b_op: torch.Tensor, C: torch.Tensor,
              meta: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """As: (Gb, pm, nk) band stack; b_op: (nk, qk) shared operand, both
    float32 or both bfloat16; C: (Gb, pm, qk) float32 band products, into
    which the poisoning is written; meta: :func:`pack`'s buffer on the
    operands' device.  Returns the (rects, 2 iters + 1) float32 residuals
    on that device."""
    if As.device.type == "cpu":
        return residuals_plain(As, b_op, C, meta, geom)
    return residuals_cuda(As, b_op, C, meta, geom)


def residuals_plain(As, b_op, C, meta, geom: Geometry) -> torch.Tensor:
    """Plain version: masked sign vectors grouped ``(band, slot)`` so the
    band-shared contractions batch, in f32 einsums."""
    f = unpack(meta.cpu().numpy(), geom)
    dev = C.device
    Gb, pm, qk, R, iters = geom.bands, As.shape[1], C.shape[2], geom.most, \
        geom.iters

    def ix(name):
        return torch.as_tensor(f[name], dtype=torch.int64, device=dev)
    bidx_t, slot_t, c0_t, c1_t = ix("bidx"), ix("slot"), ix("c0"), ix("c1")
    zero = torch.zeros_like(bidx_t)
    corr = torch.as_tensor(f["corrupt"], device=dev)
    c00 = C[bidx_t, zero, c0_t]
    C.index_put_((bidx_t, zero, c0_t), corr * (1.0 + c00.abs()),
                 accumulate=True)

    def keys(name):
        return torch.as_tensor(f[name].astype(np.int64), device=dev)
    r = signs(keys("key_r"), pm)
    s = signs(keys("key_s"), qk)
    rowm = (torch.arange(pm, device=dev)[None, :]
            < ix("h")[:, None]).float()                    # (Gb, pm)
    cols = torch.arange(qk, device=dev)[None, :]
    colm = ((cols >= c0_t[:, None]) & (cols < c1_t[:, None])).float()
    r = r * rowm[bidx_t][:, None, :]
    s = s * colm[:, None, :]
    Af = As.float()
    Bf = b_op.float()
    t = torch.einsum("kq,riq->rki", Bf, s)
    t_g = torch.zeros((Gb, R) + tuple(t.shape[1:]), device=dev)
    t_g[bidx_t, slot_t] = t
    u = torch.einsum("bmk,brki->bmri", Af, t_g)
    r_g = torch.zeros((Gb, R, iters, pm), device=dev)
    r_g[bidx_t, slot_t] = r
    lhs = torch.einsum("brim,bmri->bri", r_g, u)[bidx_t, slot_t]
    s_g = torch.zeros((Gb, R, iters, qk), device=dev)
    s_g[bidx_t, slot_t] = s
    Cs = torch.einsum("bmq,briq->bmri", C, s_g)
    rhs = torch.einsum("brim,bmri->bri", r_g, Cs)[bidx_t, slot_t]
    colm_g = torch.zeros((Gb, R, qk), device=dev)
    colm_g[bidx_t, slot_t] = colm
    Csa = torch.einsum("bmq,brq->bmr", C.abs(), colm_g)
    scale = torch.einsum("bm,bmr->br", rowm, Csa)[bidx_t, slot_t]
    return torch.cat([lhs, rhs, scale[:, None]], dim=1)


# --------------------------------------------------------------- kernel --

_PRODUCT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_longlong] \
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_OPERAND_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] \
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel(name):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("freivalds"), f"freivalds_{name}")
    fn.argtypes = _PRODUCT_ARGS if name.startswith("product") \
        else _OPERAND_ARGS
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"freivalds {what} kernel launch failed: CUDA "
                           f"error {err}")


def _on_card(device: torch.device, launch):
    """``launch(stream)`` on the card's current stream (the raw handle), with
    no device switch when the card is already current (as in
    ``block_gemm._launch``: a device guard costs the host more than a
    launch)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if torch.cuda.current_device() == idx:
        return launch(torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return launch(torch._C._cuda_getCurrentRawStream(idx))


def plan(nk: int, pm: int, geom: Geometry) -> dict:
    """The launch sizes of one bucket: the t-blocks' row tiles of B, the
    band's row tiles, the c-blocks' column splits; the operand blocks'
    pairs (``np``, one of :data:`PAIRS`), pair groups, threads along A's
    columns (two columns each) and column tiles."""
    P = geom.most * geom.iters
    npairs = next(p for p in PAIRS if p >= min(P, PAIRS[-1]))
    tx = 32
    while tx < 256 and 2 * tx < nk:
        tx *= 2
    return {"kt_tiles": -(-nk // KT), "row_tiles": -(-pm // MR),
            "splits": -(-geom.width // SPLIT_COLS), "np": npairs,
            "groups": -(-P // npairs), "tx": tx,
            "k_tiles": -(-nk // (2 * tx))}


_PLAN_KEYS = ("kt_tiles", "row_tiles", "splits", "np", "groups", "tx",
              "k_tiles")


def _scratch_sizes(Gb: int, nk: int, Gr: int, it: int, p: dict) -> tuple:
    """Words of the t-blocks, the c-blocks' partials, the operand blocks'
    partials and the result, in that order in one f32 scratch buffer."""
    return (Gr * it * nk, Gr * p["row_tiles"] * p["splits"] * NPART,
            Gb * p["groups"] * p["row_tiles"] * p["k_tiles"] * p["np"],
            Gr * (2 * it + 1))


def _check(As, b_op, C, meta, geom):
    if As.dtype not in (torch.float32, torch.bfloat16) \
            or b_op.dtype != As.dtype:
        raise ValueError("the residual kernel takes float32 or bfloat16 "
                         f"operands of one type; got {As.dtype} and "
                         f"{b_op.dtype}")
    if C.dtype != torch.float32 or meta.dtype != torch.int32:
        raise ValueError(f"the residual kernel takes float32 C and an int32 "
                         f"packed buffer; got {C.dtype} and {meta.dtype}")
    devs = {x.device for x in (As, b_op, C, meta)}
    if len(devs) != 1 or As.device.type != "cuda":
        raise ValueError(f"the residual kernel runs on one CUDA device; got "
                         f"{sorted(map(str, devs))}")
    if As.dim() != 3 or b_op.dim() != 2 or C.dim() != 3:
        raise ValueError("the residual kernel takes As (Gb, pm, nk), b_op "
                         "(nk, qk), C (Gb, pm, qk)")
    Gb, pm, nk = As.shape
    if b_op.shape[0] != nk or tuple(C.shape) != (Gb, pm, b_op.shape[1]) \
            or Gb != geom.bands:
        raise ValueError(f"shapes {tuple(As.shape)}, {tuple(b_op.shape)}, "
                         f"{tuple(C.shape)} do not fit {geom}")
    if meta.dim() != 1 or not meta.is_contiguous() \
            or meta.numel() != sum(_sizes(Gb, geom.rects, geom.iters)):
        raise ValueError(f"packed buffer of {meta.numel()} words does not "
                         f"fit {geom}")
    if not 1 <= geom.iters <= MAXIT:
        raise ValueError(f"the residual kernel takes 1 to {MAXIT} probes, "
                         f"not {geom.iters}")
    if As.stride(2) != 1 or b_op.stride(1) != 1 or C.stride(2) != 1:
        raise ValueError("the residual kernel needs unit stride along the "
                         "last dimension of As, b_op and C")
    # the operand blocks read A two columns at a time
    if nk % 2 or As.stride(0) % 2 or As.stride(1) % 2 \
            or As.data_ptr() % (2 * As.element_size()):
        raise ValueError("the residual kernel reads A in pairs of columns: "
                         "nk, A's strides and its base must be even")


def _launch(As, b_op, C, meta, scratch, dims):
    """The op's body: the product launch (t-blocks over B, c-blocks over C,
    the poisoning) and the operand launch (A, then the last block's sums)
    on the current stream, into ``scratch``; ``dims`` is (rects, iters) and
    :func:`plan`'s sizes in :data:`_PLAN_KEYS` order."""
    Gb, _, nk = As.shape
    Gr, it, *sizes = dims
    p = dict(zip(_PLAN_KEYS, sizes))
    t, cpart, apart, res = torch.split(
        scratch, _scratch_sizes(Gb, nk, Gr, it, p))
    types = "bf16" if As.dtype == torch.bfloat16 else "f32"

    def launch(stream):
        _raise_on(_kernel(f"product_{types}")(
            b_op.data_ptr(), b_op.stride(0), C.data_ptr(), C.stride(0),
            C.stride(1), meta.data_ptr(), t.data_ptr(), cpart.data_ptr(),
            Gb, Gr, it, nk, p["kt_tiles"], p["row_tiles"], p["splits"],
            SPLIT_COLS, stream), "product")
        _raise_on(_kernel(f"operands_{types}")(
            As.data_ptr(), As.stride(0), As.stride(1), t.data_ptr(),
            meta.data_ptr(), cpart.data_ptr(), apart.data_ptr(),
            res.data_ptr(), Gb, Gr, it, nk, p["np"], p["tx"], p["k_tiles"],
            p["row_tiles"], p["groups"], p["row_tiles"] * p["splits"],
            stream), "operand")
    _on_card(As.device, launch)


_LIB = []                    # the op's library, kept alive while it is used


@functools.lru_cache(maxsize=None)
def _op():
    """``repro_torch::freivalds_residuals``, whose CUDA body is
    :func:`_launch`.  Launching through an op of the dispatcher ties the
    two kernels to an op opened where the bucket runs, inside the
    ``fleet.<kind>`` range, for a profiler that dates a kernel by the op
    that launched it."""
    lib = torch.library.Library("repro_torch", "FRAGMENT")
    lib.define("freivalds_residuals(Tensor As, Tensor b_op, Tensor(a!) C, "
               "Tensor meta, Tensor(b!) scratch, int[] dims) -> ()")
    lib.impl("freivalds_residuals", _launch, "CUDA")
    _LIB.append(lib)
    return torch.ops.repro_torch.freivalds_residuals


def residuals_cuda(As, b_op, C, meta, geom: Geometry) -> torch.Tensor:
    """The kernel (:func:`_launch`, through :func:`_op`) on the current
    stream, into scratch allocated here."""
    global launches
    _check(As, b_op, C, meta, geom)
    Gb, pm, nk = As.shape
    Gr, it = geom.rects, geom.iters
    p = plan(nk, pm, geom)
    sizes = _scratch_sizes(Gb, nk, Gr, it, p)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=As.device)
    _op()(As, b_op, C, meta, scratch,
          [Gr, it] + [p[k] for k in _PLAN_KEYS])
    launches += 1
    count("fleet.residual_launches")
    return scratch[-sizes[-1]:].view(Gr, 2 * it + 1)
