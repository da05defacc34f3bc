"""RWKV-6 (Finch) WKV recurrence, chunked, with a state carried in and out.

Port of the Pallas ``wkv6`` (``src/repro/kernels/wkv6.py:66``).  Per
(batch, head), with an hd x hd f32 state::

    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)

With ``s0=None`` it is the Pallas kernel's function (zero initial state);
with ``s0`` it is ``repro.models.rwkv.wkv_chunked``'s, which carries the
state in and returns it.  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel in ``csrc/wkv6.cu`` (or raises); on a CPU
tensor it runs :func:`wkv6_plain`, the chunked arithmetic of
``src/repro/models/rwkv.py:64-118`` over the same chunks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

launches = 0                 # kernel launches since the last reset
element_launches = 0         # of which took the element route

MAX_CHUNK = 32               # steps per chunk of the kernel
MAX_HD = 64                  # head dims the kernel is built for
THREADS = 256                # threads of a block, one per (batch, head)
_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]


def wkv_smem(element_size: int) -> int:
    """Shared-memory bytes of a block (``Smem`` of ``csrc/wkv6.cu``): r, k
    and v staged in their type, log w in rows padded by 4 floats, v in
    f32, rw, the decayed keys, A, and two hd vectors."""
    t, hd = MAX_CHUNK, MAX_HD
    return element_size * 3 * t * hd \
        + 4 * (t * (hd + 4) + 3 * t * hd + t * t + 2 * hd)


def _aligned16(*ts) -> bool:
    """The cp.async route's rule: every base address and (b, s, h) stride
    a multiple of 16 bytes, and a row of hd elements too."""
    for t in ts:
        esz = t.element_size()
        if t.data_ptr() % 16 or (t.shape[-1] * esz) % 16 \
                or any((x * esz) % 16 for x in t.stride()[:3]):
            return False
    return True


def wkv6_plain(r, k, v, w, u, s0=None, chunk=32):
    """Plain version of :func:`wkv6` (same arguments), differentiable: the
    chunked form of the reference's ``wkv_chunked`` over chunks of
    ``chunk`` steps, the last one ragged.  Every decay is exp of a log-space
    difference that is <= 0; w is clamped at 1e-12 before the log."""
    B, S, H, hd = r.shape
    dev = r.device
    f32 = torch.float32
    s = torch.zeros((B, H, hd, hd), dtype=f32, device=dev) if s0 is None \
        else s0.float()
    rf, kf, vf = r.float(), k.float(), v.float()
    logw = torch.log(torch.clamp(w.float(), min=1e-12))
    uf = u.float()
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        c = c1 - c0
        rc, kc, vc, lwc = (x[:, c0:c1] for x in (rf, kf, vf, logw))
        cum = torch.cumsum(lwc, dim=1)                   # W_t (inclusive)
        wprev = torch.cat([torch.zeros((B, 1, H, hd), dtype=f32,
                                       device=dev), cum[:, :-1]], dim=1)
        y_inter = torch.einsum("bthd,bhde->bthe", rc * torch.exp(wprev), s)
        # A[t, j] = sum_d r_t k_j exp(W_{t-1} - W_j) for j < t, plus the
        # u bonus on the diagonal; the masked difference is <= 0
        tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev),
                         diagonal=-1)
        diff = wprev[:, :, None] - cum[:, None, :]       # (B, t, j, H, hd)
        diff = torch.where(tri[None, :, :, None, None], diff,
                           torch.full_like(diff, float("-inf")))
        A = torch.einsum("bthd,bjhd,btjhd->bhtj", rc, kc, torch.exp(diff))
        a_diag = torch.einsum("bthd,bthd->bht", rc, uf[None, None] * kc)
        A = A + a_diag[..., None] * torch.eye(c, dtype=f32, device=dev)
        ys.append(y_inter + torch.einsum("bhtj,bjhd->bthd", A, vc))
        wc = cum[:, -1]                                  # (B, H, hd)
        kdec = kc * torch.exp(wc[:, None] - cum)
        s = s * torch.exp(wc)[..., None] \
            + torch.einsum("bjhd,bjhe->bhde", kdec, vc)
    y = torch.cat(ys, dim=1) if ys else torch.zeros((B, 0, H, hd),
                                                    dtype=f32, device=dev)
    return y, s


@functools.lru_cache(maxsize=None)
def _kernel(dtype):
    from repro_torch.kernels import _build
    lib = _build.load("wkv6")
    fn = lib.wkv6_bf16 if dtype == torch.bfloat16 else lib.wkv6_f32
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, s0=None, chunk: int = 32):
    """r, k, v: (B, S, H, hd) float32 or bfloat16 (one type); w: (B, S, H,
    hd) float32 decay in (0, 1); u: (H, hd) bonus; s0: (B, H, hd, hd)
    float32 incoming state or None (zeros).  Returns ``(y, s_last)``: y
    (B, S, H, hd) float32 and the (B, H, hd, hd) float32 state after the
    last step.  The CUDA kernel reads the (B, S, H, hd) layout through its
    strides (unit stride along hd) and takes chunks of ``min(chunk, 32)``
    steps, the last one ragged: any S runs, and the chunk length changes
    only the rounding."""
    global launches, element_launches
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 needs r, k, v, w of one (B, S, H, hd) "
                         f"shape; got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, S, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be (H, hd) = {(H, hd)}, not "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"s0 must be (B, H, hd, hd) = {(B, H, hd, hd)}, "
                         f"not {tuple(s0.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, not {chunk}")
    ts = (r, k, v, w, u) + (() if s0 is None else (s0,))
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    if len({r.dtype, k.dtype, v.dtype}) != 1 \
            or r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"r, k, v must be float32 or bfloat16 of one type; "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, not {w.dtype}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("wkv6 needs unit stride along hd")
    if hd > MAX_HD:
        raise ValueError(f"wkv6 is built for head dims up to {MAX_HD}, "
                         f"not {hd}")
    if B > 65535:
        raise ValueError(f"wkv6 launches one grid row per batch: {B} > "
                         "65535")
    uc = u.float().contiguous()
    sc = None if s0 is None else s0.float().contiguous()
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (r, k, v, w, y) for s in t.stride()[:3]))
    async16 = _aligned16(r, k, v, w)
    with torch.cuda.device(r.device):
        err = _kernel(r.dtype)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uc.data_ptr(), None if sc is None else sc.data_ptr(),
            y.data_ptr(), s_last.data_ptr(), B, H, S, hd,
            max(1, min(chunk, MAX_CHUNK, S)), strides, int(async16),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    element_launches += not async16
    return y, s_last
