"""Per-rank cost terms of one executed step: the port's counterpart of
``src/repro/launch/hlo_analysis.py`` and of the reference dry run's
``parse_collectives`` and ``model_flops``.

The port has no HLO to read, so it counts what a step does as it runs,
on one rank:

* **product FLOPs**: ``2 * m * n * k`` of every ``mm``, ``bmm``,
  ``addmm`` and ``baddbmm``, and the kernels' own work from their shapes
  (a ctypes launch issues no aten op): the flash-attention kernel's
  visible (query, key) pairs and the batched block GEMM's products;
* **bytes**: what each op reads and writes (its tensor inputs once, its
  outputs once; views move nothing);
* **collectives**: the count and the bytes of each kind
  (:func:`collective_work`): every collective that DTensor or the
  model's regions issue passes through a functional collective, which
  is wrapped while the step runs.  The dry run's process group is a fake
  one: its collectives move no data.

:class:`CostMode` sees every op that runs outside a DTensor op's own
dispatch: the plain ops of the model's local regions exactly, and a
DTensor op as one op whose local sizes are its DTensor arguments' and
outputs' local tensors (a product's local contraction is its global one
over the mesh dims where the output is a pending sum).  With
``track_live`` it keeps the high-water mark of the bytes of live local
tensors: the dry run's memory figure under ``FakeTensorMode``.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "all_to_all")


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    kernel_flops: float = 0.0
    collectives: dict = field(default_factory=lambda: {
        k: {"count": 0, "bytes": 0.0} for k in COLLECTIVES})
    peak_live_bytes: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())


# ------------------------------------------------------------- collectives --

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# the functional collectives every collective of DTensor and of the model's
# regions goes through (the names differ between torch versions; those
# present are wrapped), by kind
_FUNCOL = {"all_gather_tensor": "all_gather_into_tensor",
           "all_gather_single": "all_gather_into_tensor",
           "all_gather_tensor_autograd": "all_gather_into_tensor",
           "reduce_scatter_tensor": "reduce_scatter_tensor",
           "reduce_scatter_single": "reduce_scatter_tensor",
           "reduce_scatter_tensor_autograd": "reduce_scatter_tensor",
           "all_reduce": "all_reduce",
           "all_to_all_single": "all_to_all",
           "all_to_all_single_autograd": "all_to_all"}
@contextlib.contextmanager
def collective_work(costs: Costs):
    """Record each functional collective's kind and this rank's input
    bytes into ``costs`` while the block runs (one call that forwards to
    another is counted once)."""
    import torch.distributed._functional_collectives as funcol
    real = {n: getattr(funcol, n) for n in _FUNCOL if hasattr(funcol, n)}
    _depth = threading.local()

    def wrap(name, fn):
        def counted(x, *args, **kwargs):
            d = getattr(_depth, "n", 0)
            if d == 0:
                c = costs.collectives[_FUNCOL[name]]
                c["count"] += 1
                c["bytes"] += float(_nbytes(x))
            _depth.n = d + 1
            try:
                return fn(x, *args, **kwargs)
            finally:
                _depth.n = d
        return counted

    for n, fn in real.items():
        setattr(funcol, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(funcol, n, fn)


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """This process as ``rank`` of a ``world_size`` fake process group
    (``torch.testing._internal.distributed.fake_pg``: collectives
    complete at once and move no data; no other process joins)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


# ---------------------------------------------------------------- op costs --

_MM = {"mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2)}


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _product_flops(name: str, args, out) -> float:
    """2 m n k of a product on this rank, from its local operands."""
    from torch.distributed.tensor import DTensor
    a_i, b_i = _MM[name]
    a, b = args[a_i], args[b_i]
    k = a.shape[-1]
    if isinstance(out, DTensor):
        # the local contraction: k split over the mesh dims where the
        # output is a pending sum
        mesh = out.device_mesh
        for d, p in enumerate(out.placements):
            if p.is_partial():
                k = -(-k // mesh.size(d))
    return 2.0 * _local(out).numel() * k


def _tensors(x):
    return [t for t in torch.utils._pytree.tree_leaves(x)
            if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts FLOPs and bytes of the ops it sees into ``costs``; with
    ``track_live``, the high-water mark of live tensor bytes."""

    def __init__(self, costs: Costs, track_live: bool = False):
        super().__init__()
        self.costs = costs
        self.track_live = track_live
        self._live = {}          # storage key -> [bytes, live tensors]
        self._now = 0

    def _track(self, t):
        t = _local(t)
        try:
            key = t.untyped_storage()._cdata
            nb = t.untyped_storage().nbytes()
        except (RuntimeError, NotImplementedError):
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [nb, 0]
            self._now += nb
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                             self._now)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._now -= entry[0]
            del self._live[key]

    def track(self, tree):
        """Count the tensors of ``tree`` (the step's inputs) as live."""
        if self.track_live:
            for t in _tensors(tree):
                self._track(t)

    def _count(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        if name in _MM:
            self.costs.flops += _product_flops(name, args, out)
        if not func.is_view:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            self.costs.bytes += float(sum(_nbytes(_local(t))
                                          for t in ins + outs))
            if self.track_live:
                for t in outs:
                    self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def counting(costs: Costs, track_live: bool = False):
    """Count into ``costs`` while the block runs: the ops
    (:class:`CostMode`, yielded), the collectives
    (:func:`collective_work`) and the kernels' launches
    (:func:`kernel_work`)."""
    with collective_work(costs), kernel_work(costs), \
            CostMode(costs, track_live) as m:
        yield m


def visible_pairs(Sq, Sk, causal, window, q_offset, prefix) -> int:
    """(query, key) pairs the attention masks leave visible, per head."""
    n = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(Sk, pos + 1) if causal else Sk
        lo = max(0, pos - window + 1) if window else 0
        seen = max(0, hi - max(lo, prefix)) + min(prefix, Sk)
        n += seen
    return n


@contextlib.contextmanager
def kernel_work(costs: Costs):
    """Add the FLOPs of each kernel launch (flash attention: 2 (Dk + Dv)
    per visible (query, key) pair and head; the batched block GEMM: 2 m n
    k per group) to ``costs`` while the block runs.  Only launches count:
    on the CPU the plain versions' own products are seen as ops."""
    from repro_torch.kernels import block_gemm as bg
    from repro_torch.kernels import flash_attention as fa
    real_attend, real_bgb = fa.attend, bg.block_gemm_batched

    def attend(q, k, v, out, *, causal=True, window=0, q_offset=0, prefix=0,
               _block_q=None):
        n = fa.launches
        res = real_attend(q, k, v, out, causal=causal, window=window,
                          q_offset=q_offset, prefix=prefix,
                          _block_q=_block_q)
        if fa.launches > n:
            B, H, Sq, Dk = q.shape
            pairs = visible_pairs(Sq, k.shape[2], causal, window, q_offset,
                                  prefix)
            f = 2.0 * B * H * pairs * (Dk + v.shape[3])
            costs.flops += f
            costs.kernel_flops += f
            costs.bytes += float(sum(_nbytes(t) for t in (q, k, v, out)))
        return res

    def block_gemm_batched(a, b):
        n = bg.batched_launches
        c = real_bgb(a, b)
        if bg.batched_launches > n:
            G, m, kk = a.shape
            f = 2.0 * G * m * kk * b.shape[-1]
            costs.flops += f
            costs.kernel_flops += f
            costs.bytes += float(_nbytes(a) + _nbytes(b) + _nbytes(c))
        return c

    fa.attend, bg.block_gemm_batched = attend, block_gemm_batched
    try:
        yield
    finally:
        fa.attend, bg.block_gemm_batched = real_attend, real_bgb


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training;
    2·N_active·tokens for inference steps."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token
