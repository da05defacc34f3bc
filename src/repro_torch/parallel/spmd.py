"""Regions that run on each rank's local block (the reference's
``shard_map``) and the collectives they use, with their adjoints for
autograd.  :func:`region` keeps the contract of
``torch.distributed.tensor.experimental.local_map``, written out so that
an output of uneven shards keeps its global shape and every gradient
follows one convention.

Gradients follow one convention, that of ``shard_map``'s transpose: every
rank's local values are separate variables.  So

* an input that a region reads replicated over some mesh dims gets its
  gradient as ``Partial`` over those dims (each rank's share is summed);
* an output that a region leaves replicated over some mesh dims (every
  rank there holds the same value) has its cotangent divided by their
  size on the way in, as ``shard_map`` divides the cotangents of
  unmentioned axes;
* each collective's backward is its linear adjoint: ``psum`` and
  ``pmean`` their own, all-gather and reduce-scatter each other's.

Collectives go through ``torch.distributed._functional_collectives`` on
the process group of each named mesh axis.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import axis_names, axis_sizes


def _groups(mesh, axes) -> list:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [mesh.get_group(a) for a in axes]


def _wait(t):
    from torch.distributed._functional_collectives import wait_tensor
    return wait_tensor(t)


def _gather(x, dim, group):
    """The tiled all-gather along ``dim`` (``all_gather_single`` where this
    torch has it, else ``all_gather_tensor``)."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return _wait(fn(x.contiguous(), dim, group))


def _scatter(x, dim, group):
    """The summing reduce-scatter along ``dim``."""
    import torch.distributed._functional_collectives as funcol
    fn = getattr(funcol, "reduce_scatter_single",
                 funcol.reduce_scatter_tensor)
    return _wait(fn(x.contiguous(), "sum", dim, group))


def _all_reduce(x, op, groups):
    from torch.distributed._functional_collectives import all_reduce
    for g in groups:
        x = _wait(all_reduce(x.contiguous(), op, g))
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.groups), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def psum(x, mesh, axes):
    """Sum over the ranks of ``axes`` (a name or a tuple of names)."""
    return _PSum.apply(x, _groups(mesh, axes))


def pmean(x, mesh, axes):
    """Mean over the ranks of ``axes``."""
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= axis_sizes(mesh)[a]
    return psum(x, mesh, axes) / n


def pmax(x, mesh, axes):
    """Max over the ranks of ``axes``; no gradient (the softmax shifts
    it takes are constants)."""
    return _all_reduce(x.detach(), "max", _groups(mesh, axes))


def all_gather(x, mesh, axis: str, dim: int):
    """The blocks of ``axis``'s ranks concatenated along ``dim``."""
    return _AllGather.apply(x, dim, mesh.get_group(axis))


def reduce_scatter(x, mesh, axis: str, dim: int):
    """The sum over ``axis``'s ranks, split along ``dim``: this rank's
    block."""
    return _ReduceScatter.apply(x, dim, mesh.get_group(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def block_range(n: int, mesh, axis: str):
    """``[lo, hi)`` of a dim of ``n`` that this rank holds when the dim
    is sharded over ``axis`` (``torch.chunk``'s split, as DTensor's
    ``Shard``)."""
    k = axis_sizes(mesh)[axis]
    size = -(-n // k)
    lo = min(n, axis_index(mesh, axis) * size)
    return lo, min(n, lo + size)


def local_range(n: int, placements, mesh, dim: int):
    """``[lo, hi)`` of tensor dim ``dim`` (of size ``n``) that this rank
    holds under ``placements`` (every mesh dim that shards it, in mesh
    order, as DTensor splits it)."""
    from torch.distributed.tensor import Shard
    lo, size = 0, n
    for name, p in zip(axis_names(mesh), placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = axis_sizes(mesh)[name]
            step = -(-size // k)
            start = min(size, axis_index(mesh, name) * step)
            lo, size = lo + start, min(size, start + step) - start
    return lo, lo + size


def write_at(cache, new, slot, dim: int):
    """A copy of the DTensor ``cache`` with ``new`` (size 1 along
    ``dim``) written at index ``slot`` (a scalar tensor) of ``dim``: each
    rank writes into its own block where the slot falls in its range (a
    mask, so the host never reads the slot).  For the decode step, with
    no gradient."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if slot.dim() != 0:
        raise NotImplementedError("a per-request decode position on a "
                                  "mesh (continuous batching) is not "
                                  "sharded; the serve step's is a scalar")
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    npl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in pl)
    if isinstance(new, DTensor):
        new = new.redistribute(mesh, npl).to_local()
    loc = cache.to_local()
    lo, hi = local_range(cache.shape[dim], pl, mesh, dim)
    hit = torch.arange(lo, hi, device=loc.device) == slot.to(loc.device)
    hit = hit.reshape((-1,) + (1,) * (loc.dim() - dim - 1))
    out = torch.where(hit, new.to(loc.dtype), loc)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=cache.shape, stride=cache.stride())


def on_batch_rows(fn, batched, params, n_out: int):
    """``fn(*batched, params)`` on each rank's batch rows: every DTensor of
    ``batched`` (its first dim the batch) split over the batch axes and
    whole along its other dims, ``params`` (a tree) whole on every rank;
    the ``n_out`` outputs, each led by the batch, come back split alike.
    The mesh form of a block with no sharded form of its own (the RWKV
    and SSM recurrences, MLA's absorbed decode): exact for any
    computation that is independent across batch rows.  Plain tensors in
    ``batched`` pass as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import tree as T
    from repro_torch.parallel.sharding import (active_mesh, batch_axes,
                                               placements)
    mesh = active_mesh()
    sizes = axis_sizes(mesh)
    nb = 1
    for a in batch_axes(mesh):
        nb *= sizes[a]
    B = next(t.shape[0] for t in batched if isinstance(t, DTensor))
    bp = placements((batch_axes(mesh) if B % nb == 0 else None,), mesh)
    rp = (Replicate(),) * len(bp)
    keys = T.paths(params)
    leaves = T.leaves(params)
    nbat = len(batched)

    def body(*args):
        out = fn(*args[:nbat], T.unflatten(keys, list(args[nbat:])))
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    pls = [bp if isinstance(t, DTensor) else None for t in batched]
    pls += [rp if isinstance(t, DTensor) else None for t in leaves]
    outs = [bp] * n_out
    return region(body, mesh, tuple(pls), outs)(*batched, *leaves)


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def region(fn, mesh, in_placements, out_placements, out_shapes=None):
    """``fn`` run on each rank's local blocks (the reference's
    ``shard_map``; ``local_map``'s contract): DTensor inputs are
    redistributed to ``in_placements`` (None for an argument that is not
    a DTensor) and passed as local tensors, and the outputs become
    DTensors with ``out_placements`` (a list of them for several
    outputs) and, where given, the global ``out_shapes`` (needed when a
    dim does not split evenly).  Gradients follow the module's
    convention."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    multi = isinstance(out_placements, list)
    outs = out_placements if multi else [out_placements]
    shapes = out_shapes if multi else [out_shapes]
    if shapes is None:
        shapes = [None] * len(outs)

    def run(*args):
        local = []
        for a, pl in zip(args, in_placements):
            if pl is None or not isinstance(a, DTensor):
                local.append(a)
                continue
            pl = tuple(pl)
            if tuple(a.placements) != pl:
                a = a.redistribute(mesh, pl)
            gpl = tuple(Partial() if isinstance(p, Replicate) else p
                        for p in pl)
            t = a.to_local(grad_placements=gpl)
            local.append(t.wait() if hasattr(t, "wait") else t)
        res = fn(*local)
        vals = list(res) if multi else [res]
        out = []
        for v, pl, shp in zip(vals, outs, shapes):
            pl = tuple(pl)
            n = 1
            for a, p in zip(names, pl):
                if isinstance(p, Replicate):
                    n *= sizes[a]
            if n > 1 and v.requires_grad:
                v = _ScaleGrad.apply(v, 1.0 / n)
            kw = {}
            if shp is not None:
                kw = dict(shape=torch.Size(shp),
                          stride=_contiguous_stride(shp))
            out.append(DTensor.from_local(v, mesh, pl, run_check=False,
                                          **kw))
        return out if multi else out[0]

    return run
