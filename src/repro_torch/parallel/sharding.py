"""Logical-axis sharding rules on PyTorch's DTensor (port of
``src/repro/parallel/sharding.py``).

Model code annotates tensors with *logical* axis names
(``constrain(x, "batch", "seq", "embed")``); a :class:`Rules` table maps
logical names to mesh axes.  Outside a mesh everything is a no-op, so the
single-device paths run unchanged.

The CLEAVE mapping: weights carry 2-D row x column sharding
(``embed -> 'data'`` rows, ``ffn/heads/vocab -> 'model'`` columns) in
training mode -- the PS dispatching A-rows and B-columns -- while
activations keep tokens on ``'data'`` and the residual feature dim on
``'model'``.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: ``None``, a mesh axis name, or a tuple of names.
:func:`placements` turns it into DTensor placements, one per mesh dim:
``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
``Replicate()``.  A mesh is a ``torch.distributed.DeviceMesh`` with named
dims, or an :class:`AbstractMesh` (names and sizes, no devices), on which
the spec functions run without a process group.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional

_state = threading.local()


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices: enough for the
    spec functions, which read only ``shape`` and ``axis_names``."""
    dims: tuple = ()
    names: tuple = ()

    @property
    def axis_names(self) -> tuple:
        return tuple(self.names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.dims))


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in mesh order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    """The mesh axes the batch shards over: ('pod', 'data') or ('data',)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_count(mesh, entry) -> int:
    """How many shards a spec entry splits its dim into."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


@dataclass(frozen=True)
class Rules:
    """Maps logical axis name -> mesh axis (str, tuple of str, or None)."""
    table: dict = field(default_factory=dict)
    mesh: Optional[object] = None

    def spec(self, *logical) -> tuple:
        parts, used = [], set()
        names = set(axis_names(self.mesh)) if self.mesh is not None \
            else None
        for name in logical:
            ax = self.table.get(name)
            if ax is None:
                parts.append(None)
                continue
            ax = tuple(a for a in _axes(ax) if names is None or a in names)
            ax = tuple(a for a in ax if a not in used)
            used.update(ax)
            if not ax:
                parts.append(None)
            elif len(ax) == 1:
                parts.append(ax[0])
            else:
                parts.append(ax)
        return tuple(parts)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if tensor dim ``d``'s entry names that axis, else
    ``Replicate()``.  An entry ``("pod", "data")`` gives ``Shard(d)`` on
    both mesh dims, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names(mesh))


# ------------------------------------------------------------------ context --

@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


def active_mesh():
    """The active rules' DeviceMesh, or None outside a mesh."""
    rules = current_rules()
    if rules is None or rules.mesh is None \
            or isinstance(rules.mesh, AbstractMesh):
        return None
    return rules.mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrained_spec(rules: Rules, shape, *logical) -> tuple:
    """``rules.spec(*logical)`` padded to ``len(shape)``, with the
    reference's rule: a dim smaller than its shard count stays unsharded
    (uneven dims at least as large are allowed)."""
    spec = rules.spec(*logical)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is None or dim >= shard_count(rules.mesh, ax)
                 else None for dim, ax in zip(shape, spec))


def constrain(x, *logical):
    """Redistribute ``x`` to the active rules' layout for ``logical``
    (``x.redistribute(mesh, placements)``); a no-op without rules, on an
    abstract mesh, or for a tensor that is not a DTensor."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = constrained_spec(current_rules(), x.shape, *logical)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ------------------------------------------------------------- rule presets --

def make_rules(mesh, mode: str = "train", weight_2d: Optional[bool] = None,
               fsdp: bool = False) -> Rules:
    """Sharding-rule presets per execution mode.

    mode="train":  batch->(pod,data), weights 2-D (data x model)  [CLEAVE]
    mode="prefill": batch->(pod,data), weights col-sharded (2-D optional)
    mode="decode": batch->data, cache sequence->model, weights col-sharded
                   (2-D row x column for big models)

    fsdp=True: weights are *stored* 2-D (data x model) but *used* with the
    row shard gathered just in time (one per-layer weight all-gather over
    'data'), and activations keep the feature dim unsharded inside a
    layer.  Weights row-shard over 'data' only; the 'pod' axis shards the
    optimizer moments instead (ZeRO, ``launch.specs.opt_specs``).
    """
    if weight_2d is None:
        weight_2d = mode == "train"
    baxes = (("pod", "data") if (mesh is not None
                                 and "pod" in axis_names(mesh))
             else ("data",))
    w_in = ("data" if weight_2d else None)
    t = {
        "batch": baxes,
        "seq": None,
        "embed": "model" if mode == "train" else None,   # residual feature
        "embed_use": (None if fsdp else
                      ("model" if mode == "train" else None)),
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "w_in": w_in,
        "w_in_use": (None if fsdp else w_in),
        "w_out": "model",
        "cache_seq": "model" if mode == "decode" else None,
        "cache_batch": baxes,
        "state": None,
        "opt": ("pod", "data"),    # ZeRO: optimizer-state extra shard axis
    }
    return Rules(table=t, mesh=mesh)
