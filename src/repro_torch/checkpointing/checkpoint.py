"""Checkpointing: flat-key npz save/restore of nested trees of tensors, plus
the PS checkpoint policy from §6 (periodic parameter+optimizer snapshots
with automatic recovery on a standby coordinator).  Port of
``src/repro/checkpointing/checkpoint.py``.

A file holds one host numpy array per leaf under the reference's keys
(``/``-joined dict keys, ``#i`` for list and tuple positions), so a file
written by either package has the same keys leaf for leaf.  numpy has no
bfloat16, so a bfloat16 leaf is stored as its raw 16 bits (``uint16``)
and restored bit for bit into the ``like`` leaf's type.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array: a tensor is copied off its device (so
    a later in-place update cannot reach the file), a bfloat16 one as its
    raw bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    flat = _flatten(tree)
    arrays = {k: _to_host(v) for k, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)          # atomic: a crash never corrupts the ckpt
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


def _restore_leaf(key: str, arr: np.ndarray, like):
    shape = tuple(like.shape) if isinstance(like, torch.Tensor) \
        else np.shape(like)
    if arr.shape != shape:
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"expected {shape}")
    if not isinstance(like, torch.Tensor):
        return np.asarray(arr, np.asarray(like).dtype)
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "uV":
        # raw bfloat16 bits: this module's uint16, or a bfloat16 numpy
        # array of the reference's
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C")).to(like.dtype)
    return t.to(like.device)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf takes the type and
    device of ``like``'s leaf at its key; shapes are checked."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{prefix}{k}{_SEP}")
                    for k in tree}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, f"{prefix}#{i}{_SEP}")
                    for i, v in enumerate(tree)]
            return type(tree)(vals) if not hasattr(tree, "_fields") \
                else type(tree)(*vals)
        key = prefix.rstrip(_SEP)
        return _restore_leaf(key, flat[key], tree)

    return rebuild(like)


def load_metadata(path: str) -> Optional[dict]:
    p = path + ".meta.json"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


class CheckpointManager:
    """PS checkpoint policy (§6): keep the newest `keep` snapshots every
    `every` steps; `latest()` supports standby-instance recovery."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.dir = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def maybe_save(self, step: int, tree: Any, metadata=None) -> bool:
        if step % self.every != 0:
            return False
        save(self._path(step), tree, {"step": step, **(metadata or {})})
        self._gc()
        return True

    def steps(self):
        pat = re.compile(r"ckpt_(\d+)\.npz$")
        out = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self):
        s = self.steps()
        return (s[-1], self._path(s[-1])) if s else (None, None)

    def restore_latest(self, like):
        step, path = self.latest()
        if step is None:
            return None, None
        return step, restore(path, like)

    def _gc(self):
        s = self.steps()
        for old in s[:-self.keep]:
            for suffix in (".npz", ".npz.meta.json"):
                p = os.path.join(self.dir, f"ckpt_{old:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)
