"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's on the same weights and batches.

Three numbers, each with its limit (``limits/<workload>.json``):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad1_gap``: by the worst leaf, the gap between the program's and the
  reference's norm of the first gradient as AdamW gets it (worked out
  from the first moment after one step), over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same for the norm of the parameters' change over
  the steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

A cell's limits file names the numbers that decide its ``correct``.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

QUIET = 1e-3


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Optional[Sequence[bool]] = None) -> List[float]:
    """Each kept leaf's gap of norms, over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    keep = keep or [True] * len(ref)
    pairs = [(p, r) for p, r, k in zip(prog, ref, keep) if k]
    median = statistics.median(r for _, r in pairs)
    return [abs(p - r) / max(r, median, 1e-30) for p, r in pairs]


def worst(prog: Sequence[float], ref: Sequence[float], paths: List[str],
          keep: Optional[Sequence[bool]] = None, n: int = 3) -> List:
    """The ``n`` leaves with the largest gaps, for a look at the cause."""
    keep = keep or [True] * len(ref)
    kept = [(path, p, r) for path, p, r, k in zip(paths, prog, ref, keep)
            if k]
    rows = [(gap, path, p, r) for gap, (path, p, r)
            in zip(leaf_gaps(prog, ref, keep), kept)]
    return sorted(rows, reverse=True)[:n]


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    if prog["paths"] != ref["paths"]:
        raise ValueError("the program's leaves are not the reference's")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"]))
    med = statistics.median(ref["grad1"])
    keep = [g >= QUIET * med for g in ref["grad1"]]
    grad1 = leaf_gaps(prog["grad1"], ref["grad1"])
    change = leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": loss, "grad1_gap": max(grad1),
            "change_gap": max(change)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def unchanged(paths: List[str]) -> Dict:
    """Readings of a program whose step returned its state unchanged:
    no moment and no change, so both norm gaps read 1."""
    n = len(paths)
    return {"paths": paths, "grad1": [0.0] * n, "change": [0.0] * n}
