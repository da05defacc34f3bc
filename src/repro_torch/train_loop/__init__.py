"""PS-centric training and fleet-executed GEMMs of the port.

``hook``        the pluggable GEMM hook that ``models.layers.pdot``
                consults (a copy of the reference module).
``fleet_gemm``  :class:`FleetGemmSession`, whose differentiable dot runs
                each intercepted projection GEMM, and its two backward
                mirrors (dA = dO·Bᵀ, dW = Aᵀ·dO), through the session
                runtime's numpy or torch fleet executor.
``train_step``  :class:`FleetTrainSession` / :func:`make_fleet_train_step`
                -- one forward + backward + AdamW step with PS-hosted
                non-GEMM ops, fleet metrics, mid-step failure injection
                and periodic PS-side checkpoints.
``multi_ps``    :class:`MultiPSTrainSession` -- K parameter-server islands
                (``api.ShardedFleet``), each a ``FleetTrainSession`` over its
                own subfleet, synced every H inner steps by the sharded
                DiLoCo outer loop (``optim.diloco``); PS failures evict
                whole islands.
"""
from __future__ import annotations

_LAZY = {
    "FleetGemmSession": "repro_torch.train_loop.fleet_gemm",
    "GemmRecord": "repro_torch.train_loop.fleet_gemm",
    "FleetStepReport": "repro_torch.train_loop.train_step",
    "FleetTrainSession": "repro_torch.train_loop.train_step",
    "make_fleet_train_step": "repro_torch.train_loop.train_step",
    "price_request": "repro_torch.train_loop.train_step",
    "MultiPSState": "repro_torch.train_loop.multi_ps",
    "MultiPSStepReport": "repro_torch.train_loop.multi_ps",
    "MultiPSTrainSession": "repro_torch.train_loop.multi_ps",
}

__all__ = sorted(_LAZY) + ["hook"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
