"""Fleet-executed GEMMs of the port.

``hook``        the pluggable GEMM hook that ``models.layers.pdot``
                consults (a copy of the reference module).
``fleet_gemm``  :class:`FleetGemmSession`, which runs each intercepted
                projection GEMM through the session runtime's numpy or
                torch fleet executor.  This slice serves (forward only);
                the autograd function with the dA/dW mirrors comes with the
                training slice.
"""
from __future__ import annotations

_LAZY = {
    "FleetGemmSession": "repro_torch.train_loop.fleet_gemm",
    "GemmRecord": "repro_torch.train_loop.fleet_gemm",
}

__all__ = sorted(_LAZY) + ["hook"]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
