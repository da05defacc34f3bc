"""The pluggable projection-GEMM hook.

``models.layers.pdot(x, w)`` consults this module on every call: with no
hook installed it is exactly ``x @ w`` (the monolithic path, zero overhead
once traced); inside a PS-centric training session the installed hook routes
the GEMM — and, via its custom VJP, the two backward GEMMs — through the
fleet executors.

Kept dependency-free (stdlib only) so model code can import it without
pulling the runtime/session stack.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

_ACTIVE: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "repro_gemm_hook", default=None)


def active() -> Optional[Callable]:
    """The installed hook, or ``None`` (monolithic ``x @ w``)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_hook(fn: Callable):
    """Install ``fn(x, w) -> out`` as the projection-GEMM hook for the
    dynamic extent of the ``with`` block.  Hooks do not nest: opening a
    session inside a session is a programming error."""
    if _ACTIVE.get() is not None:
        raise RuntimeError("a projection-GEMM hook is already installed; "
                           "fleet training sessions do not nest")
    token = _ACTIVE.set(fn)
    try:
        yield fn
    finally:
        _ACTIVE.reset(token)
