"""Parameter interchange with the reference package.

:func:`from_jax_params` takes the reference's params as a nested dict of
**numpy** arrays (the caller applies ``np.asarray`` to each JAX leaf) and
returns the port's params in the same layout (with ``dtype``, floating
leaves are cast, except those the reference keeps in float32 whatever the
param dtype is: the MoE router, the SSM's ``A_log`` and ``D``);
:func:`from_jax_opt_state`
carries an ``AdamState`` across the same way, :func:`from_jax_outer_state`
a DiLoCo ``OuterState`` and :func:`from_jax_multi_ps_state` a whole
``MultiPSState``.  A numpy bfloat16 array
(``dtype.name == "bfloat16"``, from ``ml_dtypes``) is reinterpreted through
``uint16`` bits, so the port never imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device, dtype):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.uint16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# leaves that keep their own dtype under ``from_jax_params(dtype=...)``
KEEP_DTYPE = ("router", "A_log", "D")


def from_jax_params(tree, device, dtype=None):
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device``.  With ``dtype``, floating leaves are cast to it, except a
    leaf under a key of :data:`KEEP_DTYPE` (the MoE router and the SSM's
    ``A_log`` and ``D``, float32 in the reference whatever
    ``param_dtype`` is)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device,
                                   None if k in KEEP_DTYPE else dtype)
                for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def from_jax_opt_state(state, device):
    """The reference's ``AdamState`` (``step``, ``mu``, ``nu``; leaves as
    numpy arrays) -> the port's :class:`repro_torch.optim.adam.AdamState`,
    moments on ``device`` and the step counter on the host."""
    from repro_torch.optim.adam import AdamState
    return AdamState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        mu=from_jax_params(state.mu, device),
        nu=from_jax_params(state.nu, device))


def from_jax_outer_state(state, device):
    """The reference's DiLoCo ``OuterState`` (``velocity``, ``anchor``;
    leaves as numpy arrays) -> the port's
    :class:`repro_torch.optim.diloco.OuterState` on ``device``."""
    from repro_torch.optim.diloco import OuterState
    return OuterState(velocity=from_jax_params(state.velocity, device),
                      anchor=from_jax_params(state.anchor, device))


def from_jax_multi_ps_state(state, device):
    """The reference's ``MultiPSState`` (leaves as numpy arrays) -> the
    port's :class:`repro_torch.train_loop.multi_ps.MultiPSState`: each
    island's params and ``AdamState``, the outer state (or ``None``) and
    the clocks."""
    from repro_torch.train_loop.multi_ps import MultiPSState
    return MultiPSState(
        island_params=tuple(from_jax_params(p, device)
                            for p in state.island_params),
        island_opt=tuple(from_jax_opt_state(o, device)
                         for o in state.island_opt),
        outer=None if state.outer is None
        else from_jax_outer_state(state.outer, device),
        inner_step=int(state.inner_step), round=int(state.round))
