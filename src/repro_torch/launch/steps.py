"""The monolithic training step of the port (port of
``src/repro/launch/steps.py``'s ``make_train_step``, without the mesh
rules): ``models.model.loss_fn`` and ``optim.adam.apply`` with every
projection GEMM a plain ``torch.matmul``, as the reference leaves them to
XLA.  The fleet step (``train_loop.FleetTrainSession``) is held against
it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import ieee_f32
from repro_torch import tree as T
from repro_torch.models import model as M
from repro_torch.optim import adam


def make_train_step(cfg, opt_cfg: Optional[adam.AdamConfig] = None, *,
                    q_chunk=256, k_chunk=512, loss_chunk=256,
                    microbatches: int = 1, donate: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    With ``microbatches > 1`` the batch is split along its first axis and
    the gradients accumulate in f32 (activation memory / microbatches).
    ``donate`` updates the caller's params and moments in place
    (``adam.apply(donate=True)``), as the reference's driver jits the step
    with ``donate_argnums=(0, 1)``."""
    opt_cfg = opt_cfg or adam.AdamConfig()
    chunks = dict(q_chunk=q_chunk, k_chunk=k_chunk, loss_chunk=loss_chunk)

    def train_step(params, opt_state, batch):
        # IEEE f32 products, as the fleet's f32 policy and XLA's CPU path
        ieee_f32()
        if microbatches <= 1:
            (loss, metrics), grads = M.value_and_grad(cfg, params, batch,
                                                      **chunks)
        else:
            parts = {k: torch.chunk(v, microbatches) for k, v in
                     batch.items()}
            grads = T.map_tree(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss, ms = 0.0, []
            for i in range(microbatches):
                (l, m), g = M.value_and_grad(
                    cfg, params, {k: v[i] for k, v in parts.items()},
                    **chunks)
                grads = T.map_tree(torch.add, grads, g)
                loss = loss + l
                ms.append(m)
            grads = T.map_tree(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        params2, opt2, opt_metrics = adam.apply(params, grads, opt_state,
                                                opt_cfg, donate=donate)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params2, opt2, metrics

    return train_step
