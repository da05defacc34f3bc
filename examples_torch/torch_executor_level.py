"""Execute one GemmDag level on the port's torch fleet executor (the
counterpart of ``examples/jax_executor_level.py``).

The session plans a (tiny) batch, takes the first DAG level -- mutually
independent GEMMs (Eq. 1) -- and runs it through the band GEMM kernel
(``backend="torch"``): each GEMM's sub-task rectangles gathered into
padded bands, one kernel launch per bucket on the card (its plain version
on the CPU), under the f32 policy (the card's default computes in bf16),
with the same Freivalds verification and churn-recovery semantics as the
numpy stand-in.  The report pairs the measured wall time with the event
engine's ``price_plan`` prediction for the same level, and a mid-level
device failure shows the recovery path producing the same numbers.
Errors are relative to the float64 product's largest value.

Run (CUDA card):  PYTHONPATH=src python examples_torch/torch_executor_level.py
Run (CPU):        PYTHONPATH=src python examples_torch/torch_executor_level.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config


def _host(x) -> np.ndarray:
    return x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the runtime's tensors and kernels live "
                         "(cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # small reduced arch so the level's operands stay small
    cfg = get_config("opt-13b").reduced(n_layers=1, vocab_size=256)
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(16, seed=0),
                            device=dev)

    report = rt.plan(batch=2, seq=32)
    level = report.schedule.dag.levels()[0]
    print(f"level 0: {[g.name for g in level]}")

    rng = np.random.default_rng(0)

    def operands(g):
        A = rng.standard_normal((g.m, g.n)).astype(np.float32)
        B = rng.standard_normal((g.n, g.q)).astype(np.float32)
        return A, B

    pairs = [operands(g) for g in level]

    # 1. the level on the torch backend (the band GEMM kernel on the card)
    lev = rt.execute_level(pairs, gemms=level, backend="torch",
                           dtype_policy="f32")
    print(f"torch backend: {lev.n_tasks} sub-GEMM tasks, "
          f"verified={lev.verified}, wall={lev.level_time * 1000:.0f}ms, "
          f"engine-priced makespan={lev.predicted_makespan:.2f}s")

    # 2. same level on the numpy stand-in: same numbers (<=1e-5 relative)
    lev_np = rt.execute_level(pairs, gemms=level, backend="numpy")
    worst = max(
        float(np.max(np.abs(_host(a.output) - b.output))
              / np.max(np.abs(b.output)))
        for a, b in zip(lev.steps, lev_np.steps))
    print(f"numpy parity: worst relative deviation {worst:.2e}")

    # 3. survive a mid-level failure on the torch backend: the failed
    #    device's rectangles are re-solved over survivors and the output
    #    is still exact
    victim = lev.steps[0].plan.assignments[0].device_id
    step = rt.execute_step(*pairs[0], gemm=level[0], backend="torch",
                           fail_ids=[victim], dtype_policy="f32")
    A, B = pairs[0]
    want = A.astype(np.float64) @ B.astype(np.float64)
    err = float(np.max(np.abs(_host(step.output) - want))
                / np.max(np.abs(want)))
    print(f"failure round trip: {step.n_recovered} recovered tasks, "
          f"relative error {err:.2e}")

    # 4. or walk the whole (truncated) DAG on the torch backend
    batch = rt.execute_batch(2, 32, backend="torch", max_levels=4, seed=1,
                             dtype_policy="f32")
    print(f"batch walk: {batch.n_levels} levels, {batch.n_tasks} tasks, "
          f"verified={batch.verified}, "
          f"predicted gemm time {batch.predicted_gemm_time:.2f}s")
    return {"level": lev, "level_numpy": lev_np, "parity": worst,
            "step": step, "err": err, "batch": batch}


if __name__ == "__main__":
    main()
