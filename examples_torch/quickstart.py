"""Quickstart: the CLEAVE pipeline end to end through the port's
`TorchCleaveRuntime` session API (the counterpart of
``examples/quickstart.py``).

One runtime object owns the whole plan -> execute -> recover loop:

1. `TorchCleaveRuntime(arch=..., fleet=Fleet.sample(...))` -- model + edge
   fleet; the runtime keeps its tensors and runs its kernels on `--device`.
2. `rt.plan(batch, seq)` -- trace the GEMM DAG and solve the schedule; a
   second call for the same shapes is a near-free cache hit (Table 7
   cold-start amortization).
3. `rt.execute_step(A, B, fail_ids=[...])` -- execute one GEMM's sub-task
   plan on the band GEMM kernel with Freivalds verification, surviving a
   mid-level device failure.  The example asks for the f32 policy (the
   card's default computes in bf16).
4. `rt.on_failure([...])` -- evict the failed device; cached plans are
   incrementally *patched* (§4.2), so the next step re-plans warm.

The error is printed relative to the float64 product's largest value: the
port computes in f32 where the reference's numpy stand-in works in f64.

Run (CUDA card):  PYTHONPATH=src python examples_torch/quickstart.py
Run (CPU):        PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.core import cost_model as cm


def _rel_err(out: torch.Tensor, want: np.ndarray) -> float:
    """Largest deviation from the f64 product over its largest value."""
    got = out.detach().double().cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the runtime's tensors and kernels live "
                         "(cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. one session object: OPT-13B over 256 heterogeneous edge devices
    rt = TorchCleaveRuntime(arch="opt-13b", fleet=Fleet.sample(256, seed=0),
                            accounting="unicast", device=dev)
    print(f"model: {rt.cfg.name}  params={rt.cfg.n_params() / 1e9:.1f}B")
    print(f"fleet: {rt.fleet}")

    # 2. plan the batch schedule (cold), then again (cache hit)
    report = rt.plan(batch=128, seq=1024)
    dag = report.schedule.dag
    print(f"DAG: {len(dag.gemms)} GEMM nodes, {dag.n_levels} levels, "
          f"{dag.total_flops() / 1e12:.0f} TFLOPs/batch")
    print(f"schedule: batch_time={report.batch_time:.1f}s "
          f"(gemm={report.gemm_time:.1f}s + optimizer tail "
          f"{report.opt_tail * 1000:.0f}ms); "
          f"solved {report.cache_misses} unique shapes "
          f"in {report.solve_time:.2f}s")
    print(f"per-device comm <= {report.per_device_comm / 1e9:.1f} GB, "
          f"per-device memory <= {report.per_device_mem / 1e6:.0f} MB "
          f"(phone budget: 512 MB)")
    warm = rt.plan(batch=128, seq=1024)
    print(f"re-plan (cache hit): {warm.solve_time * 1e6:.0f}us, "
          f"{report.solve_time / max(warm.solve_time, 1e-9):.0f}x faster "
          f"than cold solve")

    # 3. execute one weight GEMM's plan, kill a device mid-level, verify
    rng = np.random.default_rng(0)
    g = cm.GEMM(m=1024, n=2048, q=1024)
    gplan = rt.plan_gemm(g)
    A = rng.standard_normal((g.m, g.n)).astype(np.float32)
    B = rng.standard_normal((g.n, g.q)).astype(np.float32)
    want = A.astype(np.float64) @ B
    victim = gplan.assignments[0].device_id
    step = rt.execute_step(A, B, gemm=g, fail_ids=[victim],
                           dtype_policy="f32")
    err = _rel_err(step.output, want)
    print(f"executed {step.n_tasks} sub-GEMM tasks "
          f"({step.n_recovered} recovered after killing device {victim}); "
          f"max error vs monolithic product (relative to its largest "
          f"value): {err:.2e}; Freivalds verified: {step.verified}")
    print(f"recovery: {step.recovery.recomputed_fraction * 100:.2f}% of the "
          f"output recomputed in {step.recovery.recovery_time:.3f}s "
          f"(re-solve took {step.recovery.solve_time * 1000:.0f}ms)")

    # 4. evict the failed device: the plan cache is patched, not rebuilt
    churn = rt.on_failure([victim])
    print(f"churn: {churn.n_plans_patched} cached plans patched, "
          f"{churn.n_plans_carried} carried unchanged, in "
          f"{churn.solve_time * 1000:.0f}ms "
          f"({churn.n_survivors} survivors); next step is warm")
    step2 = rt.execute_step(A, B, gemm=g, dtype_policy="f32")
    err2 = _rel_err(step2.output, want)
    print(f"post-churn step: plan_cached={step2.plan_cached}, "
          f"max error {err2:.2e}")
    return {"report": report, "step": step, "churn": churn, "step2": step2,
            "err": err, "err2": err2}


if __name__ == "__main__":
    main()
