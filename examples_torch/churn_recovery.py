"""Device churn walkthrough (§4.2 / Fig 7) on the port's
`TorchCleaveRuntime` session (the counterpart of
``examples/churn_recovery.py``): fail devices mid-batch, watch the
incremental cache-aware re-solve redistribute only the orphaned sub-GEMM
shards, see the runtime patch its plan cache instead of re-solving cold,
and compare recovery latency against the checkpoint / layer-recompute
baselines.

The GEMM runs on the band GEMM kernel on `--device` under the f32 policy
(the card's default computes in bf16); its error is printed relative to
the float64 product's largest value.

Run (CUDA card):  PYTHONPATH=src python examples_torch/churn_recovery.py
Run (CPU):        PYTHONPATH=src python examples_torch/churn_recovery.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.core import churn, cost_model as cm
from repro_torch.sim import simulator as S


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

    rt = TorchCleaveRuntime(arch="opt-13b", fleet=Fleet.sample(256, seed=0),
                            device=dev)
    print(f"fleet: {len(rt.fleet)} devices; system MTBF at 1%/hr churn: "
          f"{rt.fleet.mtbf_minutes():.0f} min")

    # a representative weight GEMM mid-level
    g = cm.GEMM(m=2048, n=4096, q=2048)
    plan = rt.plan_gemm(g)
    print(f"GEMM {g.m}x{g.n}x{g.q}: {len(plan.assignments)} sub-GEMM "
          f"shards, makespan {plan.makespan:.2f}s")

    recoveries = {}
    for n_fail in (1, 4, 16):
        victims = sorted({a.device_id for a in plan.assignments})[:n_fail]
        event = churn.FailureEvent(gemm=g, failed_ids=victims, plan=plan)
        rec = churn.recover(event, rt.fleet.devices)
        recoveries[n_fail] = rec
        print(f"  {n_fail:2d} failures -> re-solve "
              f"{rec.solve_time * 1000:6.1f}ms, "
              f"recovery {rec.recovery_time:6.3f}s, "
              f"recomputed {rec.recomputed_fraction * 100:5.2f}% of the "
              f"output")

    # numerical proof: output exact after failure + recovery + eviction
    rng = np.random.default_rng(0)
    A = rng.standard_normal((g.m, g.n)).astype(np.float32)
    B = rng.standard_normal((g.n, g.q)).astype(np.float32)
    want = A.astype(np.float64) @ B
    victim = plan.assignments[0].device_id
    step = rt.execute_step(A, B, gemm=g, fail_ids=[victim],
                           dtype_policy="f32")
    err = _rel_err(step.output, want)
    print(f"post-recovery output error (relative to the largest value): "
          f"{err:.2e} (verified={step.verified})")

    report = rt.on_failure([victim])
    print(f"eviction: {report.n_plans_patched} cached plans patched "
          f"(+{report.n_plans_carried} carried) in "
          f"{report.solve_time * 1000:.0f}ms; re-executing warm...")
    step2 = rt.execute_step(A, B, gemm=g, dtype_policy="f32")
    err2 = _rel_err(step2.output, want)
    print(f"post-eviction output error: {err2:.2e} "
          f"(plan_cached={step2.plan_cached})")

    print("\n=== Fig 7: recovery latency vs baselines (OPT-13B, 256 dev) ===")
    out = S.churn_experiment(n_devices=256)
    for k in ("cleave", "asteroid", "bamboo", "swarm", "mario"):
        extra = ""
        if k != "cleave":
            extra = f"  ({out[k] / out['cleave']:6.0f}x slower)"
        print(f"  {k:10s} {out[k]:8.2f} s{extra}")
    return {"plan": plan, "recoveries": recoveries, "step": step,
            "eviction": report, "step2": step2, "err": err, "err2": err2,
            "fig7": out}


if __name__ == "__main__":
    main()
