"""Fleet timeline simulation with the port: price the scenarios the closed
form cannot (the counterpart of ``examples/fleet_timeline.py``).

The discrete-event engine replays a solved batch schedule as queued
PS/device resources, so mid-batch failure (§4.2), a joiner folded in at the
next level (§3.2), hidden foreground slowdowns (App. C.5), Pareto stage
jitter (App. C), and PS link saturation (§6) all become priceable -- while
the deterministic replay reproduces the analytic accounting exactly.
``TorchCleaveRuntime.simulate`` prices on the host (numpy); the runtime
itself is built on ``--device``.

Run (the card's host):  PYTHONPATH=src python examples_torch/fleet_timeline.py
Run (CPU):              PYTHONPATH=src python examples_torch/fleet_timeline.py --device cpu
"""
import argparse

from repro_torch import resolve_device
from repro_torch.api import Fleet, TorchCleaveRuntime, fail, join, slowdown
from repro_torch.core import cost_model as cm

BATCH, SEQ = 16, 256


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the runtime lives (cpu: a host without "
                         "CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rt = TorchCleaveRuntime(arch="opt-13b", fleet=Fleet.sample(64, seed=0),
                            device=dev)
    out = {}

    ana = rt.simulate(BATCH, SEQ, backend="analytic")
    det = rt.simulate(BATCH, SEQ, backend="event")
    out.update(analytic=ana, deterministic=det)
    print("=== deterministic replay (must equal the closed form) ===")
    print(f"  analytic batch time: {ana.makespan:9.2f} s")
    print(f"  event-engine replay: {det.makespan:9.2f} s   "
          f"({det.n_events:,} events, {det.events_per_sec:,.0f} ev/s)")

    print("\n=== mid-batch failure (churn.recover replayed as repair "
          "chains) ===")
    victim = max(det.device_busy, key=det.device_busy.get)
    rep = out["failure"] = rt.simulate(
        BATCH, SEQ, backend="event",
        events=[fail(det.makespan * 0.3, victim)])
    print(f"  device {victim} fails at t={det.makespan * 0.3:.1f}s: "
          f"batch {rep.makespan:.2f} s, recovery latency "
          f"{rep.recovery_latency * 1e3:.1f} ms, "
          f"{rep.recomputed_fraction:.1%} of the level recomputed")

    print("\n=== hidden 8x slowdown, then recovery (App. C.5) ===")
    rep = out["slowdown"] = rt.simulate(
        BATCH, SEQ, backend="event",
        events=[slowdown(0.0, victim, 8.0),
                slowdown(det.makespan * 0.6, victim, 1 / 8.0)])
    print(f"  batch {rep.makespan:.2f} s (vs {det.makespan:.2f} s nominal)")

    print("\n=== joiner folded in at the next level (§3.2) ===")
    fast = cm.Device(flops=5e13, dl_bw=2e8, ul_bw=5e7, device_id=10_000)
    rep = out["join"] = rt.simulate(BATCH, SEQ, backend="event",
                                    events=[join(det.makespan * 0.05, fast)])
    print(f"  batch {rep.makespan:.2f} s (joiner absorbs "
          f"{rep.device_busy.get(max(rep.device_busy), 0):.1f} "
          f"busy-seconds)")

    print("\n=== Pareto(2) stage jitter (App. C tails) ===")
    rep = out["jitter"] = rt.simulate(BATCH, SEQ, backend="event",
                                      jitter_alpha=2.0, seed=0)
    print(f"  batch {rep.makespan:.2f} s "
          f"({rep.makespan / det.makespan:.2f}x the deterministic time)")

    print("\n=== PS link saturation (§6 envelope) ===")
    tight = TorchCleaveRuntime(arch="opt-13b", fleet=Fleet.sample(64, seed=0),
                               ps=cm.PSConfig(net_bw=2e8), device=dev)
    rep = out["contention"] = tight.simulate(BATCH, SEQ, backend="event",
                                             ps_contention=True)
    print(f"  0.2 GB/s PS: batch {rep.makespan:.2f} s, transfers queued "
          f"{rep.ps_egress_wait:.0f} s in aggregate on egress")
    return out


if __name__ == "__main__":
    main()
