"""Edge-fleet simulation: reproduce the paper's headline comparisons with
the port (Fig 3 row, Fig 8 strong scaling, Fig 6 stragglers; the
counterpart of ``examples/edge_simulation.py``).

The experiment drivers in ``repro_torch.sim.simulator`` all price CLEAVE
through the ``repro_torch.api.TorchCleaveRuntime`` session
(unicast/broadcast are accounting strategies on the runtime, not separate
code paths).  Pricing is host-side numpy: it makes no tensor and launches
no kernel.  ``--device`` names where the port runs, as for every example,
and the script refuses to start on a host without CUDA unless it is
``cpu``.

Run (the card's host):  PYTHONPATH=src python examples_torch/edge_simulation.py
Run (CPU):              PYTHONPATH=src python examples_torch/edge_simulation.py --device cpu
"""
import argparse

from repro_torch import resolve_device
from repro_torch.api import BroadcastAccounting, UnicastAccounting
from repro_torch.sim import simulator as S


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (cpu: a host without CUDA)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    print("=== Fig 3 / Table 8: per-batch runtime, Llama2-13B, 512 devices "
          "===")
    row = S.compare_systems("llama2-13b", 128, 1024, 512,
                            accounting=UnicastAccounting.name)
    row_b = S.compare_systems("llama2-13b", 128, 1024, 512,
                              accounting=BroadcastAccounting.name)
    print(f"  CLEAVE (Eq.3 unicast):      {row['cleave']:8.1f} s")
    print(f"  CLEAVE (idealized §3.1):    {row_b['cleave']:8.1f} s   "
          f"(paper Table 8: 16.6 s)")
    print(f"  DTFM:                       {row['dtfm']:8.1f} s   "
          f"(paper Table 8: 3466.7 s)")
    print(f"  Alpa:                       {row['alpa']:8.1f} s")
    print(f"  Cloud A100:                 {row['cloud']:8.1f} s   "
          f"(paper Table 8: 33.6 s)")
    print(f"  per-device comm: {row['cleave_comm_mb'] / 1e3:.1f} GB;  "
          f"per-device memory: {row['cleave_mem_mb']:.0f} MB")

    print("\n=== Fig 8: strong scaling (OPT-13B) ===")
    scaling = S.scaling_devices(counts=(32, 64, 128, 256, 512))
    for r in scaling:
        print(f"  D={r['devices']:5d}  cleave={r['cleave']:8.1f}s  "
              f"dtfm={r['dtfm']:8.1f}s  "
              f"comm/dev={r['cleave_comm_mb'] / 1e3:6.1f}GB")

    print("\n=== Fig 6: stragglers (OPT-13B, 32 devices) ===")
    stragglers = S.straggler_experiment(fractions=(0.0, 0.1, 0.2))
    for r in stragglers:
        print(f"  straggler={r['fraction']:.0%}  "
              f"cleave={r['cleave_norm']:5.2f}x"
              f"  alpa={r['alpa_norm']:5.2f}x  ideal={r['ideal_norm']:5.2f}x")
    return {"table8": row, "table8_broadcast": row_b, "scaling": scaling,
            "stragglers": stragglers}


if __name__ == "__main__":
    main()
