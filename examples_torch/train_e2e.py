"""End-to-end training with the port (the counterpart of
``examples/train_e2e.py``): train a ~25-100M-param dense model for a few
hundred steps on the synthetic corpus, with checkpointing and loss
tracking.  A thin wrapper over ``repro_torch.launch.train``.

Run (the card, the default scale):
    PYTHONPATH=src python examples_torch/train_e2e.py
Faster sanity run on the CPU:
    PYTHONPATH=src python examples_torch/train_e2e.py --steps 2 --layers 2 \
        --d-model 128 --vocab 512 --batch 2 --seq 64 --device cpu

PS-centric fleet training (every projection GEMM planned, executed on the
band GEMM kernel, Freivalds-verified -- and churn-recovered -- on a
simulated edge fleet, §3.2; the PS runs attention on the flash-attention
kernel, the loss and AdamW on the card):
    PYTHONPATH=src python examples_torch/train_e2e.py --backend fleet \
        --steps 5 --batch 2 --seq 32 --fleet-devices 16 --fail-step 2
"""
import argparse

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--edge-plan", type=int, default=0, metavar="N",
                    help="also project this run onto an N-device edge "
                         "fleet via the TorchCleaveRuntime session API")
    ap.add_argument("--backend", default="torch", choices=("torch", "fleet"),
                    help="fleet: run every training GEMM through the "
                         "TorchCleaveRuntime fleet executors (PS-centric, "
                         "§3.2)")
    ap.add_argument("--fleet-devices", type=int, default=16)
    ap.add_argument("--fail-step", type=int, default=None,
                    help="fleet backend: inject a device failure during "
                         "this step (exercises churn.recover mid-step)")
    ap.add_argument("--device", default="cuda",
                    help="where the PS state and the kernels run (cpu: the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cmd = ["--arch", "llama3-8b", "--reduced",
           "--layers", str(args.layers), "--d-model", str(args.d_model),
           "--vocab", str(args.vocab), "--steps", str(args.steps),
           "--batch", str(args.batch), "--seq", str(args.seq),
           "--lr", "6e-4", "--log-every", "10", "--device", args.device]
    if args.ckpt_dir:
        cmd += ["--ckpt-dir", args.ckpt_dir]
    if args.edge_plan:
        cmd += ["--edge-plan", str(args.edge_plan)]
    if args.backend == "fleet":
        cmd += ["--backend", "fleet",
                "--fleet-devices", str(args.fleet_devices),
                "--log-every", "1"]
        if args.fail_step is not None:
            cmd += ["--fail-step", str(args.fail_step), "--fail-ids", "1"]
    return {"history": train.run(cmd)}


if __name__ == "__main__":
    main()
