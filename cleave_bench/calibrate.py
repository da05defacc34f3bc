"""Reads, for a cell and many seeds in one process, the numbers that
decide ``correct``: the program against the plain reference (the lower
readings), the control (the reference in fp8 put in the program's place)
and the fault of a step that leaves half of the batch out (the reference
on half the rows), each against the reference.  A step that returns its
state unchanged reads 1 by the norm gaps and needs no run.

    python3 cleave_bench/calibrate.py --workload deepseek-v2.train.fleet16 \\
        --seeds 11 12 13 [--out readings.jsonl]

One JSON line per seed.  The limits in ``limits/<workload>.json`` are set
from these readings.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (the environment and paths of a run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults-on", type=int, default=3,
                    help="read the control and the fault on this many of "
                         "the seeds, the first ones")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if len(args.seeds) > 1:
        # one process a seed: a dropped session of the port keeps some of
        # its device memory (its operand cache and autograd graph refer to
        # each other), so seeds do not share a card's memory
        import subprocess
        for i, seed in enumerate(args.seeds):
            cmd = [sys.executable, __file__, "--workload", args.workload,
                   "--seeds", str(seed),
                   "--faults-on", str(int(i < args.faults_on))]
            if args.out:
                cmd += ["--out", args.out]
            rc = subprocess.call(cmd)
            if rc:
                return rc
        return 0
    run._environment()
    import torch

    from cbench import check, harness, spec

    torch.set_num_threads(run.THREADS)
    cell = spec.load_cell(args.workload, run.ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        s = harness.Session(cell, seed, dev)
        prog = s.check_steps()
        prog.pop("last")
        verified = prog.pop("verified")
        peak = torch.cuda.max_memory_allocated(dev)
        s.close()
        left = torch.cuda.memory_allocated(dev)
        t1 = time.perf_counter()
        ref = harness.reference_readings(cell, seed, dev, s.check_batches)
        t2 = time.perf_counter()
        med = sorted(ref["grad1"])[len(ref["grad1"]) // 2]
        keep = [g >= check.QUIET * med for g in ref["grad1"]]
        row = {"workload": args.workload, "seed": seed,
               "optimizer": cell.traffic["optimizer"],
               "worst_grad1": check.worst(prog["grad1"], ref["grad1"],
                                          ref["paths"]),
               "worst_change": check.worst(prog["change"], ref["change"],
                                           ref["paths"], keep),
               "program": check.readings(prog, ref),
               "program_losses": prog["losses"],
               "reference_losses": ref["losses"],
               "program_grad_norms": prog["grad_norms"],
               "program_grad1": prog["grad1"], "reference_grad1": ref["grad1"],
               "paths": ref["paths"],
               "reference_grad_norms": ref["grad_norms"],
               "verified": verified, "program_peak_gb": peak / 1e9,
               "left_after_close_gb": left / 1e9,
               "program_s": t1 - t0, "reference_s": t2 - t1,
               "reference_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        if i < args.faults_on:
            ctl = harness.reference_readings(cell, seed, dev,
                                             s.check_batches, "fp8")
            row["control"] = check.readings(ctl, ref)
            half = harness.reference_readings(
                cell, seed, dev, s.check_batches,
                rows=slice(0, cell.traffic["batch"] // 2))
            row["half_batch"] = check.readings(half, ref)
        row["unchanged"] = check.readings(
            dict(check.unchanged(ref["paths"]), losses=ref["losses"]), ref)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
