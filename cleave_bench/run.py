"""Runs one cell of the port's benchmark on the machine it is started on
and prints one JSON line as the last line of standard output.

    python3 cleave_bench/run.py --workload deepseek-v2.train.fleet16 \\
        --seed 1234 --seconds 51 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``src/repro_torch``).  The port's kernels are built into
``build/`` inside the checkout on the first run and found there by the
next.  Exits non-zero, printing no result, without the CUDA cards the
cell asks for, when the window holds a cold plan solve, or when JAX or
the JAX package was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# host threads of torch's intra-op pool and the BLAS pools: one and four
# read alike on the card (the host's share of a step is the fleet
# executors' Python), and a process with fewer threads takes less from
# the cores that it shares
THREADS = 1
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment():
    build = ROOT / "build"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(build / "repro_torch"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    for p in (str(BENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_loaded():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program under test: {ROOT / 'src' / 'repro_torch'} is "
              "missing", file=sys.stderr)
        return 2
    _environment()
    import torch

    from cbench import harness, spec

    torch.set_num_threads(THREADS)
    cell = spec.load_cell(args.workload, ROOT)
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    power = _power_limit()
    try:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), dev, STARTED,
                               log=lambda m: print(m, file=sys.stderr))
    except harness.RunFailed as err:
        print(f"run failed: {err}", file=sys.stderr)
        return 4
    loaded = forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    traced = out.get("traced")
    if traced is not None:
        device["busy_s"] = traced.busy_s
        device["window_s"] = traced.stretch_s
        line["breakdown"] = {"device_ops": traced.device_ops,
                             "idle_gaps": traced.idle_gaps}
    line["card"] = power
    line["window"] = out["window"]
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
