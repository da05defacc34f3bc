"""The command fails, printing no result, where it cannot measure: with
no card, and in a directory that holds the benchmark alone.  Nothing it
loads is JAX or the JAX package, and the reference loads nothing of the
program."""
import json
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

WORKLOAD = json.loads((ROOT / "BENCHMARK.json").read_text()
                      )["workloads"][0]["name"]
ARGS = ["--workload", WORKLOAD, "--seed", str(2 ** 31 + 11),
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, "cleave_bench/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "cleave_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


PROBE = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
import reference.common, reference.deepseek_v2, reference.rwkv6
program = sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')
import run, calibrate
from cbench import check, harness, inputs, spec, tracing, window, yardstick
for name in {metrics!r}:
    spec.reader(name)
from repro_torch.api import TorchCleaveRuntime
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(program, [t for t in tops if t in ('jax', 'jaxlib', 'flax', 'repro')])
"""


def test_no_jax_and_a_reference_apart_from_the_program():
    metrics = [m["name"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]]
    code = PROBE.format(bench=str(BENCH), src=str(ROOT / "src"),
                        metrics=metrics)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[] []"
