import os
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def tiny_cell():
    """A cell of the benchmark's form at a size the CPU runs in seconds:
    ``tiny_cell("tiny-deepseek")``."""
    from cbench import spec

    def make(config, **limits):
        return spec.Cell(
            workload={"name": f"{config}.test", "chips": 1},
            config=spec.load_json(DATA / f"{config}.json"),
            traffic=spec.load_json(DATA / "tiny-traffic.json"),
            limits=limits or dict(TINY_LIMITS),
            end_to_end=[{"name": "train_tokens_per_s", "unit": "tokens/s"},
                        {"name": "peak_device_gb", "unit": "GB"},
                        {"name": "setup_s", "unit": "s"}],
            per_layer=[])
    return make


# limits for the tiny cells, from their CPU readings at the tests' seed:
# the program (the port's f32 policy on the CPU) against the bf16
# reference reads at most 2.5e-4 (loss), 5.1e-3 (first gradient) and
# 3.1e-3 (change); the fp8 control 3.8e-4 / 3.5e-3, 0.11 and 1.6e-2 /
# 2.5e-2; half the batch 2.2e-2, 0.11 and 0.23
TINY_LIMITS = {"loss_gap": 2e-3, "grad1_gap": 2e-2, "change_gap": 1e-2}
os.environ.setdefault("OMP_NUM_THREADS", "2")
