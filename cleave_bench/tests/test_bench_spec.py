"""Every file a cell needs is found by the names in BENCHMARK.json."""
import json

import pytest
from conftest import BENCH, ROOT

from cbench import spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = [m["name"] for m in BENCHMARK["per_layer"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = spec.load_cell(workload, ROOT)
    assert cell.config["name"] == cell.workload["config"]
    assert set(cell.limits) == {"loss_gap", "grad1_gap", "change_gap"}
    fam = spec.family(cell.config)
    for fn in ("layout", "loss", "matmul_params", "mixer_flops"):
        assert callable(getattr(fam, fn))
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "train_tokens_per_s"} <= names
    assert cell.per_layer


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric).read)


def test_paths_hold_the_benchmark_alone():
    assert BENCHMARK["paths"] == ["cleave_bench"]
    for c in BENCHMARK["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("cleave_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in BENCHMARK["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
