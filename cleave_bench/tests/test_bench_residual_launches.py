"""The reader of the program's ``fleet.residual_launches`` counter, on stub
readings: the mean a step, and nothing where the program never counts it
(a program without the fused residual kernel, or with no counters)."""
import json
from types import SimpleNamespace

import pytest
from conftest import ROOT

from cbench import harness, spec

NAME = "fleet_residual_launches_per_step"


def _reading(reports):
    return harness.Reading(cell=None, flops_per_step=0.0, window=None,
                           reports=reports, trace=None)


def _reports(*counters):
    return [SimpleNamespace(spans={"fleet.launch": 0.01}, counters=c)
            for c in counters]


def test_reader_is_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {x["name"]: x for x in bench["per_layer"]}[NAME]
    assert m["source"] == "program_counter"
    assert m["moves"] == "train_tokens_per_s"
    assert m["layer"] == "fleet executor"
    assert m["workloads"] == ["deepseek-v2.train.fleet16"]


def test_reader_gives_the_mean_a_step():
    reps = _reports({"fleet.residual_launches": 114,
                     "fleet.stage_copies": 40},
                    {"fleet.residual_launches": 112})
    assert spec.reader(NAME).read(_reading(reps)) == pytest.approx(113.0)
    # a step that counted none among steps that did
    reps = _reports({"fleet.residual_launches": 114}, {})
    assert spec.reader(NAME).read(_reading(reps)) == pytest.approx(57.0)


@pytest.mark.parametrize("reports", [
    _reports({"fleet.stage_copies": 40}, {"fleet.flagged": 1}),
    [SimpleNamespace(fleet_exec_time=1.0)] * 2,
    [],
], ids=["counters_without_it", "no_counters", "no_steps"])
def test_reader_silent_without_the_counter(reports):
    """The parent's reports carry counters but never this one: the metric
    falls silent there, as the contract asks, rather than reading 0."""
    assert spec.reader(NAME).read(_reading(reports)) is None


def test_reader_on_the_program_report():
    from repro_torch.train_loop.train_step import SpannedStepReport
    rep = SpannedStepReport(
        step=0, loss=1.0, grad_norm=1.0, lr=1e-4, n_gemms=1, n_tasks=1,
        n_recovered=0, verified=True, gemm_flops=1.0, fleet_exec_time=0.1,
        wall_time=0.2, predicted_makespan=0.0, plan_cache_hit_rate=1.0,
        spans={"fleet.plan": 0.25},
        counters={"fleet.residual_launches": 3})
    assert spec.reader(NAME).read(_reading([rep])) == 3
