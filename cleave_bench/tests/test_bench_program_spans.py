"""The readers of the program's spans and counters, on stub readings:
the mean a step, and nothing where the program's reports carry none."""
import json
from types import SimpleNamespace

import pytest
from conftest import ROOT

from cbench import harness, spec

SPANS = [
    {"fleet.fwd": 0.010, "fleet.plan": 0.002, "fleet.stage": 0.003,
     "ops.stage_copy": 0.001, "fleet.launch": 0.020,
     "fleet.readback": 0.004, "fleet.sync": 0.005, "fleet.scatter": 0.006,
     "fleet.verify": 0.007, "ps.forward": 0.030, "ps.backward": 0.040,
     "ps.adam": 0.050, "moe.dispatch": 0.008, "ps.sync": 0.009},
    {"fleet.fwd": 0.012, "fleet.plan": 0.004, "fleet.stage": 0.001,
     "ops.stage_copy": 0.003, "fleet.launch": 0.022,
     "fleet.readback": 0.002, "fleet.sync": 0.001, "fleet.scatter": 0.004,
     "fleet.verify": 0.005, "fleet.oracle": 0.006, "ps.forward": 0.034,
     "ps.backward": 0.036, "ps.adam": 0.052, "ps.sync": 0.011},
]
COUNTERS = [{"fleet.stage_copies": 40},
            {"fleet.stage_copies": 38, "fleet.flagged": 3,
             "fleet.redispatched": 1}]
# the mean a step of each metric over the two stub steps
WANT = {
    "fleet_plan_ms_per_step": 3.0,
    "fleet_stage_ms_per_step": 4.0,
    "fleet_launch_ms_per_step": 21.0,
    "fleet_scatter_ms_per_step": 5.0,
    "fleet_wait_ms_per_step": 6.0,
    "fleet_verify_ms_per_step": 9.0,
    "fleet_oracle_checks_per_step": 1.5,
    "fleet_stage_copies_per_step": 39.0,
    "ps_host_ms_per_step": 125.0,
    "ps_sync_ms_per_step": 10.0,
}
NAMES = sorted(WANT)


def _reading(reports):
    return harness.Reading(cell=None, flops_per_step=0.0, window=None,
                           reports=reports, trace=None)


def test_every_reader_is_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = declared[name]
        assert m["source"] == "program_counter"
        assert m["moves"] == "train_tokens_per_s"


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_the_mean_a_step(name):
    reps = [SimpleNamespace(spans=s, counters=c)
            for s, c in zip(SPANS, COUNTERS)]
    got = spec.reader(name).read(_reading(reps))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_silent_without_spans(name):
    """Reports of a program with no spans (the parent's
    ``FleetStepReport``) and an empty window give nothing."""
    bare = [SimpleNamespace(fleet_exec_time=1.0) for _ in range(2)]
    assert spec.reader(name).read(_reading(bare)) is None
    assert spec.reader(name).read(_reading([])) is None


def test_reader_on_the_program_report():
    """The port's own step report is what the readers read."""
    from repro_torch.train_loop.train_step import SpannedStepReport
    rep = SpannedStepReport(
        step=0, loss=1.0, grad_norm=1.0, lr=1e-4, n_gemms=1, n_tasks=1,
        n_recovered=0, verified=True, gemm_flops=1.0, fleet_exec_time=0.1,
        wall_time=0.2, predicted_makespan=0.0, plan_cache_hit_rate=1.0,
        spans={"fleet.plan": 0.25}, counters={"fleet.flagged": 2})
    ctx = _reading([rep])
    assert spec.reader("fleet_plan_ms_per_step").read(ctx) == 250.0
    assert spec.reader("fleet_oracle_checks_per_step").read(ctx) == 2
    assert spec.reader("fleet_launch_ms_per_step").read(ctx) == 0.0
