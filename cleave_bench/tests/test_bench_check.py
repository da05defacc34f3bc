"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size with the card's look skipped: a sound run passes,
the control (the reference in fp8 in the program's place) reads far
above the program, and each fault a training cell can have makes
``correct`` false."""
import pytest
import torch

from cbench import check, harness, inputs

CPU = torch.device("cpu")
SEED = 2 ** 31 + 3
CONFIGS = ["tiny-deepseek", "tiny-rwkv6"]


def _run(cell):
    import time
    return harness.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter(),
                            log=lambda m: None)


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(tiny_cell, config):
    out = _run(tiny_cell(config))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_traced_run_reads_the_profiler_on_the_cpu(tiny_cell):
    import time
    cell = tiny_cell("tiny-rwkv6")
    out = harness.run_cell(cell, SEED, 0.2, True, CPU, time.perf_counter(),
                           log=lambda m: None)
    t = out["traced"]
    assert out["correct"] and t.steps == cell.traffic["trace_steps"]
    assert t.stretch_s > 0 and t.busy_s == 0 and len(t.records) > 0
    assert t.idle_gaps and t.idle_gaps[0][1] > 0


@pytest.mark.parametrize("config", CONFIGS)
def test_control_reads_far_above_the_program(tiny_cell, config):
    cell = tiny_cell(config)
    tr = cell.traffic
    batches = inputs.Tokens(cell.config["vocab_size"], tr["batch"],
                            tr["seq"], SEED, **tr["data"]).device(
        range(tr["check_steps"]), CPU)
    ref = harness.reference_readings(cell, SEED, CPU, batches)
    ctl = check.readings(harness.reference_readings(
        cell, SEED, CPU, batches, "fp8"), ref)
    prog = _run(cell)["checks"]
    assert ctl["grad1_gap"] > 3 * prog["grad1_gap"]["value"]
    assert not check.verdict(ctl, cell.limits)


def _unchanged_apply(params, grads, state, cfg, donate=False):
    from repro_torch.optim.adam import AdamState
    return params, AdamState(step=state.step + 1, mu=state.mu,
                             nu=state.nu), {
        "grad_norm": torch.zeros(()), "lr": torch.zeros(())}


def _half_batch(value_and_grad):
    def broken(cfg, params, batch, **kw):
        rows = batch["tokens"].shape[0] // 2
        return value_and_grad(cfg, params, {k: v[:rows]
                                            for k, v in batch.items()}, **kw)
    return broken


def _altered_output(execute):
    """Every step, the first backward product's first quarter of rows
    comes back doubled, after its verification."""
    def broken(self, a, b, kind):
        out = execute(self, a, b, kind)
        if kind == "dA" and not any(r.kind == "dA" for r in self.records[:-1]):
            out = out.clone()
            out[: max(out.shape[0] // 4, 1)] *= 2.0
        return out
    return broken


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_output"])
def test_fault_makes_correct_false(tiny_cell, monkeypatch, config, fault):
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.train_loop.fleet_gemm import FleetGemmSession
    if fault == "unchanged_state":
        monkeypatch.setattr(adam, "apply", _unchanged_apply)
    elif fault == "half_batch":
        monkeypatch.setattr(model, "value_and_grad",
                            _half_batch(model.value_and_grad))
    else:
        monkeypatch.setattr(FleetGemmSession, "_execute",
                            _altered_output(FleetGemmSession._execute))
    out = _run(tiny_cell(config))
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_on_the_card(tiny_cell, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    dev = torch.device("cuda", 0)
    out = harness.run_cell(tiny_cell(config), SEED, 0.5, True, dev,
                           time.perf_counter(), log=lambda m: None)
    assert out["correct"], out["checks"]


def test_churn_script_fails_and_rejoins_every_step(tiny_cell):
    """A traffic mix's churn script: every step a device fails mid-step,
    is evicted and rejoins before the next; the run stays correct."""
    cell = tiny_cell("tiny-deepseek")
    cell.traffic = dict(cell.traffic, churn={"fail_ids": [1],
                                             "fail_at_gemm": 2,
                                             "rejoin": True})
    s = harness.Session(cell, SEED, CPU)
    rep = s.step(s.pool[0])
    assert rep.failed_ids == (1,) and rep.n_recovered > 0
    assert 1 in s.rt.fleet.ids()
    out = _run(cell)
    assert out["correct"], out["checks"]
