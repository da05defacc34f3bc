"""The port's host-clock spans and counters (``repro_torch.core.spans``):
the helper's arithmetic, and the spans a fleet training step and a fleet
GEMM report on the CPU."""
import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.core import spans
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.train_loop.train_step import (FleetStepReport,
                                               SpannedStepReport)

# every span a clean fleet training step opens (``fleet.oracle`` opens
# only for a flagged block)
STEP_SPANS = ("fleet.fwd", "fleet.dA", "fleet.dW", "fleet.plan",
              "fleet.stage", "ops.stage_copy", "fleet.launch",
              "fleet.readback", "fleet.scatter", "fleet.sync",
              "fleet.verify", "ps.forward", "ps.backward", "ps.adam",
              "ps.sync")
PHASES = ("fleet.plan", "fleet.stage", "fleet.launch", "fleet.readback",
          "fleet.scatter", "fleet.sync", "fleet.verify")
CHUNKS = dict(q_chunk=16, k_chunk=16, loss_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(dispatch="level"):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), n_layers=1)
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    sess = rt.train_session(adam.AdamConfig(), kernel="torch",
                            dispatch=dispatch, **CHUNKS)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
             for k in ("tokens", "labels")}
    return sess, params, adam.init(params), batch


def _steps(dispatch, n=2):
    sess, params, opt, batch = _session(dispatch)
    reps = []
    for _ in range(n):
        params, opt, met = sess.step(params, opt, batch)
        reps.append(met["fleet"])
    return sess, params, opt, batch, reps


@pytest.fixture(scope="module")
def level():
    return _steps("level")


@pytest.fixture(scope="module")
def dataflow():
    return _steps("dataflow")


# ------------------------------------------------------------ the helper --

def test_self_time_excludes_children():
    with spans.collect() as t:
        with spans.span("outer"):
            time.sleep(0.01)
            with spans.span("inner"):
                time.sleep(0.02)
            with spans.span("inner"):
                time.sleep(0.02)
    assert 0.04 <= t.spans["inner"] < 0.06
    assert 0.01 <= t.spans["outer"] < 0.03


def test_nested_tally_adds_to_the_outer():
    with spans.collect() as outer:
        with spans.span("a"):
            spans.count("n")
            with spans.collect() as inner:
                with spans.span("b"):
                    spans.count("n", 2)
            assert set(inner.spans) == {"b"} and inner.counters == {"n": 2}
    assert set(outer.spans) == {"a", "b"}
    assert outer.counters == {"n": 3}
    assert outer.spans["b"] == inner.spans["b"]


def test_no_tally_no_record():
    """With no tally open a span records nothing and a count is lost."""
    with spans.span("x"):
        spans.count("y")
    with spans.collect() as t:
        pass
    assert t.spans == {} and t.counters == {}


def test_own_chain_keeps_a_thread_apart():
    """A thread on its own chain tallies apart from the chain it runs
    beside; ``merge`` then joins it."""
    got = {}

    def work():
        with spans.collect(own=True) as t:
            with spans.span("worker"):
                spans.count("w")
        got["t"] = t

    with spans.collect() as main:
        with spans.span("main"):
            th = threading.Thread(target=work)
            th.start()
            th.join()
        assert "worker" not in main.spans
        spans.merge(got["t"])
    assert set(got["t"].spans) == {"worker"}
    assert set(main.spans) == {"main", "worker"}
    assert main.counters == {"w": 1}


def test_profiler_off_opens_no_record_function(monkeypatch, level):
    """With no profiler recording, a step opens no ``record_function``."""
    sess, params, opt, batch, _ = level
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    sess.step(params, opt, batch)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("fleet.plan"):
            pass
    assert calls == ["fleet.plan"]


# -------------------------------------------------------- a training step --

def test_step_report_carries_every_span(level):
    *_, reps = level
    for rep in reps:
        assert isinstance(rep, SpannedStepReport)
        assert isinstance(rep, FleetStepReport)
        assert set(STEP_SPANS) <= set(rep.spans)
        assert all(v >= 0 for v in rep.spans.values())
        assert sum(rep.spans.values()) <= rep.wall_time
        assert rep.counters["fleet.stage_copies"] > 0


def test_clean_step_counts_no_flagged_block(level):
    *_, reps = level
    for rep in reps:
        assert rep.verified
        assert rep.counters.get("fleet.flagged", 0) == 0
        assert rep.counters.get("fleet.redispatched", 0) == 0


def test_records_hold_their_phases(level):
    """Each GEMM's record holds its phases, which lie inside its executor
    time and its plan work; the step sums every record's and adds the
    ``fleet.<kind>`` spans' own."""
    *_, reps = level
    rep = reps[-1]
    assert rep.records
    total = {}
    for r in rep.records:
        assert set(r.spans) <= set(PHASES) | {"ops.stage_copy"}
        assert {"fleet.launch", "fleet.verify", "fleet.scatter"} \
            <= set(r.spans)
        assert sum(r.spans.values()) \
            <= r.exec_time + r.spans.get("fleet.plan", 0.0)
        for k, v in r.spans.items():
            total[k] = total.get(k, 0.0) + v
    for k, v in total.items():
        assert rep.spans[k] == pytest.approx(v, rel=1e-9, abs=1e-12)
    assert sum(r.counters.get("fleet.stage_copies", 0)
               for r in rep.records) == rep.counters["fleet.stage_copies"]


def test_session_keeps_spans_without_records(level):
    sess, *_, reps = level
    kept = sess.reports[len(reps) - 1]      # later tests step on
    assert kept.records == [] and kept.spans == reps[-1].spans


def test_dataflow_verify_lands_on_records(dataflow):
    """Under ``dispatch="dataflow"`` the deferred check runs on the
    verify worker; ``drain()`` puts its spans on each GEMM's record and
    into the step's tally."""
    *_, reps = dataflow
    rep = reps[-1]
    assert rep.verified and rep.records
    for r in rep.records:
        assert r.spans["fleet.verify"] > 0
    assert rep.spans["fleet.verify"] == pytest.approx(
        sum(r.spans["fleet.verify"] for r in rep.records), rel=1e-9)
    # the checks ran beside the step: the rest lies inside its wall
    assert sum(v for k, v in rep.spans.items()
               if k not in ("fleet.verify", "fleet.oracle")) <= rep.wall_time


def test_phase_ranges_nest_in_fleet_ranges_under_the_profiler(level):
    sess, params, opt, batch, _ = level
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.step(params, opt, batch)
    kinds = ("fleet.fwd", "fleet.dA", "fleet.dW")
    seen = {k: set() for k in kinds}
    for evt in prof.events():
        if evt.name not in PHASES:
            continue
        node = evt.cpu_parent
        while node is not None and node.name not in kinds:
            node = node.cpu_parent
        assert node is not None, evt.name
        seen[node.name].add(evt.name)
    for k in kinds:
        assert seen[k] == set(PHASES), k
    names = {e.name for e in prof.events()}
    assert {"ps.forward", "ps.backward", "ps.adam", "ps.sync"} <= names


# ------------------------------------------------------------ one GEMM --

def _rt():
    return TorchCleaveRuntime(
        arch=get_config("opt-13b").reduced(n_layers=2, vocab_size=256),
        fleet=Fleet.sample(8, seed=0), device="cpu")


@pytest.mark.parametrize("m,n,q", [(48, 32, 40), (130, 70, 33)])
def test_corrupt_blocks_counted(m, n, q):
    """A poisoning device: every one of its rectangles is flagged and sent
    to the host oracle, which confirms it, and the PS recomputes it."""
    rt = _rt()
    bad = rt.fleet.devices[0].device_id
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, q)).astype(np.float32))
    st = rt.execute_step(A, B, dtype_policy="f32", corrupt_ids=[bad])
    poisoned = sum(1 for a in st.plan.assignments if a.device_id == bad
                   and a.r1 > a.r0 and a.c1 > a.c0)
    assert poisoned > 0 and not st.verified
    assert st.counters["fleet.flagged"] >= poisoned
    assert st.counters["fleet.redispatched"] == poisoned
    assert st.spans["fleet.oracle"] > 0
    clean = rt.execute_step(A, B, dtype_policy="f32")
    assert clean.verified
    assert clean.counters.get("fleet.flagged", 0) == 0
    assert clean.counters.get("fleet.redispatched", 0) == 0
    assert "fleet.plan" in clean.spans and "fleet.launch" in clean.spans


def test_deferred_step_report_gains_verify_spans():
    rt = _rt()
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    st, fin = rt.execute_step_deferred(A, B, dtype_policy="f32")
    assert "fleet.launch" in st.spans and "fleet.verify" not in st.spans
    fin()
    assert st.spans["fleet.verify"] > 0 and st.verified


def test_batch_steps_carry_spans():
    """``execute_batch`` hands each GEMM's spans to its step report, on
    the level walk and on the dataflow workers' own chains alike."""
    for dispatch in ("level", "dataflow"):
        rep = _rt().execute_batch(2, 16, backend="torch", seed=3,
                                  dispatch=dispatch)
        for s in rep.steps:
            assert "fleet.launch" in s.spans and "fleet.verify" in s.spans


# ------------------------------------------------------- profile_train --

class _Event:
    """A kineto event: with or without ``activity_type`` and ``*_ns``."""

    def __init__(self, name, device, start_us, dur_us, kind, new=True):
        self._n, self._d, self._s, self._t = name, device, start_us, dur_us
        if new:
            self.activity_type = lambda: kind
            self.start_ns = lambda: int(self._s * 1000)
            self.duration_ns = lambda: int(self._t * 1000)

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_us(self):
        return self._s

    def duration_us(self):
        return self._t


@pytest.mark.parametrize("new", [True, False])
def test_profile_train_busy_is_the_union_of_device_intervals(new):
    """The card's busy time is the union of its kernel, copy and set
    intervals: overlaps count once, spans on the device timeline and host
    events not at all."""
    from repro_torch.launch import profile_train
    evs = [_Event("void at::native::k1", "CUDA", 0, 10, "kernel", new),
           _Event("void at::native::k2", "CUDA", 5, 10, "kernel", new),
           _Event("Memcpy DtoD (Device -> Device)", "CUDA", 30, 5,
                  "gpu_memcpy", new),
           _Event("fleet.launch", "CUDA", 0, 100, "gpu_user_annotation",
                  new),
           _Event("aten::mm", "CPU", 0, 100, "cpu_op", new)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    assert profile_train._device_busy_s(prof) == pytest.approx(20e-6)
    assert {"fleet.plan", "fleet.launch", "fleet.readback", "fleet.verify",
            "ps.forward", "ps.backward", "ps.sync"} \
        <= set(profile_train.RANGES)
