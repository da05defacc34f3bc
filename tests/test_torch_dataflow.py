"""The port's batch execution: ``execute_level`` and ``execute_batch`` with
both dispatches (``core/dataflow.py``) on ``opt-13b.reduced(n_layers=2,
vocab_size=256)`` at batch 2 x 16, both executor backends on the CPU.
Level and dataflow dispatch give bit-identical outputs for a fixed seed,
repeated dataflow runs too, a mid-flight failure and a poisoning device
heal to the clean run's answer; the numpy backend is bit-equal to the
reference's ``execute_batch``, the torch backend within 1e-5 of it."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.api import CleaveRuntime
from repro.api import Fleet as JFleet
from repro.configs.base import get_config as jget_config
from repro_torch.api import (BatchExecuteReport, Fleet, LevelReport,
                             TorchCleaveRuntime)
from repro_torch.api.runtime import device_operands, host_operands
from repro_torch.configs.base import get_config
from repro_torch.core import executor

BACKENDS = ["numpy", "torch"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread for this module.  Its tensors are small,
    and with pytest-xdist's workers sharing the host's cores torch's
    default pool (a thread a core in every worker) spends most of its time
    waiting for descheduled threads: the module ran ~4x slower under five
    busy cores with the default pool than with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rt():
    return TorchCleaveRuntime(
        arch=get_config("opt-13b").reduced(n_layers=2, vocab_size=256),
        fleet=Fleet.sample(8, seed=0), device="cpu")


def _outputs(rep):
    return [np.asarray(s.output) for s in rep.steps]


def _bit_equal(a, b):
    return len(a.steps) == len(b.steps) and all(
        np.array_equal(x, y) for x, y in zip(_outputs(a), _outputs(b)))


def _worst_rel(want, got):
    return max(float(np.abs(np.asarray(x, np.float64) - y).max()
                     / max(np.abs(np.asarray(x)).max(), 1e-12))
               for x, y in zip(want, _outputs(got)))


@pytest.fixture(scope="module")
def ref():
    """The reference's numpy ``execute_batch`` on the same config, fleet
    and seed, in both dispatches."""
    rt = CleaveRuntime(arch=jget_config("opt-13b").reduced(
        n_layers=2, vocab_size=256), fleet=JFleet.sample(8, seed=0))
    return {d: rt.execute_batch(2, 16, backend="numpy", seed=7, dispatch=d)
            for d in ("level", "dataflow")}


@pytest.mark.parametrize("dispatch", ["level", "dataflow"])
def test_numpy_backend_bit_equal_to_reference(ref, dispatch):
    want = ref[dispatch]
    got = _rt().execute_batch(2, 16, backend="numpy", seed=7,
                              dispatch=dispatch)
    assert isinstance(got, BatchExecuteReport)
    assert (got.n_levels, got.n_tasks, got.n_recovered, got.verified) == \
        (want.n_levels, want.n_tasks, want.n_recovered, want.verified)
    assert [len(l.steps) for l in got.levels] == \
        [len(l.steps) for l in want.levels]
    assert got.predicted_gemm_time == want.predicted_gemm_time
    assert got.predicted_overlap_time == want.predicted_overlap_time
    for a, b in zip(want.steps, got.steps):
        assert dataclasses.astuple(a.gemm) == dataclasses.astuple(b.gemm)
        assert a.n_tasks == b.n_tasks
        np.testing.assert_array_equal(a.output, b.output)


def test_torch_backend_matches_reference(ref):
    """On the reference's operands (its default numpy draws)."""
    got = _rt().execute_batch(2, 16, backend="torch", seed=7,
                              dispatch="dataflow", inputs=host_operands(7))
    assert got.verified and got.dispatch == "dataflow"
    assert got.n_tasks == ref["dataflow"].n_tasks
    assert all(s.kernel == "torch" for s in got.steps)
    assert _worst_rel([s.output for s in ref["dataflow"].steps], got) \
        <= 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataflow_matches_level(backend):
    rt = _rt()
    lv = rt.execute_batch(2, 16, backend=backend, seed=7, dispatch="level")
    df = rt.execute_batch(2, 16, backend=backend, seed=7,
                          dispatch="dataflow")
    assert lv.verified and df.verified
    assert (lv.dispatch, df.dispatch) == ("level", "dataflow")
    assert lv.predicted_overlap_time is None
    assert 0 < df.predicted_overlap_time < df.predicted_gemm_time
    assert df.n_tasks == lv.n_tasks and df.n_redispatched == 0
    assert _bit_equal(lv, df)
    events = [h["event"] for h in rt.history]
    assert events.count("execute_batch") == 2
    assert events.count("execute_level") == lv.n_levels


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataflow_deterministic(backend):
    """Thread timing never reaches the numerics: three dataflow runs with
    one seed are bit-identical."""
    rt = _rt()
    runs = [rt.execute_batch(2, 16, backend=backend, seed=3,
                             dispatch="dataflow") for _ in range(3)]
    assert all(_bit_equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataflow_midflight_failure_recovers(backend):
    rt = _rt()
    victims = [d.device_id for d in rt.fleet.devices[:2]]
    ok = rt.execute_batch(2, 16, backend=backend, seed=11, dispatch="level")
    df = rt.execute_batch(2, 16, backend=backend, seed=11,
                          dispatch="dataflow", fail_ids=victims)
    assert df.verified and df.n_recovered > 0
    assert _worst_rel([s.output for s in ok.steps], df) \
        <= (1e-12 if backend == "numpy" else 1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataflow_poison_caught_by_overlapped_freivalds(backend):
    """A poisoning device is caught by the deferred check, its blocks
    recomputed and the dependents that ran against them re-dispatched:
    the outputs heal to the clean run's."""
    rt = _rt()
    bad = rt.fleet.devices[0].device_id
    ok = rt.execute_batch(2, 16, backend=backend, seed=11, dispatch="level")
    df = rt.execute_batch(2, 16, backend=backend, seed=11,
                          dispatch="dataflow", corrupt_ids=[bad])
    assert not df.verified
    assert _worst_rel([s.output for s in ok.steps], df) \
        <= (1e-12 if backend == "numpy" else 1e-5)


def test_dataflow_prefetch_warms_pad_cache():
    """The torch backend's prefetch stages each next node's padded
    operands into the runtime's ``PadCache``, which the node's launch then
    finds; the level walk stages inside each launch."""
    lv_rt, df_rt = _rt(), _rt()
    lv_rt.execute_batch(2, 16, backend="torch", seed=7, dispatch="level")
    df_rt.execute_batch(2, 16, backend="torch", seed=7, dispatch="dataflow")
    assert lv_rt._pad_cache.hits == 0
    assert df_rt._pad_cache.hits > 0


def test_dataflow_many_workers_stress():
    """More workers than this host's cores, with the interpreter switching
    threads far more often: the shared ``PadCache`` and the deferred
    checks still give the level walk's bits."""
    rt = _rt()
    lv = rt.execute_batch(2, 16, backend="torch", seed=5, dispatch="level")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        df = rt.execute_batch(2, 16, backend="torch", seed=5,
                              dataflow_workers=4 * (os.cpu_count() or 4))
    finally:
        sys.setswitchinterval(old)
    assert df.verified and _bit_equal(lv, df)


@pytest.mark.parametrize("backend", BACKENDS)
def test_execute_level_runs_one_level(backend, rng):
    rt = _rt()
    level = rt._dag(rt.plan(2, 16).request).levels()[0]
    pairs = [(rng.standard_normal((g.m, g.n)).astype(np.float32),
              rng.standard_normal((g.n, g.q)).astype(np.float32))
             for g in level]
    rep = rt.execute_level(pairs, gemms=level, backend=backend)
    assert isinstance(rep, LevelReport)
    assert rep.verified and len(rep.outputs) == len(level)
    assert rep.predicted_makespan > 0 and rep.n_tasks > 0
    for (A, B), out in zip(pairs, rep.outputs):
        want = A.astype(np.float64) @ B
        assert np.abs(np.asarray(out) - want).max() \
            <= 1e-5 * np.abs(want).max()
    assert rt.history[-1]["event"] == "execute_level"
    with pytest.raises(ValueError, match="operand pairs"):
        rt.execute_level(pairs, gemms=level[:1])


def test_execute_batch_rejects_bad_arguments():
    rt = _rt()
    with pytest.raises(ValueError, match="dispatch"):
        rt.execute_batch(2, 16, dispatch="barrier")
    with pytest.raises(ValueError, match="backend"):
        rt.execute_batch(2, 16, backend="jax")
    with pytest.raises(ValueError, match="batch\\+seq"):
        rt.execute_batch(2)


def test_execute_step_deferred_takes_staged_operands(rng):
    """``staged`` (the numpy backend's prefetched f64 copies) gives the
    bits of the unstaged call."""
    rt = _rt()
    A = rng.standard_normal((48, 32)).astype(np.float32)
    B = rng.standard_normal((32, 40)).astype(np.float32)
    s1, f1 = rt.execute_step_deferred(A, B, backend="numpy",
                                      rng=np.random.default_rng(0))
    s2, f2 = rt.execute_step_deferred(
        A, B, backend="numpy", rng=np.random.default_rng(0),
        staged=executor.stage_operands_f64(A, B))
    assert f1() == f2() == []
    np.testing.assert_array_equal(s1.output, s2.output)
    assert s1.verified and s2.verified


def test_entry_points_default_to_the_torch_backend(rng):
    """Named with no backend, every execute entry runs the torch backend on
    the runtime's device (the card unless told otherwise), ``execute_batch``
    walks level by level and draws its operands there, seeded by GEMM
    name; each torch step names the seed of its Freivalds probes."""
    rt = _rt()
    A = rng.standard_normal((48, 32)).astype(np.float32)
    B = rng.standard_normal((32, 40)).astype(np.float32)
    step = rt.execute_step(A, B)
    assert step.backend == "torch" and isinstance(step.output, torch.Tensor)
    assert step.verify_seed is not None
    deferred, fin = rt.execute_step_deferred(A, B)
    assert deferred.backend == "torch" and fin() == []
    rep = rt.execute_batch(2, 16, seed=4, max_levels=2)
    assert (rep.backend, rep.dispatch) == ("torch", "level")
    level = rt._dag(rep.request).levels()[:2]
    draw = device_operands("cpu", 4)
    for g, s in zip([g for lev in level for g in lev], rep.steps):
        a, b = draw(g)
        assert s.output.device == torch.device("cpu")
        assert float((s.output - a.double() @ b.double()).abs().max()) \
            <= 1e-5 * float((a.double() @ b.double()).abs().max())
    lev = rt.execute_level([draw(g) for g in level[0]], gemms=level[0])
    assert lev.backend == "torch"
    assert all(torch.equal(x.output, y.output)
               for x, y in zip(lev.steps, rep.levels[0].steps))


def test_f64_margin_matches_the_executors_residuals(rng):
    """``chip_smoke.f64_freivalds_margin``, which judges the card's
    poisoning walk again on f64 residuals, draws the executor's own probes
    from a step's ``verify_seed``: on the blocks of a step with a
    poisoning device its margin is the device residuals' (within 1e-5 on
    the poisoned blocks, 0.1 of the allowance on the clean ones, where f32
    rounding is the whole residual), and the poisoned blocks fail it."""
    import importlib.util
    from pathlib import Path
    from repro_torch.core.torch_executor import POLICIES
    from repro_torch.kernels import ops
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rt, pol = _rt(), POLICIES["f32"]
    bad = rt.fleet.devices[0].device_id
    for m, n, q in ((48, 32, 40), (130, 70, 33)):
        A = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
        B = torch.from_numpy(rng.standard_normal((n, q)).astype(np.float32))
        st = rt.execute_step(A, B, dtype_policy="f32", corrupt_ids=[bad])
        assert not st.verified
        rects = [(a.r0, a.r1, a.c0, a.c1) for a in st.plan.assignments]
        poisoned = np.array([a.device_id == bad
                             for a in st.plan.assignments], np.float32)
        runs = ops.plan_gemm_buckets(
            A, B, rects, kernel="torch", compute_dtype="float32",
            verify_seed=st.verify_seed, corrupt=poisoned, device="cpu")
        for run in runs:
            for g, i in enumerate(run.idx):
                r0, r1, c0, c1 = rects[i]
                rtol = pol.freivalds_rtol(n, (r1 - r0) * (c1 - c0))
                want = float((np.abs(run.lhs[g] - run.rhs[g])
                              / (rtol * np.abs(run.rhs[g])
                                 + rtol * (run.scale[g] + 1e-30))).max())
                got = smoke.f64_freivalds_margin(A, B, run.block(g),
                                                 rects[i], int(i),
                                                 st.verify_seed, rtol)
                if poisoned[i]:
                    assert got > 1.0
                    assert abs(got - want) <= 1e-5 * want
                else:
                    assert abs(got - want) <= 0.1
