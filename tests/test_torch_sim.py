"""The port's simulation slice against the reference: ``simulate`` on the
analytic, event and event-array backends (events, jitter, PS contention),
``stream_profile``, the errors both raise, and the paper's experiment
drivers of ``sim/simulator.py`` (Fig 3/Table 8, scaling, stragglers, Fig 7
recovery, the Table 9 ablation, the App. C.5 bandit, Fig 5 memory), each
package on its own fleet drawn from the same seed.  The pricing code is a
copy, so every figure that is not a wall clock equals the reference's
exactly; within the port, event-array is held to the event backend at
1e-9 and analytic to event at 1e-6 (the reference's own bars)."""
import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import CleaveRuntime
from repro.core import cost_model as jcm
from repro.sim import simulator as JS
import repro_torch.api as tapi
from repro_torch.api import TorchCleaveRuntime
from repro_torch.core import cost_model as cm
from repro_torch.sim import simulator as S

ARCH, BATCH, SEQ, N_DEV = "opt-13b", 4, 64, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread for this module: under pytest-xdist's
    workers torch's default pool (a thread a core in every worker) fights
    the other workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runtimes(**kw):
    """A reference runtime and a port runtime (on the CPU) over the same
    ``Fleet.sample`` draw, each with its own package's types."""
    ps = kw.pop("net_bw", None)
    jrt = CleaveRuntime(arch=ARCH, fleet=japi.Fleet.sample(N_DEV, seed=0),
                        ps=None if ps is None else jcm.PSConfig(net_bw=ps),
                        **kw)
    rt = TorchCleaveRuntime(arch=ARCH, fleet=tapi.Fleet.sample(N_DEV,
                                                                seed=0),
                            ps=None if ps is None else cm.PSConfig(net_bw=ps),
                            device="cpu", **kw)
    return jrt, rt


def _events(api, det, kinds):
    """The scenario's events built with ``api``'s own constructors, timed
    on the deterministic replay ``det``: its busiest device fails."""
    makespan = det.makespan
    busy = sorted(det.device_busy, key=det.device_busy.get)
    joiner = api.Fleet.sample(N_DEV + 1, seed=3).devices[-1]
    joiner = dataclasses.replace(joiner, device_id=10_000)
    evs = []
    if "fail" in kinds:
        evs.append(api.fail(makespan * 0.3, busy[-1]))
    if "slowdown" in kinds:
        evs += [api.slowdown(makespan * 0.1, busy[-2], 4.0),
                api.slowdown(makespan * 0.6, busy[-2], 0.25)]
    if "join" in kinds:
        evs.append(api.join(makespan * 0.05, joiner))
    return evs


def _fields(report) -> dict:
    """Every field of a ``TimelineReport`` but the wall clock."""
    d = dataclasses.asdict(report)
    del d["wall_time"]
    return d


SCENARIOS = {
    "plain": dict(kinds=()),
    "fail": dict(kinds=("fail",)),
    "fail_join_slowdown": dict(kinds=("fail", "join", "slowdown")),
    "jitter": dict(kinds=("fail",), jitter_alpha=2.0, seed=5),
    "contention": dict(kinds=("slowdown",), ps_contention=True,
                       net_bw=2e8),
}


@pytest.mark.parametrize("backend", ["event", "event-array"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_simulate_matches_reference(scenario, backend):
    """Every field of the port's report but ``wall_time`` equals the
    reference's, and so does the ``history`` entry; ``trace`` too."""
    sc = dict(SCENARIOS[scenario])
    kinds = sc.pop("kinds")
    jrt, rt = _runtimes(**({"net_bw": sc.pop("net_bw")}
                           if "net_bw" in sc else {}))
    det = rt.simulate(BATCH, SEQ, backend="event")
    jdet = jrt.simulate(BATCH, SEQ, backend="event")
    assert _fields(det) == _fields(jdet)
    got = rt.simulate(BATCH, SEQ, backend=backend, trace=True,
                      events=_events(tapi, det, kinds), **sc)
    want = jrt.simulate(BATCH, SEQ, backend=backend, trace=True,
                        events=_events(japi, jdet, kinds), **sc)
    assert _fields(got) == _fields(want)
    assert got.n_failures == ("fail" in kinds)
    assert rt.history[-1] == jrt.history[-1]


def test_analytic_matches_reference_and_event_replay():
    """The analytic report equals the reference's; the event replay with
    no events, jitter or contention reproduces it within 1e-6 relative
    (makespan and each level time)."""
    jrt, rt = _runtimes()
    ana = rt.simulate(BATCH, SEQ, backend="analytic")
    assert _fields(ana) == _fields(jrt.simulate(BATCH, SEQ,
                                                backend="analytic"))
    for backend in ("event", "event-array"):
        ev = rt.simulate(BATCH, SEQ, backend=backend)
        assert math.isclose(ev.makespan, ana.makespan, rel_tol=1e-6)
        assert len(ev.level_times) == len(ana.level_times)
        np.testing.assert_allclose(ev.level_times, ana.level_times,
                                   rtol=1e-6)


@pytest.mark.parametrize("kinds", [("fail",), ("fail", "join", "slowdown")])
def test_event_array_within_1e9_of_event(kinds):
    """On the port, the array engine prices an eventful scenario within
    1e-9 of the scalar engine: makespan, level times, recovery latency,
    recomputed share and each device's busy time."""
    _, rt = _runtimes()
    evs = _events(tapi, rt.simulate(BATCH, SEQ), kinds)
    sca = rt.simulate(BATCH, SEQ, backend="event", events=evs)
    arr = rt.simulate(BATCH, SEQ, backend="event-array", events=evs)
    for a, b in [(sca.makespan, arr.makespan),
                 (sca.recovery_latency, arr.recovery_latency),
                 (sca.recomputed_fraction, arr.recomputed_fraction)]:
        assert math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12)
    np.testing.assert_allclose(arr.level_times, sca.level_times, rtol=1e-9)
    assert sca.device_busy.keys() == arr.device_busy.keys()
    np.testing.assert_allclose(
        [arr.device_busy[k] for k in sca.device_busy],
        list(sca.device_busy.values()), rtol=1e-9)
    assert (arr.n_failures, arr.n_joins, arr.n_slowdowns) == (
        1, int("join" in kinds), 2 * ("slowdown" in kinds))
    if kinds == ("fail",):          # the busiest device fails mid-work
        assert sca.recovery_latency > 0 and arr.recomputed_fraction > 0


def test_simulate_leaves_the_session_fleet_alone():
    """A ``fail`` event prices a what-if: the session fleet keeps the
    device, its signature and its size."""
    _, rt = _runtimes()
    sig, n = rt.fleet.signature(), len(rt.fleet)
    victim = rt.fleet.devices[3].device_id
    rep = rt.simulate(BATCH, SEQ, events=[tapi.fail(0.5, victim)])
    assert rep.n_failures == 1
    assert rt.fleet.signature() == sig and len(rt.fleet) == n


@pytest.mark.parametrize("call", [
    "unknown_backend", "analytic_events", "analytic_jitter",
    "analytic_contention", "unknown_device", "unknown_slowdown_device",
    "no_shape", "stream_alpha"])
def test_errors_match_reference(call):
    """The reference's errors, raised the same way with the same text."""
    def run(api, rt):
        fn = {
            "unknown_backend": lambda: rt.simulate(2, 64, backend="bogus"),
            "analytic_events": lambda: rt.simulate(
                2, 64, backend="analytic", events=[api.fail(1.0, 0)]),
            "analytic_jitter": lambda: rt.simulate(
                2, 64, backend="analytic", jitter_alpha=2.0),
            "analytic_contention": lambda: rt.simulate(
                2, 64, backend="analytic", ps_contention=True),
            "unknown_device": lambda: rt.simulate(
                2, 64, events=[api.fail(1.0, 99_999)]),
            "unknown_slowdown_device": lambda: rt.simulate(
                2, 64, backend="event-array",
                events=[api.slowdown(1.0, 99_999, 2.0)]),
            "no_shape": lambda: rt.simulate(2),
            "stream_alpha": lambda: rt.stream_profile(
                cm.GEMM(m=64, n=64, q=64), pareto_alpha=0.5),
        }[call]
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)
    jrt, rt = _runtimes()
    assert run(tapi, rt) == run(japi, jrt)


@pytest.mark.parametrize("mitigation", ["none", "speculative", "coded"])
@pytest.mark.parametrize("pareto_alpha", [0.0, 2.0])
@pytest.mark.parametrize("edge", ["median", "fastest"])
def test_stream_profile_matches_reference(mitigation, pareto_alpha, edge):
    """Fresh runtimes of one seed: the report (jittered trials drawn from
    the session's ``rng``) and the history entry equal the reference's;
    ``device`` is an edge device, not the runtime's torch device."""
    jrt, rt = _runtimes(mitigation=mitigation)
    g = cm.GEMM(m=1024, n=4096, q=14336)
    jg = jcm.GEMM(m=1024, n=4096, q=14336)
    kw = dict(pareto_alpha=pareto_alpha, k=32, n_trials=8)
    if edge == "fastest":
        got = rt.stream_profile(g, device=max(rt.fleet.devices,
                                              key=lambda d: d.flops), **kw)
        want = jrt.stream_profile(jg, device=max(jrt.fleet.devices,
                                                 key=lambda d: d.flops), **kw)
    else:
        got, want = rt.stream_profile(g, **kw), jrt.stream_profile(jg, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.overlap_speedup == want.overlap_speedup > 1.0
    assert rt.history[-1] == jrt.history[-1]
    assert rt.device == torch.device("cpu")
    if pareto_alpha:
        # the trials drew from the session rng: a second call differs
        assert rt.stream_profile(g, **kw).jittered_time != got.jittered_time


def test_api_exports_what_the_reference_exports():
    """``repro_torch.api`` exports every name of ``repro.api``, with the
    port's runtime in place of ``CleaveRuntime``."""
    want = (set(japi.__all__) - {"CleaveRuntime"}) | {"TorchCleaveRuntime"}
    assert set(tapi.__all__) == want
    assert all(hasattr(tapi, n) for n in tapi.__all__)


# ----------------------------------------------------------- experiments --

def _same(got, want):
    """Equal, with NaN equal to NaN (DTFM's solver OOM), through nested
    dicts and lists."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want


EXPERIMENTS = {
    "compare_unicast": ("compare_systems", ("llama2-13b", 32, 256, 64), {}),
    "compare_broadcast": ("compare_systems", ("llama2-13b", 32, 256, 64),
                          {"accounting": "broadcast"}),
    "scaling_devices": ("scaling_devices", (),
                        dict(arch="opt-1.3b", batch=16, seq=128,
                             counts=(16, 32))),
    "scaling_model": ("scaling_model", (),
                      dict(pairs=(("opt-1.3b", 16), ("llama2-13b", 32)),
                           batch=16, seq=128)),
    "scaling_batch": ("scaling_batch", (),
                      dict(arch="opt-1.3b", seq=128, batches=(16, 32))),
    "straggler": ("straggler_experiment", (),
                  dict(batch=16, seq=128, n_devices=16,
                       fractions=(0.0, 0.1, 0.2))),
    "ablation": ("ablation", (), dict(batch=16, seq=128, n_devices=64)),
    "adaptive": ("adaptive_experiment", (),
                 dict(batch=8, seq=64, n_devices=16, n_rounds=4)),
    "memory": ("memory_experiment", (),
               dict(archs=("opt-1.3b", "llama2-13b"), batch=16, seq=128,
                    n_candidates=64)),
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_experiment_matches_reference(name):
    fn, args, kw = EXPERIMENTS[name]
    _same(getattr(S, fn)(*args, **kw), getattr(JS, fn)(*args, **kw))


def test_churn_experiment_matches_reference():
    """Fig 7: every key equal but the wall-clock solve time that
    ``"cleave"`` includes; ``cleave - cleave_solve`` equal."""
    got = S.churn_experiment(batch=16, seq=128, n_devices=32)
    want = JS.churn_experiment(batch=16, seq=128, n_devices=32)
    assert got.keys() == want.keys()
    assert got["cleave"] - got["cleave_solve"] == \
        want["cleave"] - want["cleave_solve"]
    for k in set(want) - {"cleave", "cleave_solve"}:
        assert got[k] == want[k], k


def test_lazy_imports_resolve_to_the_port(monkeypatch):
    """``adaptive_experiment`` reaches the port's bandit and its
    ``_evaluate_on`` the port's engine (both imported inside the
    functions, which the module-level import scan cannot see)."""
    from repro_torch.core import bandit
    from repro_torch.sim import engine
    calls = {"bandit": 0, "price_plan": 0}
    ts, price = bandit.ThompsonScheduler, engine.price_plan

    def counted_ts(*a, **k):
        calls["bandit"] += 1
        return ts(*a, **k)

    def counted_price(*a, **k):
        calls["price_plan"] += 1
        return price(*a, **k)
    monkeypatch.setattr(bandit, "ThompsonScheduler", counted_ts)
    monkeypatch.setattr(engine, "price_plan", counted_price)
    S.adaptive_experiment(batch=8, seq=64, n_devices=16, n_rounds=2)
    assert calls["bandit"] == 1 and calls["price_plan"] > 0


def test_cleave_batch_time_shim_names_the_port():
    cfg = S.get_config("opt-1.3b")
    devs = S.fleet_mod.median_fleet(16)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = S.cleave_batch_time(cfg, 16, 128, devs)
    assert any(issubclass(x.category, DeprecationWarning) and
               "repro_torch.api.TorchCleaveRuntime" in str(x.message)
               for x in w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = JS.cleave_batch_time(JS.get_config("opt-1.3b"), 16, 128,
                                    JS.fleet_mod.median_fleet(16))
    assert (got.batch_time, got.gemm_time, got.opt_tail,
            got.per_device_comm, got.per_device_mem) == \
        (want.batch_time, want.gemm_time, want.opt_tail,
         want.per_device_comm, want.per_device_mem)
