"""The port's fleet executor against the reference's: the same numbers as
``execute_plan_jax(kernel="xla")`` and the numpy ``execute_plan`` to
<=1e-5 relative under the f32 policy, and the same task counts, recovery
and verification verdicts under failure and corruption."""
import numpy as np
import pytest
import torch

from repro.api import CleaveRuntime, Fleet
from repro.core import cost_model as jcm, executor as jexec, jax_executor
from repro.kernels import ops as jops
from repro.core.scheduler import solve_level_gemm as jsolve
from repro_torch.api import Fleet as TFleet, TorchCleaveRuntime
from repro_torch.core import cost_model as cm, torch_executor
from repro_torch.core.scheduler import solve_level_gemm
from repro_torch.kernels import ops

RTOL = 1e-5


def _ab(rng, m, n, q):
    return (rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal((n, q)).astype(np.float32))


def _assert_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=rtol, atol=rtol * scale)


def test_plan_gemm_rect_execution(rng):
    """Uneven, unaligned rectangles (a sliver and a degenerate one
    included) crop back exactly, as in the reference."""
    A, B = _ab(rng, 200, 300, 170)
    rects = [(0, 70, 0, 170), (70, 200, 0, 40), (70, 200, 40, 41),
             (70, 200, 41, 170), (5, 5, 0, 10)]
    blocks = ops.plan_gemm(A, B, rects, device="cpu")
    ref = jops.plan_gemm(A, B, rects, kernel="xla")
    exact = A.astype(np.float64) @ B
    for (r0, r1, c0, c1), blk, rb in zip(rects, blocks, ref):
        assert tuple(blk.shape) == (max(r1 - r0, 0), max(c1 - c0, 0))
        if blk.numel():
            _assert_close(blk, exact[r0:r1, c0:c1])
            _assert_close(blk, np.asarray(rb, np.float64))


def test_plan_gemm_buckets_residuals_flag_only_poison(rng):
    """The device-side residual triples pass clean rectangles and flag the
    poisoned one (f32 policy tolerance)."""
    A, B = _ab(rng, 96, 160, 130)
    rects = [(0, 48, 0, 64), (0, 48, 64, 130), (48, 96, 0, 130)]
    corrupt = np.asarray([0, 1, 0], np.float32)
    runs = ops.plan_gemm_buckets(A, B, rects, verify_seed=7,
                                 corrupt=corrupt, compute_dtype="float32",
                                 device="cpu")
    flagged = set()
    for run in runs:
        hs = run.band_hs[run.bidx].astype(np.int64)
        ws = (run.c1s - run.c0s).astype(np.int64)
        rtol = 16 * 1.2e-7 * np.sqrt(160 / (hs * ws))
        ok = np.all(np.abs(run.lhs - run.rhs) <= rtol[:, None]
                    * np.abs(run.rhs) + (rtol * run.scale)[:, None], axis=1)
        flagged |= {int(run.idx[g]) for g in np.nonzero(~ok)[0]}
    assert flagged == {1}


def test_rademacher_draws_independent_of_bucketing():
    a = ops.rademacher(11, [3, 5, 9], 2, 64, 0, "cpu")
    b = ops.rademacher(11, [5], 2, 64, 0, "cpu")
    torch.testing.assert_close(a[1], b[0])
    assert not torch.equal(a[0], a[1])
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(ops.rademacher(1, range(64), 2, 512, 1,
                                    "cpu").mean())) < 0.02


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pad_cache_hit_miss_and_inplace_mutation(kind, rng):
    """Same source: hit.  Other source: miss.  In-place update of the same
    source: miss (never a stale padded copy)."""
    A = rng.standard_normal((30, 50)).astype(np.float32)
    A2 = rng.standard_normal((30, 50)).astype(np.float32)
    if kind == "tensor":
        A, A2 = torch.from_numpy(A), torch.from_numpy(A2)
    cache = ops.PadCache()

    def stage(x):
        return ops._staged_pad(x, 64, 64, "a", cache, torch.float32,
                               torch.device("cpu"))

    p1 = stage(A)
    assert stage(A) is p1 and (cache.hits, cache.misses) == (1, 1)
    stage(A2)
    assert cache.misses == 2
    A *= 0.5                                         # same object, in place
    p3 = stage(A)
    assert cache.misses == 3 and p3 is not p1
    np.testing.assert_array_equal(np.asarray(p3[:30, :50]), np.asarray(A))
    assert not p3[30:].any() and not p3[:, 50:].any()


def test_staged_pad_uses_aligned_tensor_in_place():
    w = torch.randn(128, 256)
    assert ops._staged_pad(w, 128, 256, "b", None, torch.float32,
                           torch.device("cpu")) is w


def test_stage_plan_operands_warms_the_launch_keys(rng):
    """Operands staged ahead of a launch are exactly the ones the launch
    looks up: the launch hits the cache for both."""
    A, B = _ab(rng, 70, 90, 100)
    rects = [(0, 70, 0, 50), (0, 70, 50, 100)]
    cache = ops.PadCache()
    ops.stage_plan_operands(A, B, rects, pad_cache=cache, device="cpu")
    assert (cache.hits, cache.misses) == (0, 2)
    ops.plan_gemm(A, B, rects, pad_cache=cache, compute_dtype="float32",
                  device="cpu")
    assert (cache.hits, cache.misses) == (2, 2)


def test_numpy_operands_default_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.plan_gemm(*_ab(rng, 8, 8, 8), [(0, 8, 0, 8)])


def test_resolve_plan_kernel():
    assert ops.resolve_plan_kernel("auto", "cpu") == "torch"
    assert ops.resolve_plan_kernel("auto", "cuda") == "cuda"
    with pytest.raises(ValueError):
        ops.resolve_plan_kernel("torch", "cuda")    # no plain GEMM on a card
    with pytest.raises(ValueError):
        ops.resolve_plan_kernel("cuda", "cpu")
    for name in ("xla", "pallas", "triton", "cublas"):
        with pytest.raises(ValueError):
            ops.resolve_plan_kernel(name, "cuda")


SCENARIOS = {"clean": ((), ()), "fail": ((1,), ()), "corrupt": ((), (2,)),
             "fail+corrupt": ((1, 4), (2,))}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_execute_plan_torch_matches_jax_and_numpy(scenario, rng):
    fail_ids, corrupt_ids = SCENARIOS[scenario]
    devs = TFleet.sample(8, seed=0).devices
    jdevs = Fleet.sample(8, seed=0).devices
    g = cm.GEMM(m=130, n=200, q=150)
    jg = jcm.GEMM(m=130, n=200, q=150)
    plan = solve_level_gemm(g, devs)
    jplan = jsolve(jg, jdevs)
    assert [tuple(vars(a).values()) for a in plan.assignments] == \
        [tuple(vars(a).values()) for a in jplan.assignments]
    A, B = _ab(rng, g.m, g.n, g.q)
    kw = dict(fail_ids=fail_ids, corrupt_ids=corrupt_ids, rng=0)
    rep_t = torch_executor.execute_plan_torch(g, plan, A, B, devs,
                                              policy="f32", device="cpu",
                                              **kw)
    rep_j = jax_executor.execute_plan_jax(jg, jplan, A, B, jdevs,
                                          kernel="xla", policy="f32", **kw)
    rep_n = jexec.execute_plan(jg, jplan, A, B, jdevs, **kw)
    for rep in (rep_j, rep_n):
        assert (rep_t.n_tasks, rep_t.n_recovered, rep_t.verified) == \
            (rep.n_tasks, rep.n_recovered, rep.verified)
    assert rep_t.verified == (not corrupt_ids)
    assert rep_t.n_recovered > 0 if fail_ids else rep_t.n_recovered == 0
    _assert_close(rep_t.output, np.asarray(rep_j.output, np.float64))
    _assert_close(rep_t.output, rep_n.output)


def test_runtime_execute_step_keeps_session_rng_aligned(rng):
    """A verified torch step draws the session RNG exactly as the jax step
    does, so a fixed-seed session stays in step with the reference."""
    A, B = _ab(rng, 128, 192, 160)
    rt_j = CleaveRuntime(arch="opt-13b", fleet=Fleet.sample(8, seed=0))
    rt_t = TorchCleaveRuntime(arch="opt-13b", fleet=TFleet.sample(8, seed=0),
                              device="cpu")
    for kw in (dict(), dict(fail_ids=[3]), dict(corrupt_ids=[5])):
        sj = rt_j.execute_step(A, B, backend="jax", kernel="xla",
                               dtype_policy="f32", **kw)
        st = rt_t.execute_step(A, B, backend="torch", dtype_policy="f32",
                               **kw)
        assert (st.n_tasks, st.n_recovered, st.verified) == \
            (sj.n_tasks, sj.n_recovered, sj.verified)
        assert st.kernel == "torch" and isinstance(st.output, torch.Tensor)
        _assert_close(st.output, np.asarray(sj.output, np.float64))
    assert rt_t.rng.integers(2 ** 31) == rt_j.rng.integers(2 ** 31)
    rep_t = rt_t.on_failure([3])
    rep_j = rt_j.on_failure([3])
    assert (rep_t.n_plans_patched, rep_t.n_survivors) == \
        (rep_j.n_plans_patched, rep_j.n_survivors)
    st = rt_t.execute_step(A, B, backend="torch")
    assert st.plan_cached and st.verified
    assert rt_t._pad_cache.hits > 0
    joiner = rt_j.fleet.devices[0]
    assert len(rt_t.on_join(joiner)) == len(rt_j.on_join(joiner)) == 8


def test_runtime_deferred_matches_inline(rng):
    A, B = _ab(rng, 64, 96, 80)
    rt = TorchCleaveRuntime(arch="opt-13b", fleet=TFleet.sample(8, seed=0),
                            device="cpu")
    step, fin = rt.execute_step_deferred(A, B, backend="torch",
                                         corrupt_ids=[2], rng=5)
    corrected = fin()
    assert corrected and not step.verified
    _assert_close(step.output, A.astype(np.float64) @ B)


def test_runtime_rejects_unknown_backend(rng):
    rt = TorchCleaveRuntime(arch="opt-13b", fleet=TFleet.sample(4, seed=0),
                            device="cpu")
    with pytest.raises(ValueError):
        rt.execute_step(*_ab(rng, 8, 8, 8), backend="jax")


@pytest.mark.parametrize("rects,ok", [
    ([(0, 2, 0, 3), (2, 4, 0, 1), (2, 4, 1, 3)], True),
    ([(0, 4, 0, 3), (1, 1, 0, 3)], True),          # a degenerate rect
    ([(0, 2, 0, 3), (1, 4, 0, 3)], False),         # overlap
    ([(0, 2, 0, 3), (2, 4, 0, 2)], False),         # a hole
    ([(0, 2, 0, 3), (2, 5, 0, 3)], False),         # outside the output
])
def test_partition_check_matches_dense_mask(rects, ok):
    """The executor's coverage check over rectangles gives the verdict a
    dense mask of the written cells gives."""
    mask = np.zeros((5, 3), int)
    for r0, r1, c0, c1 in rects:
        mask[r0:r1, c0:c1] += 1
    assert ok == bool((mask[:4] == 1).all() and not mask[4:].any())
    if ok:
        torch_executor._check_partition(rects, 4, 3)
    else:
        with pytest.raises(AssertionError):
            torch_executor._check_partition(rects, 4, 3)


def test_executor_catches_an_unwritten_rect(rng, monkeypatch):
    """A rectangle lost between the plan and the output writes (here
    dropped from its bucket run) leaves cells of C unwritten: the executor
    raises rather than return zeros as a verified product."""
    devs = TFleet.sample(8, seed=0).devices
    g = cm.GEMM(m=130, n=200, q=150)
    plan = solve_level_gemm(g, devs)
    A, B = _ab(rng, g.m, g.n, g.q)
    real = ops.plan_gemm_buckets

    def drop_last_rect(*args, **kw):
        runs = real(*args, **kw)
        run = runs[0]
        for name in ("idx", "bidx", "c0s", "c1s", "lhs", "rhs", "scale"):
            setattr(run, name, getattr(run, name)[:-1])
        return runs

    rep = torch_executor.execute_plan_torch(g, plan, A, B, devs, rng=0,
                                            policy="f32", device="cpu")
    assert rep.verified
    monkeypatch.setattr(ops, "plan_gemm_buckets", drop_last_rect)
    with pytest.raises(AssertionError, match="coverage violated"):
        torch_executor.execute_plan_torch(g, plan, A, B, devs, rng=0,
                                          policy="f32", device="cpu")
