"""The port's fleet-backed serving against the reference's ``ServeSession``:
same prompts, same params (``from_jax_params``), same ``Fleet.sample``
seed.  Greedy tokens must be identical, and so must every step's fleet
task and recovery counts (the planner, churn recovery and Freivalds oracle
are the same code, and the torch executor draws the session RNG as the
reference's executors do)."""
import jax
import numpy as np
import pytest
import torch

from repro.api import CleaveRuntime, Fleet
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.api import Fleet as TFleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.interop import from_jax_params
from repro_torch.serving import PagedKVCache

ARCH = "llama3-8b"


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _prompts(cfg, n, length, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length).astype(np.int32)
            for _ in range(n)]


def _run_both(models, *, n_dev=8, arrivals=None, run_kw=None,
              max_new=3, n_req=3, torch_backend="torch", **kw):
    jcfg, cfg, jparams, params = models
    kw.setdefault("slots", 3)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 16)
    jrt = CleaveRuntime(arch=jcfg, fleet=Fleet.sample(n_dev, seed=0))
    rt = TorchCleaveRuntime(arch=cfg, fleet=TFleet.sample(n_dev, seed=0),
                            device="cpu")
    js = jrt.serve_session(jparams, **kw)
    ts = rt.serve_session(params, backend=torch_backend, **kw)
    prompts = _prompts(cfg, n_req, 5)
    for i, p in enumerate(prompts):
        arr = 0.0 if arrivals is None else arrivals[i]
        js.submit(p, max_new=max_new, arrival=arr)
        ts.submit(p, max_new=max_new, arrival=arr)
    jrep = js.run(**(run_kw or {}))
    trep = ts.run(**(run_kw or {}))
    jt = {r.rid: r.tokens for r in js.batcher.finished}
    tt = {r.rid: r.tokens for r in ts.batcher.finished}
    assert tt == jt and len(tt) == n_req
    counts = [(s.n_active, s.n_gemms, s.n_tasks, s.n_recovered, s.verified)
              for s in ts.step_reports]
    assert counts == [(s.n_active, s.n_gemms, s.n_tasks, s.n_recovered,
                       s.verified) for s in js.step_reports]
    return ts, trep, jrep


@pytest.mark.parametrize("torch_backend", ["torch", "numpy"])
def test_serving_parity_with_mid_decode_failure(models, torch_backend):
    """A device failing in step 1 recovers in flight, is evicted, and the
    tokens stay identical to the reference's (on the port's torch executor
    and on its numpy executor)."""
    ts, trep, jrep = _run_both(
        models, torch_backend=torch_backend,
        run_kw=dict(fail_ids=[2], fail_at_step=1, max_steps=50))
    assert trep.failed_ids == jrep.failed_ids == (2,)
    assert trep.n_recovered == jrep.n_recovered > 0
    assert len(ts.rt.fleet) == 7
    assert all(s.verified for s in ts.step_reports)


def test_serving_parity_staggered_admission(models):
    """More requests than slots with staggered arrivals: retirement frees
    slots and pages mid-run, later admissions decode at their own
    positions."""
    ts, trep, _ = _run_both(models, slots=2, n_dev=6, n_req=4,
                            arrivals=[0.0, 0.1, 0.2, 0.3])
    assert ts.batcher.n_admitted == 4
    assert any(s.n_retired and s.n_admitted for s in ts.step_reports) \
        or trep.n_steps > 4


def test_serving_parity_kv_int8(models):
    ts, _, _ = _run_both(models, kv_int8=True, n_dev=4)
    assert ts.kv.pools["k"].dtype == torch.int8
    assert ts.kv.pools["k_scale"].dtype == torch.float16


def test_serving_parity_dataflow_dispatch(models):
    """Deferred (overlapped) verification prices each step as a GEMM chain
    and keeps tokens and counts identical to the reference's dataflow
    session."""
    ts, trep, jrep = _run_both(models, dispatch="dataflow", n_dev=4,
                               n_req=2, slots=2)
    assert trep.virtual_time == pytest.approx(jrep.virtual_time, rel=1e-9)


def test_paged_read_check_once_per_step(models):
    """``check_paged_read=True`` runs the paged decode wrapper on layer 0's
    pools every step and holds it to dense attention on the gathered
    view."""
    ts, trep, _ = _run_both(models, check_paged_read=True, slots=2,
                            n_dev=4, n_req=2)
    assert ts.paged_read_checks == trep.n_steps > 0


def test_paged_cache_write_gather_roundtrip():
    cfg = get_config(ARCH).reduced()
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kv = PagedKVCache(cfg, n_pages=8, page_size=4, device="cpu")
    g = torch.Generator().manual_seed(0)
    kv.alloc(7, 10)
    pk = torch.randn((L, 6, K, hd), generator=g)
    pv = torch.randn((L, 6, K, hd), generator=g)
    kv.write_prompt(7, {"k": pk, "v": pv})
    tk = torch.randn((L, 1, K, hd), generator=g)
    kv.write_tokens([7], [6], {"k": tk, "v": tk})
    views = kv.gather([None, 7], cache_len=12)
    assert tuple(views["k"].shape) == (L, 2, 12, K, hd)
    torch.testing.assert_close(views["k"][:, 1, :6], pk, rtol=0, atol=0)
    torch.testing.assert_close(views["v"][:, 1, 6], tk[:, 0], rtol=0, atol=0)
    pt, ln = kv.page_table_array([None, 7])
    assert ln.tolist() == [0, 7]
    assert pt[1, :3].tolist() == kv.tables[7].pages


def test_serve_session_draws_params_from_seed():
    """With no params the session draws its own from ``seed`` (as
    ``profile_serve`` and ``chip_smoke.py``'s full cell build it): the
    same seed gives the same params, and a request decodes."""
    cfg = get_config(ARCH).reduced()
    rt = TorchCleaveRuntime(arch=cfg, fleet=TFleet.sample(4, seed=0),
                            device="cpu")
    a = rt.serve_session(slots=2, page_size=4, max_len=8, seed=3)
    b = rt.serve_session(slots=2, page_size=4, max_len=8, seed=3)
    torch.testing.assert_close(a.params["layers"]["attn"]["wq"],
                               b.params["layers"]["attn"]["wq"], rtol=0,
                               atol=0)
    a.submit(np.arange(5, dtype=np.int32), max_new=2)
    a.run()
    assert [len(r.tokens) for r in a.batcher.finished] == [2]
