"""The ported examples (``examples_torch/``) on the CPU (``--device cpu``)
against the reference's ``examples/``, each at the reference's own sizes
(``train_e2e`` at one small shape, given to both).  The simulation
examples print the reference's lines exactly, bar the engine's wall-clock
event rate; the others return figures equal to the reference's wherever
those depend on neither the wall clock nor the initial weights (task,
recovery and page counts, plan-cache hits, priced times), and every
torch-backend output lies within 1e-5 of the float64 product, relative to
its largest value, with Freivalds ``verified`` true.  The multi-PS
example is held to the reference's K=2/H=2 run in
``tests/test_torch_multi_ps.py``, which already holds that run as a
module fixture."""
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread for this module: under pytest-xdist's
    workers torch's default pool (a thread a core in every worker) fights
    the other workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name: str, argv=(), monkeypatch=None) -> dict:
    """Runs ``examples/<name>.py`` as a script; returns its globals."""
    path = str(ROOT / "examples" / f"{name}.py")
    if monkeypatch is not None:
        monkeypatch.setattr(sys, "argv", [path, *argv])
    return runpy.run_path(path, run_name="__main__")


def _run_both(name, capsys, ref_name=None, argv=()):
    """The port's ``main`` (``--device cpu``) and the reference script:
    (port figures, port stdout, reference globals, reference stdout)."""
    got = port_example(name).main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    want = run_reference(ref_name or name)
    return got, out, want, capsys.readouterr().out


# ---------------------------------------------- simulation, line by line --

def test_edge_simulation_prints_the_reference_lines(capsys):
    got, out, want, ref_out = _run_both("edge_simulation", capsys)
    assert out.splitlines() == ref_out.splitlines()
    assert len(got["scaling"]) == 5 and len(got["stragglers"]) == 3


def test_fleet_timeline_prints_the_reference_lines(capsys):
    """Equal lines once the engine's event rate (host wall clock) is
    masked; the deterministic replay equals the analytic time."""
    got, out, want, ref_out = _run_both("fleet_timeline", capsys)
    rate = re.compile(r"[\d,]+ ev/s")
    assert rate.sub("<rate>", out).splitlines() == \
        rate.sub("<rate>", ref_out).splitlines()
    assert len(out.splitlines()) == 18
    assert abs(got["deterministic"].makespan - got["analytic"].makespan) \
        <= 1e-6 * got["analytic"].makespan
    assert got["failure"].n_failures == 1 and got["join"].n_joins == 1


# ------------------------------------------------------- execution paths --

def _plan_figures(rep):
    return (rep.batch_time, rep.gemm_time, rep.opt_tail,
            rep.per_device_comm, rep.per_device_mem, rep.cache_misses,
            len(rep.schedule.dag.gemms), rep.schedule.dag.n_levels)


def test_quickstart_matches_reference(capsys):
    got, out, want, _ = _run_both("quickstart", capsys)
    assert _plan_figures(got["report"]) == _plan_figures(want["report"])
    step, wstep = got["step"], want["step"]
    assert (step.n_tasks, step.n_recovered) == (wstep.n_tasks,
                                                wstep.n_recovered)
    assert step.n_recovered > 0 and step.backend == "torch"
    assert (step.recovery.recomputed_fraction,
            step.recovery.recovery_time) == (
        wstep.recovery.recomputed_fraction, wstep.recovery.recovery_time)
    churn, wchurn = got["churn"], want["churn"]
    assert (churn.n_plans_patched, churn.n_plans_carried,
            churn.n_survivors, churn.failed_ids) == (
        wchurn.n_plans_patched, wchurn.n_plans_carried,
        wchurn.n_survivors, wchurn.failed_ids)
    assert got["step2"].plan_cached and want["step2"].plan_cached
    assert got["step2"].n_tasks == want["step2"].n_tasks
    assert step.verified and got["step2"].verified
    assert got["err"] <= REL_TOL and got["err2"] <= REL_TOL
    assert f"killing device {want['victim']}" in out


def test_churn_recovery_matches_reference(capsys):
    got, out, want, ref_out = _run_both("churn_recovery", capsys)
    assert (got["plan"].makespan, len(got["plan"].assignments)) == \
        (want["plan"].makespan, len(want["plan"].assignments))
    rec, wrec = got["recoveries"][16], want["rec"]
    assert (rec.recovery_time, rec.recomputed_fraction) == \
        (wrec.recovery_time, wrec.recomputed_fraction)
    for key in ("step", "step2"):
        assert (got[key].n_tasks, got[key].n_recovered) == \
            (want[key].n_tasks, want[key].n_recovered)
        assert got[key].verified
    assert got["step"].n_recovered > 0 and got["step2"].plan_cached
    assert (got["eviction"].n_plans_patched,
            got["eviction"].n_plans_carried) == (
        want["report"].n_plans_patched, want["report"].n_plans_carried)
    fig7, wfig7 = got["fig7"], want["out"]
    assert fig7["cleave"] - fig7["cleave_solve"] == \
        wfig7["cleave"] - wfig7["cleave_solve"]
    for k in set(wfig7) - {"cleave", "cleave_solve"}:
        assert fig7[k] == wfig7[k], k
    assert got["err"] <= REL_TOL and got["err2"] <= REL_TOL
    # the recovery sweep's lines but their wall-clock re-solve times
    solve = re.compile(r"re-solve +[\d.]+ms")
    sweep = [solve.sub("<t>", ln) for ln in out.splitlines()
             if "failures ->" in ln]
    assert sweep == [solve.sub("<t>", ln) for ln in ref_out.splitlines()
                     if "failures ->" in ln]


def test_torch_executor_level_matches_reference(capsys):
    """The counterpart of ``jax_executor_level.py``: the same tasks,
    priced makespans, recoveries and walk; the torch backend within 1e-5
    of the numpy backend's and of the f64 product."""
    got, out, want, _ = _run_both("torch_executor_level", capsys,
                                  ref_name="jax_executor_level")
    lev, wlev = got["level"], want["lev"]
    assert [s.n_tasks for s in lev.steps] == [s.n_tasks for s in wlev.steps]
    assert lev.predicted_makespan == wlev.predicted_makespan
    assert lev.verified and lev.backend == "torch"
    assert got["parity"] <= REL_TOL and got["err"] <= REL_TOL
    assert got["step"].n_recovered == want["step"].n_recovered > 0
    assert got["step"].verified
    b, wb = got["batch"], want["batch"]
    assert (b.n_levels, b.n_tasks, b.predicted_gemm_time, b.verified) == \
        (wb.n_levels, wb.n_tasks, wb.predicted_gemm_time, True)
    assert out.splitlines()[0] == f"level 0: {[g.name for g in want['level']]}"


def _monolithic_greedy(sess, prompt, n_new):
    """Greedy tokens of the port's monolithic ``decode_step``, fed the
    prompt one token at a time, on the session's weights."""
    from repro_torch.models import model as M
    cfg = sess.cfg
    cache = M.init_cache(cfg, 1, sess.cache_len, device=torch.device("cpu"))
    for t in prompt:
        lg, cache = M.decode_step(cfg, sess.params, cache,
                                  torch.tensor([[int(t)]]))
    toks = []
    for _ in range(n_new):
        toks.append(int(torch.argmax(lg[0, 0, :cfg.vocab_size])))
        lg, cache = M.decode_step(cfg, sess.params, cache,
                                  torch.tensor([[toks[-1]]]))
    return toks


def test_serve_decode_matches_reference(capsys):
    """Six requests drain with the reference's step, token, page and
    recovery counts and its priced clock; only the tokens (the weights)
    and the measured rates differ.  Under the f32 policy each request's
    tokens equal the port's token-by-token monolithic decoding."""
    got, out, want, _ = _run_both("serve_decode", capsys,
                                  argv=["--dtype-policy", "f32"])
    rep, wrep = got["report"], want["report"]
    for f in ("n_requests", "n_tokens", "n_steps", "virtual_time",
              "tokens_per_sec_priced", "token_lat_p50_priced",
              "token_lat_p99_priced", "e2e_p50_priced", "e2e_p99_priced",
              "plan_cache_hit_rate", "n_recovered", "failed_ids"):
        assert getattr(rep, f) == getattr(wrep, f), f
    assert rep.n_requests == 6 and rep.n_recovered > 0
    assert (rep.cache.n_used, rep.cache.n_pages, rep.cache.peak_pages_used) \
        == (wrep.cache.n_used, wrep.cache.n_pages,
            wrep.cache.peak_pages_used)
    wsess = want["sess"]
    assert [(s.n_active, s.n_gemms, s.n_tasks, s.n_recovered, s.verified)
            for s in got["steps"]] == [
        (s.n_active, s.n_gemms, s.n_tasks, s.n_recovered, s.verified)
        for s in wsess.step_reports]
    assert [(r.rid, r.arrival, r.finish_time, len(r.tokens))
            for r in got["finished"]] == [
        (r.rid, r.arrival, r.finish_time, len(r.tokens))
        for r in wsess.batcher.finished]
    assert all(s.verified for s in got["steps"])
    assert {r.rid: list(r.tokens) for r in got["finished"]} == {
        r.rid: _monolithic_greedy(got["session"], r.prompt, r.max_new)
        for r in got["finished"]}


# train_e2e's smallest shape, given to both packages
E2E = ["--steps", "2", "--layers", "1", "--d-model", "64", "--vocab", "256",
       "--batch", "2", "--seq", "16"]
FLEET = ["--backend", "fleet", "--fleet-devices", "8", "--fail-step", "1"]


def test_train_e2e_matches_reference(capsys, monkeypatch):
    """The fleet run's per-step fleet line (GEMMs, tasks, priced
    makespan, plan-cache hits, the failure and its recovery) equals the
    reference's but for its wall clocks, and so does the learning rate;
    the monolithic run trains too."""
    mono = port_example("train_e2e").main([*E2E, "--device", "cpu"])
    assert len(mono["history"]) == 2
    assert all(np.isfinite(r["loss"]) for r in mono["history"])
    got = port_example("train_e2e").main([*E2E, *FLEET, "--device", "cpu"])
    out = capsys.readouterr().out
    with pytest.raises(SystemExit) as done:
        run_reference("train_e2e", [*E2E, *FLEET], monkeypatch)
    assert done.value.code == 0
    ref_out = capsys.readouterr().out
    walls = re.compile(r"exec [\d.]+s/[\d.]+s")

    def fleet_lines(text):
        return [walls.sub("<exec>", ln.strip()) for ln in text.splitlines()
                if ln.strip().startswith("fleet:")]
    assert fleet_lines(out) == fleet_lines(ref_out)
    assert len(fleet_lines(out)) == 2
    hist = got["history"]
    lrs = re.findall(r"lr ([\d.e+-]+) ", ref_out)
    assert [f"{r['lr']:.2e}" for r in hist] == lrs
    assert all(r["fleet_verified"] for r in hist)
    assert hist[1]["fleet_recovered"] > 0
    assert hist[1]["fleet_cache_hit_rate"] == 1.0   # warm after the churn
