"""The port's training slice against the reference on ``llama3-8b.reduced()``
(f32), fed the same numpy inputs: ``loss_fn`` and its gradients, AdamW,
the synthetic data, the monolithic step, and the PS-centric fleet step
(both executor backends, ``device="cpu"``) over three steps with a device
failure in the backward.  Tolerances are the reference's own: 1e-4
relative for the training state (``tests/test_train_loop.py``), 1e-5 on
the loss, 1e-6 on one AdamW update."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CleaveRuntime
from repro.api import Fleet as JFleet
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import from_jax_opt_state, from_jax_params
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.train_loop import hook
from repro_torch.train_loop import fleet_gemm

ARCH = "llama3-8b"
B, S = 2, 32
CHUNKS = dict(q_chunk=16, k_chunk=16, loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
REL_TOL = 1e-4
N_STEPS, FAIL_STEP, FAIL_IDS = 3, 1, (3,)
FAIL_AT = 20          # 16 forward GEMMs per step: GEMM 20 is a backward one


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _worst_rel(want, got):
    """The reference's measure: per leaf, max |a - b| over max |a|."""
    return max(float(np.abs(np.asarray(a, np.float32) - b.float().numpy())
                     .max() / (np.abs(np.asarray(a, np.float32)).max()
                               + 1e-12))
               for a, b in zip(jax.tree.leaves(want), T.leaves(got)))


def _batch(data, step):
    return {k: torch.as_tensor(v) for k, v in data.batch(step).items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet run (numpy executor) over ``N_STEPS`` steps,
    with devices ``FAIL_IDS`` failing at GEMM ``FAIL_AT`` of step
    ``FAIL_STEP``; its initial and final states as numpy trees."""
    jcfg = jget_config(ARCH).reduced()
    jopt = jadam.AdamConfig(**OPT)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jadam.init(params, jopt)
    init = (_np_tree(params), _np_tree(opt))
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=0))
    rt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(8, seed=0))
    sess = rt.train_session(jopt, **CHUNKS)
    steps = []
    for step in range(N_STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT)
        steps.append(met["fleet"])
    return {"jcfg": jcfg, "init": init, "steps": steps,
            "final": (_np_tree(params), _np_tree(opt))}


def _port_setup(ref, **session):
    cfg = get_config(ARCH).reduced()
    params = from_jax_params(ref["init"][0], "cpu")
    opt = from_jax_opt_state(ref["init"][1], "cpu")
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    sess = rt.train_session(adam.AdamConfig(**OPT), **CHUNKS, **session)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    return cfg, params, opt, rt, sess, data


# ------------------------------------------------------------- components --

def test_loss_fn_value_and_grads_match_reference(ref):
    """``loss_fn`` and its parameter gradients against ``jax.value_and_grad``
    of the reference's unrolled ``loss_fn``: 1e-5 on the loss, 1e-4
    relative per gradient leaf."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jparams = jax.tree.map(jnp.asarray, ref["init"][0])
    raw = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    raw["labels"][0, :5] = -1                      # masked labels count too
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in raw.items()},
                             scan_layers=False, **CHUNKS),
        has_aux=True)(jparams)
    (loss, met), grads = M.value_and_grad(
        cfg, from_jax_params(ref["init"][0], "cpu"),
        {k: torch.as_tensor(v) for k, v in raw.items()}, **CHUNKS)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - 5
    assert _worst_rel(jgrads, grads) <= REL_TOL
    assert T.paths(grads) == T.paths(from_jax_params(ref["init"][0], "cpu"))


def test_adam_apply_matches_reference(rng):
    """Three AdamW updates on numpy-made trees (clipping active, warmup and
    cosine schedule) against the reference: 1e-6."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(jnp.asarray, params)
    jo = jadam.init(jp, jadam.AdamConfig(**cfg_kw))
    p, o = from_jax_params(params, "cpu"), adam.init(
        from_jax_params(params, "cpu"))
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                             .astype(np.float32), params)
        jp, jo, jm = jadam.apply(jp, jax.tree.map(jnp.asarray, grads), jo,
                                 jadam.AdamConfig(**cfg_kw))
        p, o, m = adam.apply(p, from_jax_params(grads, "cpu"), o,
                             adam.AdamConfig(**cfg_kw))
        for name in ("grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) \
                <= 1e-6 * abs(float(jm[name]))
        for want, got in ((jp, p), (jo.mu, o.mu), (jo.nu, o.nu)):
            assert _worst_rel(want, got) <= 1e-6
    assert int(o.step) == int(jo.step) == 3


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (7, 2)])
def test_synthetic_lm_tokens_identical(seed, step):
    kw = dict(vocab_size=512, seq_len=40, global_batch=3, seed=seed)
    want = JSyntheticLM(JDataConfig(**kw)).batch(step)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_monolithic_step_matches_reference(ref, microbatches):
    """``launch.steps.make_train_step`` against the reference's jitted
    monolithic step, one step from the same state."""
    jcfg = ref["jcfg"]
    jopt = jadam.AdamConfig(**OPT)
    raw = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, microbatches=microbatches,
                                     **CHUNKS))
    jp, jo, jm = jstep(jax.tree.map(jnp.asarray, ref["init"][0]),
                       jax.tree.map(jnp.asarray, ref["init"][1]),
                       {k: jnp.asarray(v) for k, v in raw.items()})
    step = make_train_step(get_config(ARCH).reduced(), adam.AdamConfig(**OPT),
                           microbatches=microbatches, **CHUNKS)
    p, o, m = step(from_jax_params(ref["init"][0], "cpu"),
                   from_jax_opt_state(ref["init"][1], "cpu"),
                   {k: torch.as_tensor(v) for k, v in raw.items()})
    for name in ("loss", "grad_norm"):
        assert abs(float(m[name]) - float(jm[name])) \
            <= REL_TOL * abs(float(jm[name]))
    assert _worst_rel(jp, p) <= REL_TOL
    assert _worst_rel(jo.mu, o.mu) <= REL_TOL


def test_opt_state_interop_round_trip(ref):
    o = from_jax_opt_state(ref["init"][1], "cpu")
    assert isinstance(o, adam.AdamState) and int(o.step) == 0
    assert all(t.dtype == torch.float32 and not t.any()
               for t in T.leaves(o.mu) + T.leaves(o.nu))
    assert T.paths(o.mu) == T.paths(from_jax_params(ref["init"][0], "cpu"))


# ------------------------------------------------------------- fleet step --

@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_fleet_step_matches_reference(ref, backend):
    """Three fleet steps, devices failing mid-backward at step 1: loss,
    grad_norm, params and both moments within 1e-4 of the reference's
    fleet run, the same GEMM, task and recovery counts, every step
    verified, and three GEMMs (fwd, dA, dW) per forward GEMM."""
    _, params, opt, rt, sess, data = _port_setup(ref, backend=backend)
    for step, want in enumerate(ref["steps"]):
        params, opt, met = sess.step(
            params, opt, _batch(data, step),
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT)
        got = met["fleet"]
        assert abs(got.loss - want.loss) <= REL_TOL * abs(want.loss)
        assert abs(got.grad_norm - want.grad_norm) \
            <= REL_TOL * abs(want.grad_norm)
        assert (got.n_gemms, got.n_tasks, got.n_recovered) \
            == (want.n_gemms, want.n_tasks, want.n_recovered)
        assert got.verified and all(r.verified for r in got.records)
        assert got.failed_ids == want.failed_ids
        assert got.predicted_makespan == pytest.approx(
            want.predicted_makespan, rel=1e-9)
        kinds = [r.kind for r in got.records]
        assert {k: kinds.count(k) for k in set(kinds)} == {
            "fwd": got.n_gemms // 3, "dA": got.n_gemms // 3,
            "dW": got.n_gemms // 3}
    assert ref["steps"][FAIL_STEP].n_recovered > 0
    assert FAIL_IDS[0] not in rt.fleet.ids() and len(rt.fleet) == 7
    jparams, jopt = ref["final"]
    assert _worst_rel(jparams, params) <= REL_TOL
    assert _worst_rel(jopt.mu, opt.mu) <= REL_TOL
    assert _worst_rel(jopt.nu, opt.nu) <= REL_TOL
    evs = [h for h in rt.history if h["event"] == "train_step"]
    assert [e["step"] for e in evs] == [0, 1, 2]
    assert set(evs[0]) == {"event", "step", "loss", "backend", "n_gemms",
                           "n_tasks", "n_recovered", "verified",
                           "predicted_makespan", "failed_ids"}


def test_dataflow_dispatch_gives_level_loss(ref):
    """Deferred (dataflow) verification leaves the numerics unchanged and
    reports the overlapped verify wall."""
    _, params, opt, _, level, data = _port_setup(ref)
    flow = _port_setup(ref, dispatch="dataflow")[4]
    batch = _batch(data, 0)
    _, _, met_l = level.step(params, opt, batch)
    _, _, met_d = flow.step(params, opt, batch)
    assert met_d["fleet"].loss == met_l["fleet"].loss
    assert met_d["fleet"].grad_norm == met_l["fleet"].grad_norm
    assert met_d["fleet"].verified and met_d["fleet"].dispatch == "dataflow"
    assert met_d["fleet"].fleet_verify_time > 0
    assert met_d["fleet"].predicted_makespan_overlap is not None


def test_fail_beyond_step_gemm_count_rejected(ref):
    _, params, opt, rt, sess, data = _port_setup(ref)
    with pytest.raises(RuntimeError, match="never fired"):
        sess.step(params, opt, _batch(data, 0), fail_ids=[3],
                  fail_at_gemm=10_000)
    assert len(rt.fleet) == 8
    _, _, met = sess.step(params, opt, _batch(data, 0))
    assert met["fleet"].failed_ids == () and met["fleet"].verified


def test_exception_mid_step_leaves_session_clean(ref):
    """A step that raises after some fleet GEMMs ran (a label outside the
    vocabulary fails the loss) leaves no records, armed failure, GEMM
    counter or installed hook behind; the next step matches a fresh
    session's."""
    _, params, opt, rt, sess, data = _port_setup(ref)
    bad = _batch(data, 0)
    bad["labels"][0, 0] = 10 ** 6
    with pytest.raises(RuntimeError):
        sess.step(params, opt, bad, fail_ids=[3], fail_at_gemm=FAIL_AT)
    g = sess.gemms
    assert (g.records, g.churn_reports, g._gemm_index, g._armed) \
        == ([], [], 0, None)
    assert hook.active() is None and fleet_gemm._SESSION is None
    assert len(rt.fleet) == 8
    _, _, met = sess.step(params, opt, _batch(data, 0))
    _, _, fresh = _port_setup(ref)[4].step(params, opt, _batch(data, 0))
    assert met["fleet"].loss == fresh["fleet"].loss
    assert met["fleet"].n_gemms == fresh["fleet"].n_gemms


def test_runtime_train_step_caches_sessions_by_value(ref):
    cfg, params, opt, rt, _, data = _port_setup(ref)
    _, _, m1 = rt.train_step(params, opt, _batch(data, 0), **CHUNKS)
    _, _, m2 = rt.train_step(params, opt, _batch(data, 0), **CHUNKS)
    assert len(rt._train_sessions) == 1
    assert m2["fleet"].n_cold_plan_solves == 0
    assert m1["fleet"].loss == m2["fleet"].loss


def test_unported_training_options_raise(ref, tmp_path):
    """The training options the port once refused now build sessions:
    ``n_ps=2`` (or a DiLoCo config) the multi-PS session on the runtime's
    device, ``checkpoint`` a single-PS session with a checkpoint manager;
    and every model family trains (the name is the test's history)."""
    from repro_torch.checkpointing.checkpoint import CheckpointManager
    from repro_torch.optim.diloco import DiLoCoConfig
    from repro_torch.train_loop import MultiPSTrainSession
    _, _, _, rt, _, _ = _port_setup(ref)
    multi = rt.train_session(n_ps=2)
    assert isinstance(multi, MultiPSTrainSession) and multi.n_islands == 2
    assert all(isl.rt.device == rt.device for isl in multi.islands)
    assert isinstance(rt.train_session(diloco=DiLoCoConfig()),
                      MultiPSTrainSession)
    single = rt.train_session(checkpoint=str(tmp_path), checkpoint_every=3)
    assert isinstance(single.checkpoint, CheckpointManager)
    assert single.checkpoint.every == 3
    # MoE, MLA, M-RoPE, the encoder-decoder and the hybrid (hymba-1.5b,
    # the last family) train since their slices: hymba's session opens
    # and the model takes one value_and_grad
    hcfg = get_config("hymba-1.5b").reduced()
    with pytest.warns(UserWarning, match="PS-locally"):
        TorchCleaveRuntime(arch=hcfg, fleet=Fleet.sample(4, seed=0),
                           device="cpu").train_session()
    params = M.init_params(hcfg, torch.Generator().manual_seed(0))
    toks = torch.arange(16).reshape(2, 8) % hcfg.vocab_size
    (loss, _), _ = M.value_and_grad(hcfg, params, {"tokens": toks,
                                                   "labels": toks})
    assert bool(torch.isfinite(loss))


# ----------------------------------------------------------------- driver --

@pytest.mark.parametrize("backend", ["torch", "fleet"])
def test_train_driver_on_cpu(backend, tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "metrics.json"
    argv = ["--reduced", "--layers", "1", "--d-model", "64", "--vocab",
            "256", "--steps", "2", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--backend", backend, "--metrics-out",
            str(out)]
    if backend == "fleet":
        argv += ["--fail-step", "1", "--fail-ids", "3", "--fleet-devices",
                 "8"]
    assert train.main(argv) == 0
    import json
    rows = json.loads(out.read_text())
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    if backend == "fleet":
        assert all(r["fleet_verified"] for r in rows)
        assert rows[1]["fleet_recovered"] > 0
    # checkpoints as the reference's driver writes them: every
    # --ckpt-every steps from step 0, {"params", "opt"} and the loss
    from repro.checkpointing import checkpoint as jckpt
    from repro_torch.checkpointing import checkpoint as ckpt
    ck = tmp_path / "ckpt"
    assert train.main(argv + ["--ckpt-dir", str(ck), "--ckpt-every",
                              "1"]) == 0
    mgr = ckpt.CheckpointManager(str(ck))
    assert mgr.steps() == [0, 1]
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), n_layers=1,
                               d_model=64, d_ff=256, vocab_size=256)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    want = jckpt._flatten({"params": jparams,
                           "opt": jadam.init(jparams, jadam.AdamConfig())})
    with np.load(mgr._path(1)) as z:
        assert set(z.files) == set(want)
        assert all(z[k].shape == np.shape(v) for k, v in want.items())
    meta = jckpt.load_metadata(mgr._path(1))
    assert meta["step"] == 1 and meta["loss"] == pytest.approx(
        json.loads(out.read_text())[1]["loss"])
