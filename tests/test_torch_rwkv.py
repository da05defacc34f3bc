"""The port's RWKV-6 family against the reference on ``rwkv6-7b.reduced()``
(f32), fed the same numpy inputs: the chunked WKV recurrence with a
carried state and its gradients, the time and channel mixes, the init
layout, ``loss_fn`` and its gradients, ``prefill`` and ``decode_step``,
the PS-centric fleet step over three steps with a device failure, the
drivers, and the serving session's refusal.  Both sides compute in f32 and
sum in different orders: 1e-5 of the largest value for forward values,
1e-4 relative for gradients and the training state (the reference's
bars, ``tests/test_train_loop.py``)."""
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
from repro.models import model as JM
from repro.models import rwkv as JR
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import from_jax_opt_state, from_jax_params
from repro_torch.models import model as M
from repro_torch.models import rwkv as R
from repro_torch.optim import adam

ARCH = "rwkv6-7b"
B, S = 2, 32
CHUNKS = dict(loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
REL_TOL = 1e-4
N_STEPS, FAIL_STEP, FAIL_IDS = 3, 1, (3,)
FAIL_AT = 2           # 6 fleet GEMMs per step (LM head fwd, dA, dW x 2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _worst_rel(want, got):
    """Per leaf, max |a - b| over max |a| (the reference's measure)."""
    return max(float(np.abs(np.asarray(a, np.float32) - b.float().numpy())
                     .max() / (np.abs(np.asarray(a, np.float32)).max()
                               + 1e-12))
               for a, b in zip(jax.tree.leaves(want), T.leaves(got)))


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet run (numpy executor) over ``N_STEPS`` steps,
    devices ``FAIL_IDS`` failing at GEMM ``FAIL_AT`` of step ``FAIL_STEP``;
    its initial and final states as numpy trees."""
    jcfg = jget_config(ARCH).reduced()
    jopt = jadam.AdamConfig(**OPT)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jadam.init(params, jopt)
    init = (_np_tree(params), _np_tree(opt))
    data = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=0))
    rt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(8, seed=0))
    with pytest.warns(UserWarning, match="PS-locally"):
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


@pytest.fixture(scope="module")
def cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


def _wkv_inputs(rng, B_, S_, H, hd):
    r, k, v = (rng.standard_normal((B_, S_, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.1, 0.999, (B_, S_, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B_, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


# --------------------------------------------------------- WKV recurrence --

@pytest.mark.parametrize("S_,chunk", [(64, 16), (32, 32), (20, 32)])
def test_wkv_chunked_with_state_matches_reference(S_, chunk, rng):
    """y and the last state from a nonzero incoming state (the chunked
    forward runs the kernel wrapper, here its plain version)."""
    args = _wkv_inputs(rng, 2, S_, 2, 16)
    jy, js = JR.wkv_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    y, s = R.wkv_chunked(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    _close(y, jy)
    _close(s, js)


def test_wkv_chunked_grads_match_reference(rng):
    """Gradients through the autograd Function (kernel forward, chunked
    torch body differentiated backward) against ``jax.grad`` of the
    reference's ``wkv_chunked``, for every input: 1e-4 relative."""
    args = _wkv_inputs(rng, 2, 32, 2, 16)
    gy = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    gs = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)

    def jloss(*a):
        y, s = JR.wkv_chunked(*a, chunk=16)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = R.wkv_chunked(*leaves, chunk=16)
    (y * torch.from_numpy(gy)).sum().add((s * torch.from_numpy(gs)).sum()) \
        .backward()
    for jg, t in zip(jgrads, leaves):
        want = np.asarray(jg)
        err = np.abs(t.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= REL_TOL, err


# ------------------------------------------------------------ mix blocks --

def _layer0(jparams):
    return jax.tree.map(lambda t: t[0], jparams["layers"])


def test_time_and_channel_mix_match_reference(cfgs, rng):
    jcfg, cfg = cfgs
    jp = _layer0(JM.init_params(jcfg, jax.random.PRNGKey(2)))
    p = from_jax_params(_np_tree(jp), "cpu")
    d = cfg.d_model
    H, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    prev = rng.standard_normal((2, d)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, H, hd, hd))).astype(np.float32)
    jout, jlast, js = JR.time_mix(jcfg, jp["time_mix"], jnp.asarray(x),
                                  jnp.asarray(prev), jnp.asarray(s0))
    out, last, s = R.time_mix(cfg, p["time_mix"], torch.from_numpy(x),
                              torch.from_numpy(prev), torch.from_numpy(s0))
    _close(out, jout)
    _close(last, jlast, tol=0)
    _close(s, js)
    jcm, jcl = JR.channel_mix(jcfg, jp["channel_mix"], jnp.asarray(x),
                              jnp.asarray(prev))
    cm, cl = R.channel_mix(cfg, p["channel_mix"], torch.from_numpy(x),
                           torch.from_numpy(prev))
    _close(cm, jcm)
    _close(cl, jcl, tol=0)


def test_init_params_layout_matches_reference(cfgs):
    """``init_params`` draws the reference's RWKV tree: same keys, shapes
    and dtypes (mu (L, 5, d), u (L, H, hd), ln_x, the decay LoRA), layers
    stacked, same init scales; ``from_jax_params`` carries that tree over
    leaf for leaf."""
    jcfg, cfg = cfgs
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    ours = M.init_params(cfg, torch.Generator().manual_seed(0))
    carried = from_jax_params(_np_tree(jparams), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(T.leaves(ours)) == len(T.leaves(carried))
    for path, leaf in flat_j:
        node, got = ours, carried
        for p in path:
            node, got = node[p.key], got[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
        want_std = float(np.std(np.asarray(leaf)))
        assert abs(float(node.float().std()) - want_std) \
            <= 0.1 * want_std + 1e-6, path
        if want_std == 0:       # constants: w0, norm scales and biases
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    L_, d = cfg.n_layers, cfg.d_model
    tm = ours["layers"]["time_mix"]
    assert tuple(tm["mu"].shape) == (L_, 5, d)
    assert tuple(tm["u"].shape) == (L_, d // cfg.rwkv_head_dim,
                                    cfg.rwkv_head_dim)


# ----------------------------------------------------------- model level --

def test_loss_fn_value_and_grads_match_reference(ref):
    """``loss_fn`` and its parameter gradients against ``jax.value_and_grad``
    of the reference's unrolled ``loss_fn``: 1e-5 on the loss, 1e-4
    relative per gradient leaf."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    raw = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    raw["labels"][0, :5] = -1
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in raw.items()},
                             scan_layers=False, **CHUNKS),
        has_aux=True)(jax.tree.map(jnp.asarray, ref["init"][0]))
    (loss, met), grads = M.value_and_grad(
        cfg, from_jax_params(ref["init"][0], "cpu"),
        {k: torch.as_tensor(v) for k, v in raw.items()}, **CHUNKS)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - 5
    assert _worst_rel(jgrads, grads) <= REL_TOL


@pytest.mark.parametrize("P", [7, 32, 40])
def test_prefill_and_decode_match_reference(ref, P, rng):
    """Prefill of a P-token prompt (one chunk below 32, the chunked rule
    at 32, one whole-prompt chunk at 40) and two decode steps on its
    states: logits, ``wkv_state``, ``tm_prev`` and ``cm_prev`` within 1e-5
    of their largest value."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, P + 2)).astype(np.int32)
    jlg, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P])})
    lg, c = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :P])})
    _close(lg, jlg)
    assert int(c["pos"]) == int(jc["pos"]) == P
    for t in (P, P + 1):
        for nm in ("wkv_state", "tm_prev", "cm_prev"):
            assert c[nm].dtype == torch.float32
            _close(c[nm], jc[nm])
        jlg, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)
    assert int(c["pos"]) == P + 2


def test_decode_token_by_token_equals_prefill(ref, rng):
    """Decoding a prompt token by token from ``init_cache`` reaches the
    states and last logits of one prefill over it (the kernel's chunked
    form against its one-step form)."""
    cfg = get_config(ARCH).reduced()
    p = from_jax_params(ref["init"][0], "cpu")
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int64))
    lg, c = M.prefill(cfg, p, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 12, device="cpu")
    for t in range(12):
        lg1, cache = M.decode_step(cfg, p, cache, toks[:, t:t + 1])
    _close(lg1, lg.numpy())
    for nm in ("wkv_state", "tm_prev", "cm_prev"):
        _close(cache[nm], c[nm].numpy())


# ------------------------------------------------------------- fleet step --

def _l2_rel(want, got):
    """Per leaf, the L2 norm of the difference over the leaf's L2 norm."""
    return max(float(np.linalg.norm(np.asarray(a, np.float32)
                                    - b.float().numpy())
                     / (np.linalg.norm(np.asarray(a, np.float32)) + 1e-12))
               for a, b in zip(jax.tree.leaves(want), T.leaves(got)))


def _fleet_run(ref, **session):
    cfg = get_config(ARCH).reduced()
    params = from_jax_params(ref["init"][0], "cpu")
    opt = from_jax_opt_state(ref["init"][1], "cpu")
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    with pytest.warns(UserWarning, match="PS-locally"):
        sess = rt.train_session(adam.AdamConfig(**OPT), **CHUNKS, **session)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    reports = []
    for step in range(N_STEPS):
        batch = {k: torch.as_tensor(v) for k, v in data.batch(step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT)
        reports.append(met["fleet"])
    return cfg, rt, params, opt, reports


def test_fleet_step_matches_reference(ref):
    """Three fleet steps, devices failing at GEMM 2 of step 1: loss,
    grad_norm and both moments within 1e-4 (max-relative per leaf) of the
    reference's fleet run (numpy executor), params within 1e-4 in L2 per
    leaf, the same GEMM, task and recovery counts, every step verified;
    only the LM head's GEMMs (fwd, dA, dW per loss chunk) reach the fleet,
    as in the reference.  The params are held in L2 because AdamW moves an
    element whose gradient lies within f32 rounding of zero by about lr,
    whichever way its sign falls: here one embedding element reads 6.5e-4
    max-relative on summation order alone (PERF.md, Findings).  The same run
    under the bf16 policy must fail the L2 bound."""
    cfg, rt, params, opt, reports = _fleet_run(ref)
    for got, want in zip(reports, ref["steps"]):
        assert abs(got.loss - want.loss) <= REL_TOL * abs(want.loss)
        assert abs(got.grad_norm - want.grad_norm) \
            <= REL_TOL * abs(want.grad_norm)
        assert (got.n_gemms, got.n_tasks, got.n_recovered) \
            == (want.n_gemms, want.n_tasks, want.n_recovered)
        assert got.verified and all(r.verified for r in got.records)
        assert got.failed_ids == want.failed_ids
        assert got.predicted_makespan == pytest.approx(
            want.predicted_makespan, rel=1e-9)
        assert {r.kind for r in got.records} == {"fwd", "dA", "dW"}
        assert {(r.m, r.n, r.q) for r in got.records if r.kind == "fwd"} \
            == {(B * CHUNKS["loss_chunk"], cfg.d_model, 512)}
    assert ref["steps"][FAIL_STEP].n_recovered > 0
    assert FAIL_IDS[0] not in rt.fleet.ids()
    jparams, jopt = ref["final"]
    assert _l2_rel(jparams, params) <= REL_TOL
    assert _worst_rel(jopt.mu, opt.mu) <= REL_TOL
    assert _worst_rel(jopt.nu, opt.nu) <= REL_TOL
    control = _fleet_run(ref, dtype_policy="bf16")[2]
    assert _l2_rel(jparams, control) > REL_TOL


# --------------------------------------------------------- serving, drivers --

def test_serve_session_refuses_rwkv_like_reference():
    """Recurrent states are not paged, in either package: the session
    raises the reference's ``ValueError`` from ``PagedKVCache``."""
    from repro.serving.kv_cache import PagedKVCache as JPaged
    with pytest.raises(ValueError, match="recurrent") as want:
        JPaged(jget_config(ARCH).reduced(), n_pages=4, page_size=4)
    rt = TorchCleaveRuntime(arch=get_config(ARCH).reduced(),
                            fleet=Fleet.sample(4, seed=0), device="cpu")
    with pytest.raises(ValueError, match="recurrent") as got:
        rt.serve_session(slots=2, page_size=4, max_len=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["torch", "fleet"])
def test_train_driver_runs_rwkv_on_cpu(backend, tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "metrics.json"
    argv = ["--arch", ARCH, "--reduced", "--layers", "1", "--steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu", "--backend",
            backend, "--metrics-out", str(out)]
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


def test_serve_driver_runs_rwkv_on_cpu(capsys):
    """``launch/serve.py --arch rwkv6-7b`` prefills, carries the recurrent
    states into the decode cache and decodes; ``--edge-plan`` fails as the
    reference's does, at the paged serving session."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen", "4"]
    assert serve.main(argv) == 0
    assert f"arch={ARCH}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="recurrent"):
        serve.main(argv + ["--edge-plan", "8"])
