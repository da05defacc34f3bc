"""The port's M-RoPE family against the reference on
``qwen2-vl-72b.reduced()`` (f32: 2 layers, d 256, 4 heads of 32 over 4,
sections (4, 6, 6)), fed the same numpy inputs: ``apply_m_rope`` at both
section layouts, ``fuse_inputs`` with a vision prefix, M-RoPE attention
and its decode positions, ``loss_fn`` and its gradients, ``prefill`` and
``decode_step`` with and without a patch prefix, the PS-centric fleet
step over three steps with a device failure, fleet serving with a
failure, and the drivers; on the card (``gpu``-marked), the flash
attention and flash-decode kernels at qwen2-vl-72b's heads.  Every M-RoPE
input carries distinct (t, h, w):
with t = h = w (``default_m_positions``) M-RoPE equals plain RoPE and
would hide a section fault.  Both sides compute in f32 and sum in
different orders: 1e-5 of the largest value for forward values, 1e-4
relative for gradients and the training state (the reference's bars,
``tests/test_train_loop.py``)."""
import collections
import json
import math

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
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       grid_positions, modality_stubs)
from repro_torch.interop import from_jax_opt_state, from_jax_params
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adam

ARCH = "qwen2-vl-72b"
B, S, SVIS = 2, 16, 4
CHUNKS = dict(loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
REL_TOL = 1e-4
N_STEPS, FAIL_STEP, FAIL_IDS = 3, 1, (3,)
# 15 forward fleet GEMMs a step (q, k, v, o, gate, up, down a layer, the
# LM head in one chunk): GEMM 20 is in the backward
FAIL_AT = 20


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


def _positions(rng, b=B, s=S):
    """(b, s, 3) int32 M-RoPE positions whose t, h and w all differ."""
    pos = rng.integers(0, 4 * s, (b, s, 3)).astype(np.int32)
    pos[..., 1] += 1
    pos[..., 2] += 2 * s
    return pos


def _batch(data, step, rng=None):
    """A training batch with the driver's patch prefix and, when ``rng``
    is given, distinct (t, h, w) positions; numpy, for both sides."""
    raw = data.batch(step)
    raw.update(modality_stubs(get_config(ARCH).reduced(), B, S, step))
    raw["positions_mrope"] = (grid_positions(B, S, (2, 2)) if rng is None
                              else _positions(rng))
    return raw


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet run (numpy executor) over ``N_STEPS`` steps,
    devices ``FAIL_IDS`` failing at GEMM ``FAIL_AT`` of step ``FAIL_STEP``,
    on batches with a 4-patch prefix on a 2 x 2 grid; its initial and
    final states as numpy trees and its step reports."""
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
        batch = {k: jnp.asarray(v) for k, v in _batch(data, step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT)
        steps.append(met["fleet"])
    return {"jcfg": jcfg, "init": init, "steps": steps,
            "final": (_np_tree(params), _np_tree(opt))}


def _layer0_attn(ref):
    jp = jax.tree.map(lambda t: jnp.asarray(t[0]),
                      ref["init"][0]["layers"]["attn"])
    return jp, from_jax_params(_np_tree(jp), "cpu")


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_m_rope_matches_reference(hd, sections, rng):
    """``apply_m_rope`` with distinct (t, h, w) at the reduced and the full
    config's section layouts: within 1e-5 of the reference, and unlike
    plain RoPE of any one of the three positions."""
    x = rng.standard_normal((B, S, 3, hd)).astype(np.float32)
    pos = _positions(rng)
    want = JL.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         sections)
    _close(got, want)
    for axis in range(3):
        plain = L.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(pos[..., axis].copy()), 1e6)
        assert float((plain - got).abs().max()) > 1e-3


def test_default_m_positions_reduce_to_rope(rng):
    """``default_m_positions`` is t = h = w = the linear position, as the
    reference's, and M-RoPE over it is plain RoPE."""
    got = L.default_m_positions(B, S)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.default_m_positions(B, S)))
    x = torch.from_numpy(rng.standard_normal((B, S, 2, 32))
                         .astype(np.float32))
    np.testing.assert_allclose(
        L.apply_m_rope(x, got, 1e6, (4, 6, 6)).numpy(),
        L.apply_rope(x, got[..., 0], 1e6).numpy(), rtol=0, atol=1e-6)


def test_grid_positions_layout():
    """A 2 x 3 patch grid at t = 0, then text from max(2, 3) = 3 on."""
    pos = grid_positions(1, 8, (2, 3))[0]
    assert pos[:6].tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 2],
                                [0, 1, 0], [0, 1, 1], [0, 1, 2]]
    assert pos[6:].tolist() == [[3, 3, 3], [4, 4, 4]]


# -------------------------------------------------------------- attention --

def test_attention_block_mrope_matches_reference(ref, rng):
    """Causal M-RoPE self-attention over distinct (t, h, w): the output
    and the rotated k, and the gradients with respect to x and every
    projection against ``jax.grad`` (1e-4 relative)."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp, p = _layer0_attn(ref)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = _positions(rng)
    jo, (jk, _) = JA.attention_block(jcfg, jp, jnp.asarray(x),
                                     jnp.asarray(pos), q_chunk=8, k_chunk=8)
    out, (k, _) = A.attention_block(cfg, p, torch.from_numpy(x),
                                    torch.from_numpy(pos), q_chunk=8,
                                    k_chunk=8)
    _close(out, jo)
    _close(k, jk)
    names = sorted(jp)

    def jloss(x_, *ws):
        o, _ = JA.attention_block(jcfg, dict(zip(names, ws)), x_,
                                  jnp.asarray(pos), q_chunk=8, k_chunk=8)
        return jnp.sum(o * gy)

    jg = jax.grad(jloss, argnums=tuple(range(len(names) + 1)))(
        jnp.asarray(x), *(jp[n] for n in names))
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        p[n].clone().requires_grad_() for n in names]
    o, _ = A.attention_block(cfg, dict(zip(names, leaves[1:])), leaves[0],
                             torch.from_numpy(pos), q_chunk=8, k_chunk=8)
    (o * torch.from_numpy(gy)).sum().backward()
    for want, t in zip(jg, leaves):
        want = np.asarray(want)
        assert np.abs(t.grad.numpy() - want).max() / np.abs(want).max() \
            <= REL_TOL


@pytest.mark.parametrize("vec", [False, True])
def test_attention_decode_positions_match_reference(ref, vec, rng):
    """One decode token at a scalar position or per-slot positions: the
    position is repeated as (t, h, w) (the reference's decode positions),
    the output and new k/v within 1e-5."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp, p = _layer0_attn(ref)
    Smax, K, hd = 16, cfg.n_kv_heads, cfg.head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    if vec:
        pos = np.asarray([5, 12], np.int32)
        valid = np.arange(Smax)[None, :] < pos[:, None] + 1
    else:
        pos = np.asarray(9, np.int32)
        valid = np.arange(Smax) < 10
    assert tuple(A._decode_positions(cfg, torch.from_numpy(pos), B).shape) \
        == (B, 1, 3)
    want = JA.attention_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(ck), jnp.asarray(cv),
                               jnp.asarray(pos), jnp.asarray(valid))
    got = A.attention_decode(cfg, p, torch.from_numpy(x),
                             torch.from_numpy(pos), torch.from_numpy(ck),
                             torch.from_numpy(cv), torch.from_numpy(pos),
                             torch.from_numpy(valid))
    for g, w in zip(got, want):
        _close(g, w)


# ----------------------------------------------------------- model level --

def test_fuse_inputs_matches_reference(ref, rng):
    """The patch prefix replaces the first SVIS token embeddings and the
    batch's ``positions_mrope`` pass through; without them the positions
    are ``default_m_positions``."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    vis = rng.standard_normal((B, SVIS, cfg.d_model)).astype(np.float32)
    pos = _positions(rng)
    for batch in ({"tokens": toks, "vision_embeds": vis,
                   "positions_mrope": pos}, {"tokens": toks}):
        jx, jpos = JM.fuse_inputs(jcfg, jp, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        x, tpos = M.fuse_inputs(cfg, p, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        _close(x, jx, tol=0)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        if "vision_embeds" in batch:
            np.testing.assert_array_equal(x[:, :SVIS].numpy(), vis)
            np.testing.assert_array_equal(
                x[:, SVIS:].numpy(),
                p["embed"]["tok"][torch.from_numpy(toks[:, SVIS:]).long()]
                .numpy())


def test_loss_fn_value_and_grads_match_reference(ref, rng):
    """``loss_fn`` over a batch with a patch prefix and distinct (t, h, w)
    positions, and its parameter gradients, against
    ``jax.value_and_grad`` of the reference's unrolled ``loss_fn``: 1e-5
    on the loss, 1e-4 relative per gradient leaf."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    raw = _batch(JSyntheticLM(JDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=S, global_batch=B, seed=0)),
        0, rng)
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


@pytest.mark.parametrize("vision", [False, True])
def test_prefill_and_decode_match_reference(ref, vision, rng):
    """Prefill of a 12-token prompt (with a 4-patch prefix and distinct
    positions, or text alone) and two decode steps on its cache: logits
    and the K/V cache within 1e-5 of their largest value."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    P = 12
    toks = rng.integers(0, cfg.vocab_size, (B, P + 2)).astype(np.int32)
    batch = {"tokens": toks[:, :P]}
    if vision:
        batch["vision_embeds"] = rng.standard_normal(
            (B, SVIS, cfg.d_model)).astype(np.float32)
        batch["positions_mrope"] = _positions(rng, B, P)
    jlg, jc = JM.prefill(jcfg, jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    lg, c = M.prefill(cfg, p, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    _close(lg, jlg)
    assert set(c) == {"pos", "k", "v"} and int(c["pos"]) == P
    for t in (P, P + 1):
        for nm in ("k", "v"):
            _close(c[nm], jc[nm])
        jlg, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)


def test_decode_token_by_token_equals_prefill(ref, rng):
    """Text alone: token-by-token decoding (t = h = w = the position)
    reaches one prefill's last logits and cache (the reference's
    ``test_decode_matches_forward`` contract)."""
    cfg = get_config(ARCH).reduced()
    p = from_jax_params(ref["init"][0], "cpu")
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int64))
    lg, c = M.prefill(cfg, p, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 10, device="cpu")
    for t in range(10):
        lg1, cache = M.decode_step(cfg, p, cache, toks[:, t:t + 1])
    _close(lg1, lg.numpy())
    for nm in ("k", "v"):
        _close(cache[nm], c[nm].numpy())


def test_vlm_decode_with_vision_prefix(ref, rng):
    """The reference's ``test_vlm_decode_with_vision_prefix`` contract:
    prefill with a patch prefix gives the last row of the full forward
    over the fused stream (1e-3 / 1e-4 as there), a cache of S slots at
    position S; and the forward agrees with the reference's."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    vis = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    batch = {"tokens": torch.from_numpy(toks),
             "vision_embeds": torch.from_numpy(vis)}
    x, _, _ = M.forward(cfg, p, batch)
    want = L.lm_logits(p["head"], p["embed"], x, cfg)[..., :cfg.vocab_size]
    jx, _, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                     "vision_embeds": jnp.asarray(vis)},
                          remat=False)
    _close(x, jx)
    logits, cache = M.prefill(cfg, p, batch)
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab_size].numpy(),
                               want[:, -1].detach().numpy(), rtol=1e-3,
                               atol=1e-4)
    assert int(cache["pos"]) == 8 and cache["k"].shape[2] == 8


# ------------------------------------------------------------- fleet step --

def _fleet_run(ref, **session):
    cfg = get_config(ARCH).reduced()
    params = from_jax_params(ref["init"][0], "cpu")
    opt = from_jax_opt_state(ref["init"][1], "cpu")
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    sess = rt.train_session(adam.AdamConfig(**OPT), **CHUNKS, **session)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    reports = []
    for step in range(N_STEPS):
        batch = {k: torch.as_tensor(v) for k, v in _batch(data, step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT, donate=True)
        reports.append(met["fleet"])
    return cfg, rt, params, opt, reports


def test_fleet_step_matches_reference(ref):
    """Three donated fleet steps over batches with a patch prefix on M-RoPE
    grid positions, device 3 failing at GEMM 20 (in the backward) of step
    1: loss, grad_norm, params and both moments within 1e-4 (max-relative
    per leaf) of the reference's fleet run (numpy executor), the same
    GEMMs in the same order (45 a step: 15 of each kind), task and
    recovery counts, predicted makespans, every step verified."""
    cfg, rt, params, opt, reports = _fleet_run(ref)
    for got, want in zip(reports, ref["steps"]):
        assert abs(got.loss - want.loss) <= REL_TOL * abs(want.loss)
        assert abs(got.grad_norm - want.grad_norm) \
            <= REL_TOL * abs(want.grad_norm)
        assert got.n_gemms == want.n_gemms == 45
        assert collections.Counter(r.kind for r in got.records) \
            == {"fwd": 15, "dA": 15, "dW": 15}
        assert (got.n_tasks, got.n_recovered) \
            == (want.n_tasks, want.n_recovered)
        assert got.verified and all(r.verified for r in got.records)
        assert got.failed_ids == want.failed_ids
        assert got.predicted_makespan == pytest.approx(
            want.predicted_makespan, rel=1e-9)
        assert [(r.kind, r.m, r.n, r.q) for r in got.records] \
            == [(r.kind, r.m, r.n, r.q) for r in want.records]
    assert ref["steps"][FAIL_STEP].n_recovered > 0
    assert FAIL_IDS[0] not in rt.fleet.ids()
    jparams, jopt = ref["final"]
    assert _worst_rel(jparams, params) <= REL_TOL
    assert _worst_rel(jopt.mu, opt.mu) <= REL_TOL
    assert _worst_rel(jopt.nu, opt.nu) <= REL_TOL


# --------------------------------------------------------- serving, drivers --

def test_serve_session_matches_reference_with_failure(ref):
    """Fleet serving through the paged K/V pools with per-slot M-RoPE
    decode positions against the reference's session on the same params,
    device 2 failing at step 1 and the paged read checked every step:
    greedy tokens, every step's GEMM, task and recovery counts and the
    paged-read checks identical."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    kw = dict(slots=3, page_size=4, max_len=16, check_paged_read=True)
    jrt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(8, seed=0))
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    js = jrt.serve_session(jax.tree.map(jnp.asarray, ref["init"][0]), **kw)
    ts = rt.serve_session(from_jax_params(ref["init"][0], "cpu"), **kw)
    rng = np.random.default_rng(1)
    for n in (5, 7, 3):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        js.submit(prompt, max_new=4)
        ts.submit(prompt, max_new=4)
    jrep = js.run(fail_ids=[2], fail_at_step=1)
    trep = ts.run(fail_ids=[2], fail_at_step=1)
    assert {r.rid: r.tokens for r in ts.batcher.finished} \
        == {r.rid: r.tokens for r in js.batcher.finished}
    assert [(s.n_gemms, s.n_tasks, s.n_recovered, s.verified)
            for s in ts.step_reports] \
        == [(s.n_gemms, s.n_tasks, s.n_recovered, s.verified)
            for s in js.step_reports]
    assert trep.failed_ids == jrep.failed_ids == (2,)
    assert trep.n_recovered == jrep.n_recovered > 0
    assert ts.paged_read_checks == js.paged_read_checks > 0


@pytest.mark.parametrize("backend", ["torch", "fleet"])
def test_train_driver_runs_mrope_on_cpu(backend, tmp_path):
    """``launch/train.py --arch qwen2-vl-72b`` with the driver's patch
    prefix, both backends, a failure on the fleet."""
    from repro_torch.launch import train
    out = tmp_path / "metrics.json"
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--backend", backend,
            "--metrics-out", str(out)]
    if backend == "fleet":
        argv += ["--fail-step", "1", "--fail-ids", "3", "--fleet-devices",
                 "8"]
    assert train.main(argv) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    if backend == "fleet":
        assert all(r["fleet_verified"] for r in rows)
        assert all(r["fleet_gemms"] == 45 for r in rows)
        assert rows[1]["fleet_recovered"] > 0


def test_serve_driver_runs_mrope_on_cpu(capsys):
    """``launch/serve.py --arch qwen2-vl-72b`` decodes on the monolithic
    path, then serves the same prompts through the fleet session."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen", "4", "--edge-plan", "8"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "edge serve executed" in out
    assert "greedy tokens match monolithic: True" in out


# ------------------------------------------------------------- on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _ulp_tol(big, dtype, f32_tol):
    """``f32_tol`` of the largest output in f32; one bf16 ulp of it in
    bf16 (the output is rounded to bf16)."""
    return f32_tol * big if dtype == "float32" \
        else 2.0 ** (math.floor(math.log2(big)) - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 15])
def test_flash_kernel_mrope_shapes_on_card(cuda, S, dtype):
    """B4 at qwen2-vl-72b's heads (64 over 8: G 8, D 128), causal: the
    training step's 128 rows and a serving prefill of 15; against its
    plain version, 1e-5 of the largest output in f32, one bf16 ulp in
    bf16; two launches bit for bit."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, S, 64, 128), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((2, S, 8, 128), generator=gen, device=cuda).to(dt)
            for _ in range(2))
    n0 = fa.launches
    got = ops.mha_flash(q, k, v, causal=True)
    again = ops.mha_flash(q, k, v, causal=True)
    assert fa.launches == n0 + 2 and torch.equal(got, again)
    want = fa._attend_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=0,
                            q_offset=0).transpose(1, 2)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _ulp_tol(float(want.float().abs().max()), dtype, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_mrope_shape_on_card(cuda, dtype):
    """B5 at qwen2-vl-72b's serving decode (4 slots, 64 heads over 8, D
    128, a cache of 32 with 16..23 valid slots) against its plain
    version: 2e-4 in f32 (the reference's bar for sums in another order),
    one bf16 ulp of the largest output in bf16."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((4, 1, 64, 128), generator=gen, device=cuda)
    k, v = (torch.randn((4, 32, 8, 128), generator=gen, device=cuda)
            .to(dt) for _ in range(2))
    lengths = torch.tensor([16, 19, 22, 23], device=cuda)
    valid = torch.arange(32, device=cuda)[None, :] < lengths[:, None]
    n0 = dec.flash_decode_launches
    got = ops.gqa_flash_decode(q, k, v, valid)
    assert dec.flash_decode_launches == n0 + 1
    want = dec.flash_decode_plain(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    assert err <= _ulp_tol(max(big, 1.0) if dtype == "float32" else big,
                           dtype, 2e-4)
