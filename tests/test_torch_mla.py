"""The port's MLA family against the reference on
``deepseek-v2-236b.reduced()`` (f32: 2 layers, d 256, 4 heads of qk 32 +
16 and v 32, kv rank 64, q rank 48; 4 experts top-2, 1 shared, expert
d_ff 64), fed the same numpy inputs: the init layout, ``mla_block`` and
its gradients, the absorbed ``mla_decode`` against a cache, ``loss_fn``
and its gradients, ``prefill`` and ``decode_step``, the flash-attention
plain version at Dk != Dv, the donated AdamW update, the PS-centric fleet
step over three steps with a device failure, fleet serving from the
latent pools, and the drivers.  Both sides compute in f32 and sum in
different orders: 1e-5 of the largest value for forward values, 1e-4
relative for gradients and the training state (the reference's bars,
``tests/test_train_loop.py``)."""
import collections
import dataclasses
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
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import from_jax_opt_state, from_jax_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.serving.kv_cache import PagedKVCache

ARCH = "deepseek-v2-236b"
B, S = 2, 32
CHUNKS = dict(loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
REL_TOL = 1e-4
N_STEPS, FAIL_STEP, FAIL_IDS = 3, 1, (3,)
# 22 forward fleet GEMMs per step (10 a layer: q down and up, kv down, k
# up, v up, out, the router and the shared expert's three; the LM head
# over 2 loss chunks): GEMM 25 is in the backward
FAIL_AT = 25


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread for this module.  Its tensors are small,
    and with pytest-xdist's workers sharing the host's cores torch's
    default pool (a thread a core in every worker) spends most of its time
    waiting for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _worst_rel(want, got):
    """Per leaf, max |a - b| over max |a| (the reference's measure)."""
    return max(float(np.abs(np.asarray(a, np.float32) - b.float().numpy())
                     .max() / (np.abs(np.asarray(a, np.float32)).max()
                               + 1e-12))
               for a, b in zip(jax.tree.leaves(want), T.leaves(got)))


def _l2_rel(want, got):
    """Per leaf, the L2 norm of the difference over the leaf's L2 norm."""
    return max(float(np.linalg.norm(np.asarray(a, np.float32)
                                    - b.float().numpy())
                     / (np.linalg.norm(np.asarray(a, np.float32)) + 1e-12))
               for a, b in zip(jax.tree.leaves(want), T.leaves(got)))


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _cfgs(**over):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **over),
            dataclasses.replace(get_config(ARCH).reduced(), **over))


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet run (numpy executor) over ``N_STEPS`` steps,
    devices ``FAIL_IDS`` failing at GEMM ``FAIL_AT`` of step ``FAIL_STEP``;
    its initial and final states as numpy trees and its step reports."""
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
    steps, aux = [], []
    for step in range(N_STEPS):
        batch = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT)
        steps.append(met["fleet"])
        aux.append(float(met["aux_loss"]))
    return {"jcfg": jcfg, "init": init, "steps": steps, "aux": aux,
            "final": (_np_tree(params), _np_tree(opt))}


def _layer0_attn(ref):
    """Layer 0's MLA params of the fixture's init, on both sides."""
    jp = jax.tree.map(lambda t: jnp.asarray(t[0]),
                      ref["init"][0]["layers"]["attn"])
    return jp, from_jax_params(_np_tree(jp), "cpu")


# ------------------------------------------------------------------- init --

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(param_dtype):
    """``init_params`` draws the reference's MLA tree: same keys, shapes,
    dtypes and init scales (w_dq, q_norm, w_uq, w_dkv, kv_norm, w_uk,
    w_uv, wo stacked over layers, beside the MoE leaves), and
    ``from_jax_params`` carries it over leaf for leaf."""
    jcfg, cfg = _cfgs(param_dtype=param_dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    ours = M.init_params(cfg, torch.Generator().manual_seed(0))
    carried = from_jax_params(_np_tree(jparams), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == len(T.leaves(ours)) == len(T.leaves(carried))
    for path, leaf in flat_j:
        node, got = ours, carried
        for q in path:
            node, got = node[q.key], got[q.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))
        want_std = float(np.std(np.asarray(leaf, np.float32)))
        assert abs(float(node.float().std()) - want_std) \
            <= 0.1 * want_std + 1e-6, path
    attn = ours["layers"]["attn"]
    L_, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
    hd, rd, r, vd, rq = (cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank,
                         cfg.v_dim, cfg.q_lora_rank)
    assert (hd + rd, vd, r, rq) == (48, 32, 64, 48)
    assert {k: tuple(v["scale"].shape if isinstance(v, dict) else v.shape)
            for k, v in attn.items()} == {
        "w_dq": (L_, d, rq), "q_norm": (L_, rq), "w_uq": (L_, rq, H * 48),
        "w_dkv": (L_, d, r + rd), "kv_norm": (L_, r),
        "w_uk": (L_, r, H * hd), "w_uv": (L_, r, H * vd),
        "wo": (L_, H * vd, d)}


def test_deepseek_is_ported():
    """The reduced config initialises the MLA tree (the full config's 236
    B params are not drawn here; ``chip_smoke.py``'s mla_full draws one
    layer of it on the card)."""
    cfg = get_config(ARCH).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert {"w_dkv", "w_uk", "w_uv"} <= set(params["layers"]["attn"])
    assert "moe" in params["layers"]


# -------------------------------------------------------------- MLA block --

def test_mla_block_matches_reference(ref, rng):
    """Output and the latent cache entries (c_kv, k_pe) against the
    reference's ``mla_block`` (its chunked attention at 16-row chunks; the
    port's forward is the flash kernel's plain version at Dk 48, Dv 32)."""
    jcfg, cfg = _cfgs()
    jp, p = _layer0_attn(ref)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jo, (jc, jk) = JA.mla_block(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                q_chunk=16, k_chunk=16)
    out, (c_kv, k_pe) = A.mla_block(cfg, p, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()),
                                    q_chunk=16, k_chunk=16)
    assert tuple(c_kv.shape) == (B, S, cfg.kv_lora_rank)
    assert tuple(k_pe.shape) == (B, S, cfg.rope_head_dim)
    _close(out, jo)
    _close(c_kv, jc)
    _close(k_pe, jk)


def test_mla_block_grads_match_reference(ref, rng):
    """Gradients of a random projection of the output with respect to x
    and every MLA param, against ``jax.grad``: 1e-4 relative (the
    attention's backward is the recompute of the chunked body)."""
    jcfg, cfg = _cfgs()
    jp, p = _layer0_attn(ref)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    names = sorted(jp)

    def jloss(x_, *ws):
        out, _ = JA.mla_block(jcfg, dict(zip(names, ws)), x_,
                              jnp.asarray(pos), q_chunk=16, k_chunk=16)
        return jnp.sum(out * gy)

    jg = jax.grad(jloss, argnums=tuple(range(len(names) + 1)))(
        jnp.asarray(x), *(jp[n] for n in names))
    leaves = [torch.from_numpy(x).requires_grad_()]
    tp = {}
    for n in names:
        if isinstance(p[n], dict):
            tp[n] = {"scale": p[n]["scale"].clone().requires_grad_()}
            leaves.append(tp[n]["scale"])
        else:
            tp[n] = p[n].clone().requires_grad_()
            leaves.append(tp[n])
    out, _ = A.mla_block(cfg, tp, leaves[0], torch.from_numpy(pos),
                         q_chunk=16, k_chunk=16)
    (out * torch.from_numpy(gy)).sum().backward()
    for want, t in zip(jg, leaves):
        want = np.asarray(jax.tree.leaves(want)[0])
        err = np.abs(t.grad.numpy() - want).max() / np.abs(want).max()
        assert err <= REL_TOL, err


@pytest.mark.parametrize("vec", [False, True])
def test_mla_decode_matches_reference(ref, vec, rng):
    """The absorbed decode against a random latent cache: one query token
    per slot at a scalar position (slot 9 of 16) or at per-slot positions
    with per-slot occupancy, the output and the new (c_kv, k_pe) entries
    within 1e-5 of their largest value."""
    jcfg, cfg = _cfgs()
    jp, p = _layer0_attn(ref)
    Smax = 16
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, Smax, cfg.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((B, Smax, cfg.rope_head_dim)) \
        .astype(np.float32)
    if vec:
        pos = np.asarray([5, 12], np.int32)
        valid = np.arange(Smax)[None, :] < pos[:, None] + 1
        slot = pos
    else:
        pos = np.asarray(9, np.int32)
        valid = np.arange(Smax) < 10
        slot = pos
    want = JA.mla_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                         jnp.asarray(ckv), jnp.asarray(kpe),
                         jnp.asarray(slot), jnp.asarray(valid))
    got = A.mla_decode(cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
                       torch.from_numpy(ckv), torch.from_numpy(kpe),
                       torch.from_numpy(slot), torch.from_numpy(valid))
    assert tuple(got[1].shape) == (B, 1, cfg.kv_lora_rank)
    assert tuple(got[2].shape) == (B, 1, cfg.rope_head_dim)
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------ flash attention, Dk != Dv --

@pytest.mark.parametrize("Dk,Dv", [(48, 32), (192, 128), (40, 72)])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_plain_dk_ne_dv_matches_reference(Dk, Dv, window, rng):
    """``ops.mha_flash`` with q/k wider (or narrower) than v (CPU: the
    plain version) against the reference's ``chunked_attention``, causal
    and windowed: out (B,S,H,Dv), scale 1/sqrt(Dk), 1e-5 of the largest
    output."""
    H = 4
    q = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, Dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                q_chunk=8, k_chunk=8)
    got = ops.mha_flash(*(torch.from_numpy(t) for t in (q, k, v)),
                        causal=True, window=window)
    assert tuple(got.shape) == (B, S, H, Dv)
    _close(got, want)


def test_flash_tiles_cover_dk_up_to_192():
    """The kernel's tiles and rows a block: equal dims keep their own,
    MLA's reduced 48 / 32 takes (64, 32), at 64 rows, and every other pair
    up to 192 / 128 the (192, 128) tiles at 128 rows; wider dims raise on
    any device."""
    assert fa.plan(128, 128) == (128, 128, fa.BLOCK_Q)
    assert fa.plan(80, 80) == (96, 96, fa.BLOCK_Q)
    assert fa.plan(48, 32) == (64, 32, fa.BLOCK_Q)
    assert fa.plan(192, 128) == (192, 128, fa.BLOCK_Q_MLA)
    assert fa.plan(40, 72) == (192, 128, fa.BLOCK_Q_MLA)
    assert fa.BLOCK_Q == 64 and fa.BLOCK_Q_MLA == 128
    q = torch.empty((1, 2, 8, 200), device="meta")
    v = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError):
        fa.attend(q, q, v, torch.empty((1, 2, 8, 64), device="meta"))
    with pytest.raises(ValueError):     # out sized like q, not like v
        fa.attend(q[..., :64], q[..., :64], v[..., :32],
                  torch.empty((1, 2, 8, 64)))


# ------------------------------------------------------------------ AdamW --

def test_adam_donate_is_bitwise_the_copying_update(rng, monkeypatch):
    """``adam.apply(donate=True)`` updates params and moments in place, and
    its values equal ``donate=False``'s bit for bit: over leaves within one
    slice, gradient clipping on; and, with slices of 4096 elements, over
    leaves larger than a slice (a stacked expert leaf, one expert a slice,
    and a 2-D leaf whose rows are grouped), a 1-D leaf and a bf16 leaf,
    where the sliced norm sums in another order, so the clip is set above
    it and the norms agree to f32 rounding.  ``donate=False`` leaves its
    inputs untouched."""
    def tree(dt_big):
        return {"experts": torch.from_numpy(
                    rng.standard_normal((1, 3, 2048, 2))
                    .astype(np.float32)).to(dt_big),
                "embed": torch.from_numpy(
                    rng.standard_normal((300, 40)).astype(np.float32)),
                "norm": torch.from_numpy(
                    rng.standard_normal((64,)).astype(np.float32))}

    def check(cfg, sliced):
        params = tree(torch.bfloat16)
        grads = tree(torch.bfloat16)
        state = adam.init(params, cfg)
        state = state._replace(
            mu=T.map_tree(lambda t: torch.randn_like(t) * 1e-3, state.mu),
            nu=T.map_tree(lambda t: torch.rand_like(t) * 1e-6, state.nu))
        n = 3 if sliced else 1
        assert len(adam._slices(params["experts"])) == n
        assert len(adam._slices(params["embed"])) == n
        before = [t.clone() for t in T.leaves(params) + T.leaves(state.mu)]
        p1, s1, m1 = adam.apply(params, grads, state, cfg)
        for a, b in zip(before, T.leaves(params) + T.leaves(state.mu)):
            assert torch.equal(a, b)
        keep = {"p": T.leaves(params), "mu": T.leaves(state.mu),
                "nu": T.leaves(state.nu)}
        p2, s2, m2 = adam.apply(params, grads, state, cfg, donate=True)
        g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
        assert abs(g1 - g2) <= 1e-6 * g1 if sliced else g1 == g2
        for a, b in zip(T.leaves(p1) + T.leaves(s1.mu) + T.leaves(s1.nu),
                        T.leaves(p2) + T.leaves(s2.mu) + T.leaves(s2.nu)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for mine, kept in zip(
                T.leaves(p2) + T.leaves(s2.mu) + T.leaves(s2.nu),
                keep["p"] + keep["mu"] + keep["nu"]):
            assert mine is kept
        assert int(s2.step) == int(s1.step) == 1

    check(adam.AdamConfig(warmup_steps=1, total_steps=4), sliced=False)
    monkeypatch.setattr(adam, "SLICE", 4096)
    check(adam.AdamConfig(warmup_steps=1, total_steps=4, grad_clip=1e9),
          sliced=True)


# ----------------------------------------------------------- model level --

def test_loss_fn_value_and_grads_match_reference(ref):
    """``loss_fn`` (cross-entropy plus the layers' aux loss) and its
    parameter gradients against ``jax.value_and_grad`` of the reference's
    unrolled ``loss_fn``: 1e-5 on the loss and the aux loss, 1e-4 relative
    per gradient leaf."""
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
    assert abs(float(met["aux_loss"]) - float(jmet["aux_loss"])) \
        <= 1e-5 * float(jmet["aux_loss"])
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - 5
    assert _worst_rel(jgrads, grads) <= REL_TOL


@pytest.mark.parametrize("P", [7, 20])
def test_prefill_and_decode_match_reference(ref, P, rng):
    """Prefill of a P-token prompt and two decode steps on its latent cache
    (each side routes the same tokens together): logits and the ckv/kpe
    cache within 1e-5 of their largest value."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, P + 2)).astype(np.int32)
    jlg, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P])})
    lg, c = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :P])})
    _close(lg, jlg)
    assert set(c) == {"pos", "ckv", "kpe"}
    assert int(c["pos"]) == int(jc["pos"]) == P
    for t in (P, P + 1):
        for nm in ("ckv", "kpe"):
            _close(c[nm], jc[nm])
        # the cache holds P slots: both sides write slot pos % P (a ring)
        jlg, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)
    assert int(c["pos"]) == P + 2


def test_decode_token_by_token_equals_prefill(ref, rng):
    """Token-by-token decoding through the absorbed path reaches one
    prefill's last logits and latent cache (capacity factor 32, so that
    no expert drops a token in either composition)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              capacity_factor=32.0)
    p = from_jax_params(ref["init"][0], "cpu")
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int64))
    lg, c = M.prefill(cfg, p, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 12, device="cpu")
    assert tuple(cache["ckv"].shape) == (cfg.n_layers, 2, 12,
                                         cfg.kv_lora_rank)
    for t in range(12):
        lg1, cache = M.decode_step(cfg, p, cache, toks[:, t:t + 1])
    _close(lg1, lg.numpy())
    for nm in ("ckv", "kpe"):
        _close(cache[nm], c[nm].numpy())


# ------------------------------------------------------------- fleet step --

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
    reports, aux = [], []
    for step in range(N_STEPS):
        batch = {k: torch.as_tensor(v) for k, v in data.batch(step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT, donate=True)
        reports.append(met["fleet"])
        aux.append(float(met["aux_loss"]))
    return cfg, rt, params, opt, reports, aux


def test_fleet_step_matches_reference(ref):
    """Three donated fleet steps, device 3 failing at GEMM 25 (in the
    backward) of step 1: loss (with the aux loss), aux loss, grad_norm and
    both moments within 1e-4 (max-relative per leaf) of the reference's
    fleet run (numpy executor), params within 1e-4 in L2 per leaf, the
    same GEMM shapes, task and recovery counts (66 fleet GEMMs a step),
    every step verified.  Every MLA projection runs on the fleet at the
    reference's shapes; the attention and the routed experts stay on the
    PS.  The same run under the bf16 policy must fail the params bound."""
    cfg, rt, params, opt, reports, aux = _fleet_run(ref)
    d, T_ = cfg.d_model, B * S
    H, hd, rd, r, vd = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                        cfg.kv_lora_rank, cfg.v_dim)
    for got, want, a, ja in zip(reports, ref["steps"], aux, ref["aux"]):
        assert abs(got.loss - want.loss) <= REL_TOL * abs(want.loss)
        assert abs(a - ja) <= REL_TOL * abs(ja)
        assert abs(got.grad_norm - want.grad_norm) \
            <= REL_TOL * abs(want.grad_norm)
        assert got.n_gemms == want.n_gemms == 66
        assert (got.n_tasks, got.n_recovered) \
            == (want.n_tasks, want.n_recovered)
        assert got.verified and all(r_.verified for r_ in got.records)
        assert got.failed_ids == want.failed_ids
        assert got.predicted_makespan == pytest.approx(
            want.predicted_makespan, rel=1e-9)
        shapes = [(r_.kind, r_.m, r_.n, r_.q) for r_ in got.records]
        assert shapes == [(r_.kind, r_.m, r_.n, r_.q)
                          for r_ in want.records]
        mla = collections.Counter(
            ("fwd",) + mnq for mnq in (
                (T_, d, cfg.q_lora_rank),
                (T_, cfg.q_lora_rank, H * (hd + rd)), (T_, d, r + rd),
                (T_, r, H * hd), (T_, r, H * vd), (T_, H * vd, d)))
        fwd = collections.Counter(x for x in shapes if x[0] == "fwd")
        for mnq, n in mla.items():
            assert fwd[mnq] == n * cfg.n_layers, mnq
    assert ref["steps"][FAIL_STEP].n_recovered > 0
    assert FAIL_IDS[0] not in rt.fleet.ids()
    jparams, jopt = ref["final"]
    assert _l2_rel(jparams, params) <= REL_TOL
    assert _worst_rel(jopt.mu, opt.mu) <= REL_TOL
    assert _worst_rel(jopt.nu, opt.nu) <= REL_TOL
    control = _fleet_run(ref, dtype_policy="bf16")[2]
    assert _l2_rel(jparams, control) > REL_TOL


# --------------------------------------------------------- serving, drivers --

def test_latent_pools_and_int8_refusal():
    """The serving pools of an MLA config are the latent ``ckv`` (L, pages,
    page, r) and ``kpe`` (..., rd), as the reference's; int8 K/V pools
    raise the reference's ValueError."""
    cfg = get_config(ARCH).reduced()
    kv = PagedKVCache(cfg, n_pages=6, page_size=4, device="cpu")
    assert {k: tuple(v.shape) for k, v in kv.pools.items()} == {
        "ckv": (cfg.n_layers, 6, 4, cfg.kv_lora_rank),
        "kpe": (cfg.n_layers, 6, 4, cfg.rope_head_dim)}
    with pytest.raises(ValueError, match="MLA"):
        PagedKVCache(cfg, n_pages=6, page_size=4, kv_int8=True,
                     device="cpu")


def test_serve_session_matches_reference_with_failure(ref):
    """Fleet serving of the MLA model from the ckv/kpe pools against the
    reference's session on the same params, device 2 failing at step 1
    and the paged read asked for (both skip it for MLA): greedy tokens and
    every step's GEMM, task and recovery counts identical."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    kw = dict(slots=3, page_size=4, max_len=16, check_paged_read=True)
    jrt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(8, seed=0))
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    js = jrt.serve_session(jax.tree.map(jnp.asarray, ref["init"][0]), **kw)
    ts = rt.serve_session(from_jax_params(ref["init"][0], "cpu"), **kw)
    assert set(ts.kv.pools) == set(js.kv.pools) == {"ckv", "kpe"}
    rng = np.random.default_rng(1)
    for _ in range(3):
        prompt = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
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
    assert ts.paged_read_checks == js.paged_read_checks == 0


@pytest.mark.parametrize("backend", ["torch", "fleet"])
def test_train_driver_runs_mla_on_cpu(backend, tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "metrics.json"
    argv = ["--arch", ARCH, "--reduced", "--layers", "1", "--steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu", "--backend",
            backend, "--metrics-out", str(out)]
    if backend == "fleet":
        argv += ["--fail-step", "1", "--fail-ids", "3", "--fleet-devices",
                 "8"]
    assert train.main(argv) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    if backend == "fleet":
        assert all(r["fleet_verified"] for r in rows)
        assert rows[1]["fleet_recovered"] > 0


def test_serve_driver_runs_mla_on_cpu(capsys):
    """``launch/serve.py --arch deepseek-v2-236b`` prefills into the latent
    cache and decodes on the monolithic path, then serves the same
    prompts through the fleet session (``--edge-plan``)."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dk,Dv,H,S,window", [(48, 32, 4, 100, 0),
                                              (192, 128, 16, 128, 0),
                                              (192, 128, 8, 70, 24)])
def test_flash_kernel_dk_ne_dv_on_card(cuda, Dk, Dv, H, S, window, dtype):
    """B4 at MLA's head dims against its plain version: 1e-5 of the largest
    output in f32, one bf16 ulp of the largest output in bf16; two
    launches bit for bit."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, S, H, D), generator=gen, device=cuda).to(dt)
               for D in (Dk, Dk, Dv))
    n0 = fa.launches
    got = ops.mha_flash(q, k, v, causal=True, window=window)
    again = ops.mha_flash(q, k, v, causal=True, window=window)
    assert fa.launches == n0 + 2 and torch.equal(got, again)
    assert tuple(got.shape) == (2, S, H, Dv)
    want = fa._attend_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window,
                            q_offset=0).transpose(1, 2)
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = 1e-5 * big if dtype == "float32" \
        else 2.0 ** (math.floor(math.log2(big)) - 7)
    assert err <= tol
