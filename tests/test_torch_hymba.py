"""The port's hybrid family against the reference on ``hymba-1.5b.reduced()``
(f32: 2 layers, d 256, 4 heads over 4 KV heads of 32, d_inner 512, N 8, 8
meta tokens) and, where the grouped path matters, on
``reduced(n_heads=5, n_kv_heads=1)`` (G 5, full hymba's group count), fed
the same numpy inputs: the depthwise causal conv, the chunked selective
scan, the SSM block and its decode, attention over the meta-token prefix
in training and decode, ``loss_fn`` and every gradient, ``prefill`` and
``decode_step`` (the reference's prefill fault included), the pure-SSM
variant, the PS-centric fleet step over three steps with a device
failure, the serving session's refusal, the drivers, and (on the card)
the flash-attention and flash-decode kernels at hymba's shapes.  Both
sides compute in f32 and sum in different orders: 1e-5 of the largest
value for forward values, 1e-4 relative for gradients and the training
state (the reference's bars, ``tests/test_train_loop.py``)."""
import collections
import dataclasses
import functools
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
from repro.models import ssm as JS
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import from_jax_opt_state, from_jax_params
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.optim import adam
from repro_torch.serving.kv_cache import PagedKVCache

ARCH = "hymba-1.5b"
B, S = 2, 16
CHUNKS = dict(loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
REL_TOL = 1e-4
N_STEPS, FAIL_STEP, FAIL_IDS = 3, 1, (3,)
# 15 forward fleet GEMMs (7 a layer: q, k, v, o, gate, up, down; the LM
# head), then the backward: the failure strikes at its third
FAIL_AT = 17
# the reference's per-step fleet GEMMs by kind at B 2, S 16; the SSM's
# projections multiply with @ and stay on the PS
KINDS = {"fwd": 15, "dA": 15, "dW": 15}
GROUPED = dict(n_heads=5, n_kv_heads=1)


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


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _configs(**over):
    return jget_config(ARCH).reduced(**over), get_config(ARCH).reduced(**over)


def _jit(fn, jcfg):
    """``fn(jcfg, ...)`` of the reference, compiled once: the same values
    as its eager call, in a fraction of the time."""
    return jax.jit(functools.partial(fn, jcfg))


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
def grouped():
    """Params of ``reduced(n_heads=5, n_kv_heads=1)`` from the reference's
    init, on both sides (the grouped path, G 5)."""
    jcfg, cfg = _configs(**GROUPED)
    jp = _jit(JM.init_params, jcfg)(jax.random.PRNGKey(1))
    return jcfg, cfg, jp, from_jax_params(_np_tree(jp), "cpu")


def _both_layer(ref, *path, i=0):
    """Layer ``i``'s subtree ``path`` of the fixture's initial params on
    both sides."""
    node = ref["init"][0]["layers"]
    for k in path:
        node = node[k]
    sl = jax.tree.map(lambda t: np.asarray(t)[i], node)
    return jax.tree.map(jnp.asarray, sl), from_jax_params(sl, "cpu")


# ------------------------------------------------------------------- init --

def test_init_params_layout_matches_reference(ref):
    """``init_params`` draws the reference's tree (the SSM heads beside the
    attention with its meta tokens): same keys, shapes and dtypes, in f32
    and under a bf16 param dtype, where ``A_log`` and ``D`` stay f32 on
    both sides; the same init scales as the fixture's reference params,
    which ``from_jax_params`` carries over leaf for leaf."""
    for over in ({}, dict(dtype="bfloat16", param_dtype="bfloat16")):
        jcfg, cfg = _configs(**over)
        jshapes = jax.eval_shape(
            lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
        ours = M.init_params(cfg, torch.Generator().manual_seed(0))
        flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        assert len(flat_j) == len(T.leaves(ours))
        for path, leaf in flat_j:
            node = ours
            for q in path:
                node = node[q.key]
            assert tuple(node.shape) == tuple(leaf.shape), path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        lay = ours["layers"]
        assert {"attn", "ssm"} <= set(lay)
        assert tuple(lay["attn"]["meta_k"].shape) == (
            cfg.n_layers, cfg.n_meta_tokens, cfg.n_kv_heads, cfg.head_dim)
        for nm in ("A_log", "D"):
            assert lay["ssm"][nm].dtype == torch.float32
    jparams = ref["init"][0]
    carried = from_jax_params(jparams, "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node, got = ours, carried
        for q in path:
            node, got = node[q.key], got[q.key]
        np.testing.assert_array_equal(got.numpy(), leaf)
        want_std = float(np.std(leaf))
        assert abs(float(node.float().std()) - want_std) \
            <= 0.1 * want_std + 1e-6, path
    np.testing.assert_allclose(ours["layers"]["ssm"]["A_log"].numpy(),
                               jparams["layers"]["ssm"]["A_log"], rtol=1e-6)


def test_from_jax_params_keeps_ssm_leaves_f32(ref):
    """``from_jax_params(..., dtype=torch.bfloat16)`` of hymba's params
    keeps ``A_log`` and ``D`` in f32 (as the reference keeps them under a
    bf16 param dtype) and casts every other floating leaf."""
    got = from_jax_params(ref["init"][0], "cpu", dtype=torch.bfloat16)
    kept = 0
    for path, leaf in zip(T.paths(got), T.leaves(got)):
        if path[-1] in ("A_log", "D"):
            assert path[-2] == "ssm" and leaf.dtype == torch.float32, path
            kept += 1
        else:
            assert leaf.dtype == torch.bfloat16, path
    assert kept == 2
    np.testing.assert_array_equal(
        got["layers"]["ssm"]["A_log"].numpy(),
        ref["init"][0]["layers"]["ssm"]["A_log"])


# -------------------------------------------------------------------- SSM --

@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_reference(ref, with_state, rng):
    """The depthwise causal conv (its taps summed in the reference's
    order, then the bias) and the window it leaves, from zeros or from a
    carried state."""
    jp, p = _both_layer(ref, "ssm")
    K, di = p["conv"].shape
    p = dict(p, conv_b=torch.from_numpy(
        rng.standard_normal(di).astype(np.float32)))
    jp = dict(jp, conv_b=jnp.asarray(p["conv_b"].numpy()))
    u = rng.standard_normal((B, 7, di)).astype(np.float32)
    st = rng.standard_normal((B, K - 1, di)).astype(np.float32) \
        if with_state else None
    jo, js = JS._conv1d(jp, jnp.asarray(u),
                        None if st is None else jnp.asarray(st))
    o, s = SSM._conv1d(p, torch.from_numpy(u),
                       None if st is None else torch.from_numpy(st))
    _close(o, jo)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("with_c", [True, False])
@pytest.mark.parametrize("seq", [128, 48])
def test_ssm_scan_chunked_matches_reference(with_c, seq, rng):
    """The chunked associative scan at S = 128 (two chunks of 64, the carry
    across them) and at S = 48 (one chunk of 48, the reference's fallback
    when S is no multiple of the chunk), with C contracted inside each
    chunk or the whole trajectory, from a random incoming state: y (or
    the states) and h_last within 1e-5."""
    b_, di, N = 2, 12, 8
    a = rng.uniform(0.3, 1.0, (b_, seq, di, N)).astype(np.float32)
    bb = rng.standard_normal((b_, seq, di, N)).astype(np.float32)
    h0 = rng.standard_normal((b_, di, N)).astype(np.float32)
    cm = rng.standard_normal((b_, seq, N)).astype(np.float32) \
        if with_c else None
    jy, jh = JS.ssm_scan_chunked(jnp.asarray(a), jnp.asarray(bb),
                                 jnp.asarray(h0), 64,
                                 None if cm is None else jnp.asarray(cm))
    y, h = SSM.ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(bb),
                                torch.from_numpy(h0), 64,
                                None if cm is None else torch.from_numpy(cm))
    assert tuple(y.shape) == tuple(jy.shape)
    _close(y, jy)
    _close(h, jh)


def test_ssm_block_matches_reference(ref, rng):
    """``ssm_block`` at S = 16 in chunks of 8 and its gradients with
    respect to x and every SSM param (the scan recomputed chunk by chunk
    in the backward, the state's gradient carried back across the two
    chunks), against the reference under ``jax.grad``: 1e-5 forward, 1e-4
    relative per gradient leaf.  The one-chunk fallback runs in every
    model-level test (S = 16 < the default chunk of 64)."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp, p = _both_layer(ref, "ssm", i=1)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    gy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want, vjp = jax.jit(lambda x_, q: jax.vjp(
        lambda a, b: JS.ssm_block(jcfg, b, a, chunk=8), x_, q))(
        jnp.asarray(x), jp)
    jg = jax.jit(vjp)(jnp.asarray(gy))
    _close(SSM.ssm_block(cfg, p, torch.from_numpy(x), chunk=8), want)
    keys = T.paths(p)
    leaves = [t.clone().requires_grad_() for t in T.leaves(p)]
    tx = torch.from_numpy(x).requires_grad_()
    out = SSM.ssm_block(cfg, T.unflatten(keys, leaves), tx, chunk=8)
    (out * torch.from_numpy(gy)).sum().backward()
    assert _worst_rel(jg[0], {"x": tx.grad}) <= REL_TOL
    assert _worst_rel(jg[1], T.unflatten(keys, [t.grad for t in leaves])) \
        <= REL_TOL


def test_ssm_decode_matches_reference(ref, rng):
    """Three ``ssm_decode`` steps from a random state and conv window: the
    output, h and the window within 1e-5 of the reference's; and the same
    tokens through ``ssm_block`` from zeros end where decode from zeros
    ends."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp, p = _both_layer(ref, "ssm")
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    h = rng.standard_normal((B, di, N)).astype(np.float32)
    cs = rng.standard_normal((B, K - 1, di)).astype(np.float32)
    jh, jcs, th, tcs = jnp.asarray(h), jnp.asarray(cs), \
        torch.from_numpy(h), torch.from_numpy(cs)
    decode = _jit(JS.ssm_decode, jcfg)
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jh, jcs = decode(jp, jnp.asarray(x), jh, jcs)
        y, th, tcs = SSM.ssm_decode(cfg, p, torch.from_numpy(x), th, tcs)
        _close(y, jy)
        _close(th, jh)
        _close(tcs, jcs)
    xs = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    c = SSM.init_ssm_cache(cfg, B, device="cpu")
    with torch.no_grad():
        full = SSM.ssm_block(cfg, p, torch.from_numpy(xs))
        for t in range(5):
            y, c["h"], c["conv"] = SSM.ssm_decode(
                cfg, p, torch.from_numpy(xs[:, t:t + 1]), c["h"], c["conv"])
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------- meta tokens --

def _prefix_inputs(rng, Sq, Sk, H, K, D, P):
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, K, D)).astype(np.float32)
            for _ in range(2))
    pk, pv = (rng.standard_normal((P, K, D)).astype(np.float32)
              for _ in range(2))
    return q, k, v, pk, pv


@pytest.mark.parametrize("heads", [(4, 4), (5, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_with_prefix_matches_reference(heads, causal, rng):
    """Attention over an always-visible prefix of 8 keys at positions < 0
    (the meta tokens broadcast over the batch), at G 1 and G 5, causal
    with the queries shifted by a q_offset of 3 or bidirectional: output
    within 1e-5 of the reference's (its 4-row chunks), gradients with
    respect to q, k, v and the prefix's K/V within 1e-4."""
    H, K = heads
    P, D, Sq = 8, 32, 12
    q, k, v, pk, pv = _prefix_inputs(rng, Sq, Sq, H, K, D, P)
    gy = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    opts = dict(causal=causal, q_offset=3 if causal else 0, q_chunk=4,
                k_chunk=4)

    def jfn(q_, k_, v_, pk_, pv_):
        pre = tuple(jnp.broadcast_to(t[None], (B,) + t.shape)
                    for t in (pk_, pv_))
        return jnp.sum(JA.chunked_attention(q_, k_, v_, prefix_kv=pre,
                                            **opts) * gy)
    jargs = [jnp.asarray(t) for t in (q, k, v, pk, pv)]
    pre = tuple(jnp.broadcast_to(t[None], (B,) + t.shape)
                for t in jargs[3:])
    want = JA.chunked_attention(*jargs[:3], prefix_kv=pre, **opts)
    jg = jax.jit(jax.grad(jfn, argnums=(0, 1, 2, 3, 4)))(*jargs)
    targs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, pk, pv)]
    tpre = tuple(t[None].expand((B,) + tuple(t.shape)) for t in targs[3:])
    got = A.chunked_attention(*targs[:3], prefix_kv=tpre, **opts)
    _close(got, want)
    (got * torch.from_numpy(gy)).sum().backward()
    for w, t in zip(jg, targs):
        assert _worst_rel([w], {"g": t.grad}) <= REL_TOL


def test_prefix_with_window_raises(rng):
    """A meta-token prefix with a sliding window raises, naming A.7: the
    port's shifted mask would hide prefix keys the reference keeps."""
    q, k, v, pk, pv = (torch.from_numpy(t) for t in _prefix_inputs(
        rng, 6, 6, 4, 4, 32, 8))
    pre = tuple(t[None].expand((B,) + tuple(t.shape)) for t in (pk, pv))
    with pytest.raises(NotImplementedError, match="A.7"):
        A.chunked_attention(q, k, v, window=4, prefix_kv=pre)
    A.chunked_attention(q, k, v, window=4)
    A.chunked_attention(q, k, v, prefix_kv=pre)


@pytest.mark.parametrize("heads", [(4, 4), (5, 1)])
@pytest.mark.parametrize("per_request", [False, True])
def test_decode_attention_with_prefix_matches_reference(heads, per_request,
                                                        rng):
    """One token's attention over [8 meta tokens; a cache of 10] at G 1 and
    G 5, with a (Smax,) mask or a (B,Smax) per-request one: within 1e-5
    of the reference's (its roundings: q scaled and rounded to the cache
    dtype, the prefix's scores first)."""
    H, K = heads
    P, D, Smax = 8, 32, 10
    q, k, v, pk, pv = _prefix_inputs(rng, 1, Smax, H, K, D, P)
    valid = np.arange(Smax)[None, :] < np.array([[4], [9]]) \
        if per_request else np.arange(Smax) < 6
    jpre = tuple(jnp.broadcast_to(jnp.asarray(t)[None], (B,) + t.shape)
                 for t in (pk, pv))
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(valid), prefix_kv=jpre)
    tpre = tuple(torch.from_numpy(t)[None].expand((B,) + t.shape)
                 for t in (pk, pv))
    got = A.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(valid),
                             prefix_kv=tpre)
    _close(got, want)


def test_attention_block_and_decode_grouped_match_reference(grouped, rng):
    """``attention_block`` with the meta tokens at G 5 (its (k, v) for the
    cache without them) and ``attention_decode`` over them and a cache:
    within 1e-5 of the reference's."""
    jcfg, cfg, jp, p = grouped
    ja = jax.tree.map(lambda t: t[0], jp["layers"]["attn"])
    ta = T.map_tree(lambda t: t[0], p["layers"]["attn"])
    x = rng.standard_normal((B, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6)[None], (B, 6))
    jo, (jk, jv) = jax.jit(functools.partial(
        JA.attention_block, jcfg, q_chunk=2, k_chunk=2))(
        ja, jnp.asarray(x), jnp.asarray(pos))
    o, (k, v) = A.attention_block(cfg, ta, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), q_chunk=2,
                                  k_chunk=2)
    _close(o, jo)
    assert tuple(k.shape) == tuple(jk.shape) == (B, 6, 1, cfg.head_dim)
    _close(k, jk)
    _close(v, jv)
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = np.zeros((B, 8, 1, cfg.head_dim), np.float32)
    ck[:, :6] = np.asarray(jk)
    cv = np.zeros_like(ck)
    cv[:, :6] = np.asarray(jv)
    valid = np.arange(8) < 7
    jo, jnk, jnv = _jit(JA.attention_decode, jcfg)(
        ja, jnp.asarray(xd), jnp.asarray(6), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(6), jnp.asarray(valid))
    o, nk, nv = A.attention_decode(cfg, ta, torch.from_numpy(xd),
                                   torch.tensor(6), torch.from_numpy(ck),
                                   torch.from_numpy(cv), torch.tensor(6),
                                   torch.from_numpy(valid))
    _close(o, jo)
    _close(nk, jnk)
    _close(nv, jnv)


# ----------------------------------------------------------- model level --

def test_loss_fn_value_and_grads_match_reference(ref):
    """``loss_fn`` and the gradient of every leaf (``meta_k``, ``meta_v``,
    ``A_log`` and ``D`` included) against ``jax.value_and_grad`` of the
    reference's unrolled ``loss_fn``: 1e-5 on the loss, 1e-4 relative
    per leaf."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    raw = JSyntheticLM(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    raw["labels"][0, :5] = -1
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in raw.items()},
                             scan_layers=False, **CHUNKS),
        has_aux=True))(jax.tree.map(jnp.asarray, ref["init"][0]))
    (loss, met), grads = M.value_and_grad(
        cfg, from_jax_params(ref["init"][0], "cpu"),
        {k: torch.as_tensor(v) for k, v in raw.items()}, **CHUNKS)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - 5
    assert _worst_rel(jgrads, grads) <= REL_TOL
    for path in (("attn", "meta_k"), ("attn", "meta_v"), ("ssm", "A_log"),
                 ("ssm", "D")):
        w = jgrads["layers"][path[0]][path[1]]
        g = grads["layers"][path[0]][path[1]]
        assert float(np.abs(np.asarray(w)).max()) > 0
        assert _worst_rel([w], {"g": g}) <= REL_TOL, path


def test_prefill_then_decode_matches_reference_fault_included(ref, rng):
    """Prefill of a 5-token prompt then two decode steps, against the
    reference's: last logits, K/V and the SSM states within 1e-5.  The
    prefill leaves ``ssm_h`` and ``ssm_conv`` at zero, as the reference's
    does (ROADMAP C), so the first decode step disagrees with a forward
    over the same six tokens, on both sides alike."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    toks = rng.integers(0, cfg.vocab_size, (B, 7)).astype(np.int32)
    jlg, jc = _jit(JM.prefill, jcfg)(jp, {"tokens": jnp.asarray(toks[:, :5])})
    lg, c = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :5])})
    _close(lg, jlg)
    assert set(c) == set(jc) == {"pos", "k", "v", "ssm_h", "ssm_conv"}
    assert not c["ssm_h"].any() and not c["ssm_conv"].any()
    assert not np.asarray(jc["ssm_h"]).any()
    decode = _jit(JM.decode_step, jcfg)
    for t in (5, 6):
        jlg, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)
        for nm in ("k", "v", "ssm_h", "ssm_conv"):
            _close(c[nm], jc[nm])
    with torch.no_grad():
        x, _, _ = M.forward(cfg, p, {"tokens": torch.from_numpy(toks)})
        fwd = L.lm_logits(p["head"], p["embed"], x[:, -1:], cfg)
    V = cfg.vocab_size
    rel = float((lg[..., :V] - fwd[..., :V]).norm() / fwd[..., :V].norm())
    assert rel > 1e-2


def test_decode_matches_forward(ref, rng):
    """The reference's ``test_decode_matches_forward`` contract:
    token-by-token decoding from an empty cache (the SSM state carried
    step to step) gives the full forward's logits at every position
    (1e-3 / 1e-4, as there)."""
    cfg = get_config(ARCH).reduced()
    p = from_jax_params(ref["init"][0], "cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int64))
    with torch.no_grad():
        x, _, _ = M.forward(cfg, p, {"tokens": toks})
        want = L.lm_logits(p["head"], p["embed"], x, cfg)[..., :cfg.vocab_size]
        cache = M.init_cache(cfg, 2, 8, device="cpu")
        got = []
        for t in range(8):
            lg, cache = M.decode_step(cfg, p, cache, toks[:, t:t + 1])
            got.append(lg[:, 0, :cfg.vocab_size])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_grouped_forward_and_decode_match_reference(grouped, rng):
    """At G 5 the whole model: ``prefill`` over 6 tokens and one decode
    step against the reference's (logits and caches within 1e-5)."""
    jcfg, cfg, jp, p = grouped
    toks = rng.integers(0, cfg.vocab_size, (B, 7)).astype(np.int32)
    jlg, jc = _jit(JM.prefill, jcfg)(jp, {"tokens": jnp.asarray(toks[:, :6])})
    lg, c = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :6])})
    _close(lg, jlg)
    jlg, jc = _jit(JM.decode_step, jcfg)(jp, jc, jnp.asarray(toks[:, 6:]))
    lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, 6:]))
    _close(lg, jlg)
    for nm in ("k", "v", "ssm_h", "ssm_conv"):
        _close(c[nm], jc[nm])


def test_pure_ssm_variant_matches_reference(rng):
    """The attention-free branch (no attention, no meta tokens, the SSM
    alone): forward logits and token-by-token decode (cache keys ``pos``,
    ``ssm_conv``, ``ssm_h``) against the reference's."""
    over = dict(hybrid_parallel=False, attn_free=True, n_meta_tokens=0)
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), **over)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **over)
    jp = _jit(JM.init_params, jcfg)(jax.random.PRNGKey(2))
    p = from_jax_params(_np_tree(jp), "cpu")
    assert "attn" not in p["layers"] and "ssm" in p["layers"]
    toks = rng.integers(0, cfg.vocab_size, (B, 5)).astype(np.int32)
    jx, _, _ = _jit(JM.forward, jcfg)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        x, _, kv = M.forward(cfg, p, {"tokens": torch.from_numpy(toks)},
                             collect_kv=True)
    _close(x, jx)
    assert kv == ()
    jc = JM.init_cache(jcfg, B, 5)
    c = M.init_cache(cfg, B, 5, device="cpu")
    assert set(c) == set(jc) == {"pos", "ssm_h", "ssm_conv"}
    decode = _jit(JM.decode_step, jcfg)
    for t in range(3):
        jlg, jc = decode(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)
    _close(c["ssm_h"], jc["ssm_h"])


# ------------------------------------------------------------- fleet step --

def _l2_rel(want, got):
    """Per leaf, the L2 norm of the difference over the leaf's L2 norm."""
    return max(float(np.linalg.norm(np.asarray(a, np.float32)
                                    - b.float().numpy())
                     / (np.linalg.norm(np.asarray(a, np.float32)) + 1e-12))
               for a, b in zip(jax.tree.leaves(want), T.leaves(got)))


def test_fleet_step_matches_reference(ref):
    """Three fleet steps, device 3 failing at GEMM 17 (the backward's
    third) of step 1: loss, grad_norm and both moments within 1e-4
    (max-relative per leaf) of the reference's fleet run (numpy
    executor), params within 1e-4 in L2 per leaf; the reference's 45
    GEMMs a step, fwd 15, dA 15, dW 15 in its order (the SSM's
    projections on the PS); task and recovery counts and predicted
    makespans equal; every step verified.  The params are held in L2, as
    the RWKV, MoE and MLA slices hold theirs, because AdamW moves an
    element whose gradient lies within f32 rounding of zero by up to lr
    whichever way its sign falls: ``ssm.conv_b``, zeros at init, reads
    1.02e-4 max-relative after 3 steps on summation order alone (every
    other leaf under 4.3e-5; PERF.md §2)."""
    cfg = get_config(ARCH).reduced()
    params = from_jax_params(ref["init"][0], "cpu")
    opt = from_jax_opt_state(ref["init"][1], "cpu")
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    with pytest.warns(UserWarning, match="PS-locally"):
        sess = rt.train_session(adam.AdamConfig(**OPT), **CHUNKS)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    for step, want in enumerate(ref["steps"]):
        batch = {k: torch.as_tensor(v) for k, v in data.batch(step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT)
        got = met["fleet"]
        assert abs(got.loss - want.loss) <= REL_TOL * abs(want.loss)
        assert abs(got.grad_norm - want.grad_norm) \
            <= REL_TOL * abs(want.grad_norm)
        assert got.n_gemms == want.n_gemms == sum(KINDS.values())
        for rep in (got, want):
            assert collections.Counter(r.kind for r in rep.records) == KINDS
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
    assert _l2_rel(jparams, params) <= REL_TOL
    assert _worst_rel(jopt.mu, opt.mu) <= REL_TOL
    assert _worst_rel(jopt.nu, opt.nu) <= REL_TOL


# --------------------------------------------------------- serving, drivers --

def test_serve_session_raises_for_hybrid():
    """As the reference's: SSM and hybrid states are not paged, so the
    serving session and its page pools raise the same ValueError."""
    jcfg, cfg = _configs()
    jrt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(4, seed=0))
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(4, seed=0),
                            device="cpu")
    with pytest.raises(ValueError, match="not paged") as want:
        jrt.serve_session(slots=2, page_size=4, max_len=8)
    with pytest.raises(ValueError, match="not paged") as got:
        rt.serve_session(slots=2, page_size=4, max_len=8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="recurrent"):
        PagedKVCache(cfg, n_pages=4, page_size=4, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "fleet"])
def test_train_driver_runs_hymba_on_cpu(backend, tmp_path):
    """``launch/train.py --arch hymba-1.5b``, both backends, a failure on
    the fleet (45 fleet GEMMs a step at B 2, S 16)."""
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
        assert all(r["fleet_gemms"] == sum(KINDS.values()) for r in rows)
        assert rows[1]["fleet_recovered"] > 0


def test_serve_driver_runs_hymba_on_cpu(capsys):
    """``launch/serve.py --arch hymba-1.5b`` prefills and decodes on the
    monolithic path (the reference driver's cache: K/V from the prefill,
    the SSM state from zeros); ``--edge-plan`` raises the session's
    ValueError."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen", "4"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "req1:" in out
    with pytest.raises(ValueError, match="not paged"):
        serve.main(argv + ["--edge-plan", "4"])


# ------------------------------------------------------------- on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(128, 256), (16, 144)])
def test_flash_kernel_hymba_shapes_on_card(cuda, Sq, Sk, dtype):
    """B4 at hymba's shapes (25 heads over 5, D 64, causal, 128 meta keys
    before the sequence, so q_offset 128): the training step's and a
    16-token prefill's, against its plain version: 1e-5 of the largest
    output in f32, one bf16 ulp in bf16; two launches bit for bit."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    H, K, D, P = 25, 5, 64, Sk - Sq
    q = torch.randn((2, Sq, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((2, Sk, K, D), generator=gen, device=cuda).to(dt)
            for _ in range(2))
    n0 = fa.launches
    got = ops.mha_flash(q, k, v, causal=True, q_offset=P)
    again = ops.mha_flash(q, k, v, causal=True, q_offset=P)
    assert fa.launches == n0 + 2 and torch.equal(got, again)
    want = fa._attend_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=0,
                            q_offset=P).transpose(1, 2)
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = 1e-5 * big if dtype == "float32" \
        else 2.0 ** (math.floor(math.log2(big)) - 7)
    assert err <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_request", [False, True])
def test_flash_decode_meta_prefix_on_card(cuda, per_request, dtype):
    """B5 through ``attention.decode_attention`` over [128 meta tokens; a
    cache of 32] at G 5 (25 heads over 5, D 64), with a (Smax,) or a
    (B,Smax) mask: one launch, against its plain version over the same
    concatenation (2e-4 in f32, one bf16 ulp of the largest output in
    bf16) and, in f32, against the plain body's prefix path (the
    reference's roundings, 2e-4)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    Bq, H, K, D, P, Smax = 4, 25, 5, 64, 128, 32
    q = torch.randn((Bq, 1, H, D), generator=gen, device=cuda)
    k, v = (torch.randn((Bq, Smax, K, D), generator=gen, device=cuda).to(dt)
            for _ in range(2))
    pk, pv = (torch.randn((P, K, D), generator=gen, device=cuda).to(dt)
              [None].expand(Bq, P, K, D) for _ in range(2))
    ln = torch.tensor([17, 18, 19, 24], device=cuda)
    valid = torch.arange(Smax, device=cuda)[None, :] < ln[:, None] \
        if per_request else torch.arange(Smax, device=cuda) < 20
    n0 = dec.flash_decode_launches
    got = A.decode_attention(q, k, v, valid, prefix_kv=(pk, pv))
    assert dec.flash_decode_launches == n0 + 1
    seen = torch.ones(valid.shape[:-1] + (P,), dtype=torch.bool,
                      device=cuda)
    want = dec.flash_decode_plain(q, torch.cat([pk, k], 1),
                                  torch.cat([pv, v], 1),
                                  torch.cat([seen, valid], -1))
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = 2e-4 * max(big, 1.0) if dtype == "float32" \
        else 2.0 ** (math.floor(math.log2(big)) - 7)
    assert err <= tol
    if dtype == "float32":
        body = A.decode_attention_plain(q, k, v, valid, prefix_kv=(pk, pv))
        assert float((got - body).abs().max()) <= tol
