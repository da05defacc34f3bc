"""The port's encoder-decoder family against the reference on
``seamless-m4t-medium.reduced()`` (f32: 2 encoder and 2 decoder layers, d
256, 4 heads of 32, d_ff 1024), fed the same numpy inputs: layernorm, the
encoder and its per-layer recompute, the cross-attention sublayer in
training and decode, the cross K/V cache, ``loss_fn`` and its gradients,
``prefill`` and ``decode_step``, the PS-centric fleet step over three
steps with a device failure, the serving session's refusal, the drivers,
and (on the card) the flash-attention and flash-decode kernels at the
family's shapes.  Both sides compute in f32 and sum in different orders:
1e-5 of the largest value for forward values, 1e-4 relative for
gradients and the training state (the reference's bars,
``tests/test_train_loop.py``)."""
import collections
import json
import math
import threading

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
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adam as jadam
from repro_torch import tree as T
from repro_torch.api import Fleet, TorchCleaveRuntime
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, modality_stubs
from repro_torch.interop import from_jax_opt_state, from_jax_params
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.train_loop import hook as gemm_hook

ARCH = "seamless-m4t-medium"
B, S = 2, 16
CHUNKS = dict(loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
REL_TOL = 1e-4
N_STEPS, FAIL_STEP, FAIL_IDS = 3, 1, (3,)
# 41 forward fleet GEMMs (7 a layer of the encoder; 13 a decoder layer:
# self q, k, v, o, cross k, v over the encoder output, q and the
# discarded k, v of the decoder stream, o, gate, up, down; the LM head),
# then the decoder's backward: GEMM 45 is the decoder's FFN dA
FAIL_AT = 45
# the reference's per-step GEMMs by kind at B 2, S 16: the 12 forward
# GEMMs of the encoder's recompute, and the 4 discarded projections with
# no backward
KINDS = {"fwd": 53, "dA": 37, "dW": 37}
# records up to here come in the reference's order; after it, within an
# encoder layer's backward, XLA's schedule and autograd's differ
ORDERED = 87


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


def _batch(data, step):
    raw = data.batch(step)
    raw.update(modality_stubs(get_config(ARCH).reduced(), B, S, step))
    return raw


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet run (numpy executor) over ``N_STEPS`` steps,
    devices ``FAIL_IDS`` failing at GEMM ``FAIL_AT`` of step ``FAIL_STEP``,
    on batches with 2 * S encoder frames; its initial and final states as
    numpy trees and its step reports."""
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


def _both(ref, *path):
    """A subtree of the fixture's initial params on both sides."""
    node = ref["init"][0]
    for k in path:
        node = node[k]
    return jax.tree.map(jnp.asarray, node), from_jax_params(node, "cpu")


def _slice(tree, i):
    return jax.tree.map(lambda t: t[i], tree)


# ------------------------------------------------------------------- init --

def test_init_params_layout_matches_reference():
    """``init_params`` draws the reference's tree, the encoder (layers
    stacked over n_enc_layers, final norm) and the decoder's cross
    sublayers (stacked over n_layers) included: same keys, shapes, dtypes
    and init scales, and ``from_jax_params`` carries it over leaf for
    leaf."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
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
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
        want_std = float(np.std(np.asarray(leaf)))
        assert abs(float(node.float().std()) - want_std) \
            <= 0.1 * want_std + 1e-6, path
    assert ours["encoder"]["layers"]["mlp"]["w_down"].shape \
        == (cfg.n_enc_layers, cfg.d_ff, cfg.d_model)
    assert set(ours["cross"]) == {"ln", "attn"}


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype, rng):
    """``layernorm`` with a random scale and bias (f32 inside, the output
    in x's type) within 1e-5 of the reference's; ``init_layernorm``'s
    ones and zeros."""
    d = 48
    x = (rng.standard_normal((3, 5, d)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(d).astype(np.float32),
         "bias": rng.standard_normal(d).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, tx)
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want.astype(jnp.float32)),
           tol=1e-5 if dtype == "float32" else 2.0 ** -7)
    init = L.init_layernorm(d, torch.float32, "cpu", lead=(2,))
    jinit = JL.init_layernorm(d, jnp.float32)
    assert tuple(init["scale"].shape) == (2, d)
    np.testing.assert_array_equal(init["scale"][0].numpy(),
                                  np.asarray(jinit["scale"]))
    np.testing.assert_array_equal(init["bias"][0].numpy(),
                                  np.asarray(jinit["bias"]))


# ---------------------------------------------------------------- encoder --

def test_encode_matches_reference(ref, rng):
    """The bidirectional encoder over 2 * S frames and its gradients with
    respect to the frames and every encoder param, against the
    reference's ``encode`` under ``jax.grad`` (its layers remat'd): 1e-5
    forward, 1e-4 relative per gradient leaf."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp, p = _both(ref, "encoder")
    feats = rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32)
    want = JED.encode(jcfg, jp, jnp.asarray(feats))
    _close(ED.encode(cfg, p, torch.from_numpy(feats)), want)
    jg = jax.grad(lambda f, q: jnp.sum(JED.encode(jcfg, q, f) * gy),
                  argnums=(0, 1))(jnp.asarray(feats), jp)
    keys = T.paths(p)
    leaves = [t.clone().requires_grad_() for t in T.leaves(p)]
    tf = torch.from_numpy(feats).requires_grad_()
    out = ED.encode(cfg, T.unflatten(keys, leaves), tf)
    (out * torch.from_numpy(gy)).sum().backward()
    assert _worst_rel(jg[0], {"f": tf.grad}) <= REL_TOL
    assert _worst_rel(jg[1], T.unflatten(keys, [t.grad for t in leaves])) \
        <= REL_TOL


@pytest.mark.parametrize("thread", [False, True])
def test_encoder_recompute_runs_six_projections(ref, thread, rng):
    """Under a projection hook, the encoder's forward runs 7 GEMMs a layer
    and its backward re-runs q, k, v, o, gate and up (6 a layer, not
    ``down``), through the hook the forward ran under, also when the
    backward runs on another thread, where the hook is not installed (as
    autograd's device thread on the card)."""
    cfg = get_config(ARCH).reduced()
    _, p = _both(ref, "encoder")
    calls = []

    def hook(x, w):
        calls.append(tuple(w.shape))
        return L.matmul(x, w)

    keys = T.paths(p)
    leaves = [t.clone().requires_grad_() for t in T.leaves(p)]
    feats = torch.from_numpy(
        rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32))
    with gemm_hook.use_hook(hook):
        out = ED.encode(cfg, T.unflatten(keys, leaves), feats)
        n_fwd = len(calls)
        if not thread:
            out.sum().backward()
    if thread:
        worker = threading.Thread(target=lambda: out.sum().backward())
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
    assert n_fwd == 7 * cfg.n_enc_layers
    d, f, hq = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    n = cfg.n_enc_layers
    assert collections.Counter(calls[n_fwd:]) == collections.Counter(
        {(d, hq): 3 * n, (hq, d): n, (d, f): 2 * n})
    assert all(t.grad is not None for t in leaves)


# ------------------------------------------------------------------ cross --

def test_cross_layer_matches_reference(ref, rng):
    """The training cross-attention sublayer (non-causal, Sk = 2 Sq) and
    its gradients with respect to the decoder stream, the encoder output
    and every cross param, against the reference: 1e-5 forward, 1e-4
    relative per gradient."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jc, c = _both(ref, "cross")
    jc, c = _slice(jc, 0), T.map_tree(lambda t: t[0], c)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    want = JED.cross_layer(jcfg, jc, jnp.asarray(x), jnp.asarray(enc),
                           q_chunk=8, k_chunk=8)
    _close(ED.cross_layer(cfg, c, torch.from_numpy(x), torch.from_numpy(enc),
                          q_chunk=8, k_chunk=8), want)
    jg = jax.grad(lambda x_, e_, q: jnp.sum(JED.cross_layer(
        jcfg, q, x_, e_, q_chunk=8, k_chunk=8) * gy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(enc), jc)
    keys = T.paths(c)
    leaves = [t.clone().requires_grad_() for t in T.leaves(c)]
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(enc).requires_grad_()
    out = ED.cross_layer(cfg, T.unflatten(keys, leaves), tx, te, q_chunk=8,
                         k_chunk=8)
    (out * torch.from_numpy(gy)).sum().backward()
    assert _worst_rel(jg[0], {"x": tx.grad}) <= REL_TOL
    assert _worst_rel(jg[1], {"e": te.grad}) <= REL_TOL
    # the discarded k/v projections of the decoder stream take no grad
    grads = T.unflatten(keys, [t.grad for t in leaves])
    assert _worst_rel(jg[2], grads) <= REL_TOL


def test_cross_layer_decode_matches_reference(ref, rng):
    """One decode token's cross-attention over an all-valid encoder cache
    of 2 S slots: within 1e-5 of the reference."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jc, c = _both(ref, "cross")
    jc, c = _slice(jc, 1), T.map_tree(lambda t: t[1], c)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, 2 * S, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, 2 * S, K, hd)).astype(np.float32)
    want = JED.cross_layer_decode(jcfg, jc, jnp.asarray(x),
                                  (jnp.asarray(ck), jnp.asarray(cv)))
    got = ED.cross_layer_decode(cfg, c, torch.from_numpy(x),
                                (torch.from_numpy(ck), torch.from_numpy(cv)))
    _close(got, want)


def test_prepare_cross_cache_matches_reference(ref, rng):
    """Each decoder layer's cross K/V from the encoder output, stacked
    (L, B, 2S, K, hd), and ``project_cross_kv`` alone."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    feats = rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32)
    jk, jv = JED.prepare_cross_cache(jcfg, jp, jnp.asarray(feats))
    k, v = ED.prepare_cross_cache(cfg, p, torch.from_numpy(feats))
    assert tuple(k.shape) == (cfg.n_layers, B, 2 * S, cfg.n_kv_heads,
                              cfg.head_dim)
    _close(k, jk)
    _close(v, jv)
    enc = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    ja = _slice(jp["cross"]["attn"], 0)
    for g, w in zip(A.project_cross_kv(cfg, T.map_tree(lambda t: t[0],
                                                       p["cross"]["attn"]),
                                       torch.from_numpy(enc)),
                    JA.project_cross_kv(jcfg, ja, jnp.asarray(enc))):
        _close(g, w)


# ----------------------------------------------------------- model level --

def test_loss_fn_value_and_grads_match_reference(ref):
    """``loss_fn`` over a batch with 2 S encoder frames and its gradients
    (encoder, decoder and cross params) against ``jax.value_and_grad`` of
    the reference's unrolled ``loss_fn``: 1e-5 on the loss, 1e-4 relative
    per gradient leaf."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    raw = _batch(JSyntheticLM(JDataConfig(
        vocab_size=jcfg.vocab_size, seq_len=S, global_batch=B, seed=0)), 0)
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


def test_prefill_and_decode_match_reference(ref, rng):
    """Prefill of a 12-token prompt over 2 S encoder frames (its cross
    cache empty, as the reference's), then two decode steps against the
    prepared cross cache: logits and the self K/V within 1e-5."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    P = 12
    toks = rng.integers(0, cfg.vocab_size, (B, P + 2)).astype(np.int32)
    feats = rng.standard_normal((B, 2 * S, cfg.d_model)).astype(np.float32)
    jlg, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :P]),
                                    "encoder_feats": jnp.asarray(feats)})
    lg, c = M.prefill(cfg, p, {"tokens": torch.from_numpy(toks[:, :P]),
                               "encoder_feats": torch.from_numpy(feats)})
    _close(lg, jlg)
    assert set(c) == set(jc) == {"pos", "k", "v", "cross_k", "cross_v"}
    assert tuple(c["cross_k"].shape) == tuple(jc["cross_k"].shape) \
        == (cfg.n_layers, B, 0, cfg.n_kv_heads, cfg.head_dim)
    jk, jv = JED.prepare_cross_cache(jcfg, jp, jnp.asarray(feats))
    jc = dict(jc, cross_k=jk, cross_v=jv)
    c = dict(c, **dict(zip(("cross_k", "cross_v"), ED.prepare_cross_cache(
        cfg, p, torch.from_numpy(feats)))))
    _close(c["cross_k"], jk)
    ck = c["cross_k"]
    for t in (P, P + 1):
        for nm in ("k", "v"):
            _close(c[nm], jc[nm])
        jlg, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)
        assert c["cross_k"] is ck          # read-only in decode


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_cache_matches_reference_serving(ref, kv_quant, rng):
    """``encdec.decode_cache`` against the reference driver's serving
    set-up (``launch/serve.py``: a prefill over 2 P encoder frames, the
    cross K/V from ``prepare_cross_cache``, the prompt's self K/V and
    position; with int8 K/V, an empty cache at position 0 that the prompt
    is fed into token by token), then two greedy decode steps: logits and
    caches within 1e-5."""
    jcfg = ref["jcfg"]
    cfg = get_config(ARCH).reduced()
    jp = jax.tree.map(jnp.asarray, ref["init"][0])
    p = from_jax_params(ref["init"][0], "cpu")
    P, G = 6, 3
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feats = rng.standard_normal((B, 2 * P, cfg.d_model)).astype(np.float32)
    jlg, jpre = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks),
                                      "encoder_feats": jnp.asarray(feats)})
    jc = JM.init_cache(jcfg, B, P + G, enc_len=2 * P, kv_quant=kv_quant)
    jc["cross_k"], jc["cross_v"] = JED.prepare_cross_cache(
        jcfg, jp, jnp.asarray(feats))
    if not kv_quant:
        for nm in ("k", "v"):
            jc[nm] = jc[nm].at[:, :, :P].set(jpre[nm])
        jc["pos"] = jpre["pos"]
    tt = torch.from_numpy(toks)
    lg, c = ED.decode_cache(cfg, p, tt, torch.from_numpy(feats), P + G,
                            kv_quant=kv_quant)
    _close(lg, jlg)
    assert set(c) == set(jc)
    assert int(c["pos"]) == int(jc["pos"]) == (0 if kv_quant else P)
    if kv_quant:
        assert c["k"].dtype == torch.int8
        for t in range(P):
            jlg, jc = JM.decode_step(jcfg, jp, jc,
                                     jnp.asarray(toks[:, t:t + 1]))
            lg, c = M.decode_step(cfg, p, c, tt[:, t:t + 1])
        _close(lg, jlg)
    for _ in range(G - 1):
        tok = np.asarray(jlg[:, -1:, :cfg.vocab_size]).argmax(-1)
        assert np.array_equal(lg[:, -1:, :cfg.vocab_size].argmax(-1).numpy(),
                              tok)
        jlg, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok, jnp.int32))
        lg, c = M.decode_step(cfg, p, c, torch.from_numpy(tok))
        _close(lg, jlg)
    for nm in jc:
        if nm != "pos":
            _close(c[nm], np.asarray(jc[nm]).astype(np.float32))


def test_decode_matches_forward(ref, rng):
    """The reference's ``test_decode_matches_forward`` contract:
    token-by-token decoding from an empty cache with the cross K/V
    prepared gives the full forward's logits at every position (1e-3 /
    1e-4, as there)."""
    cfg = get_config(ARCH).reduced()
    p = from_jax_params(ref["init"][0], "cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                            .astype(np.int64))
    feats = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                             .astype(np.float32))
    with torch.no_grad():
        x, _, _ = M.forward(cfg, p, {"tokens": toks,
                                     "encoder_feats": feats})
        want = L.lm_logits(p["head"], p["embed"], x, cfg)[..., :cfg.vocab_size]
        cache = M.init_cache(cfg, 2, 8, enc_len=16, device="cpu")
        cache["cross_k"], cache["cross_v"] = ED.prepare_cross_cache(
            cfg, p, feats)
        got = []
        for t in range(8):
            lg, cache = M.decode_step(cfg, p, cache, toks[:, t:t + 1])
            got.append(lg[:, 0, :cfg.vocab_size])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------- fleet step --

def test_fleet_step_matches_reference(ref):
    """Three donated fleet steps over batches with 2 S encoder frames,
    device 3 failing at GEMM 45 (the decoder's backward) of step 1: loss,
    grad_norm, params and both moments within 1e-4 (max-relative per
    leaf) of the reference's fleet run (numpy executor); the reference's
    127 GEMMs a step, fwd 53 (the encoder's recompute and the discarded
    projections included), dA 37, dW 37, the first 87 in its order and
    the rest as the same set; task and recovery counts and predicted
    makespans equal; every step verified."""
    cfg = get_config(ARCH).reduced()
    params = from_jax_params(ref["init"][0], "cpu")
    opt = from_jax_opt_state(ref["init"][1], "cpu")
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    sess = rt.train_session(adam.AdamConfig(**OPT), **CHUNKS)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    for step, want in enumerate(ref["steps"]):
        batch = {k: torch.as_tensor(v) for k, v in _batch(data, step).items()}
        params, opt, met = sess.step(
            params, opt, batch,
            fail_ids=FAIL_IDS if step == FAIL_STEP else (),
            fail_at_gemm=FAIL_AT, donate=True)
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
        shapes = [(r.kind, r.m, r.n, r.q) for r in got.records]
        wshapes = [(r.kind, r.m, r.n, r.q) for r in want.records]
        assert shapes[:ORDERED] == wshapes[:ORDERED]
        assert collections.Counter(shapes) == collections.Counter(wshapes)
    assert ref["steps"][FAIL_STEP].n_recovered > 0
    assert FAIL_IDS[0] not in rt.fleet.ids()
    jparams, jopt = ref["final"]
    assert _worst_rel(jparams, params) <= REL_TOL
    assert _worst_rel(jopt.mu, opt.mu) <= REL_TOL
    assert _worst_rel(jopt.nu, opt.nu) <= REL_TOL


# --------------------------------------------------------- serving, drivers --

def test_serve_session_raises_for_encdec():
    """As the reference's: the encoder-decoder's states are not paged, so
    the serving session and its page pools raise the same ValueError."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jrt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(4, seed=0))
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(4, seed=0),
                            device="cpu")
    with pytest.raises(ValueError, match="enc-dec states are not paged") \
            as want:
        jrt.serve_session(slots=2, page_size=4, max_len=8)
    with pytest.raises(ValueError, match="enc-dec states are not paged") \
            as got:
        rt.serve_session(slots=2, page_size=4, max_len=8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="enc-dec"):
        PagedKVCache(cfg, n_pages=4, page_size=4, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "fleet"])
def test_train_driver_runs_encdec_on_cpu(backend, tmp_path):
    """``launch/train.py --arch seamless-m4t-medium`` with the driver's
    2 * seq encoder frames, both backends, a failure on the fleet."""
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


def test_serve_driver_runs_encdec_on_cpu(capsys):
    """``launch/serve.py --arch seamless-m4t-medium`` prefills over
    2 * prompt-len encoder frames and decodes against the prepared cross
    cache; ``--edge-plan`` raises the session's ValueError."""
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
@pytest.mark.parametrize("Sq,Sk,causal", [(128, 256, False),
                                          (256, 256, False),
                                          (128, 128, True), (15, 32, False)])
def test_flash_kernel_encdec_shapes_on_card(cuda, Sq, Sk, causal, dtype):
    """B4 at seamless-m4t-medium's shapes (16 heads, each its own kv head,
    D 64): cross-attention over 2x the keys, the bidirectional encoder,
    the decoder's causal self-attention, and a ragged prefill's
    cross-attention; against its plain version, 1e-5 of the largest output
    in f32, one bf16 ulp in bf16; two launches bit for bit."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    H, D = 16, 64
    q = torch.randn((2, Sq, H, D), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((2, Sk, H, D), generator=gen, device=cuda).to(dt)
            for _ in range(2))
    n0 = fa.launches
    got = ops.mha_flash(q, k, v, causal=causal)
    again = ops.mha_flash(q, k, v, causal=causal)
    assert fa.launches == n0 + 2 and torch.equal(got, again)
    want = fa._attend_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=0,
                            q_offset=0).transpose(1, 2)
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = 1e-5 * big if dtype == "float32" \
        else 2.0 ** (math.floor(math.log2(big)) - 7)
    assert err <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Senc", [32, 256])
def test_flash_decode_cross_cache_on_card(cuda, Senc, dtype):
    """B5 over an all-valid encoder cache (4 slots, 16 heads over 16, D
    64: the seamless decode's cross-attention) against its plain version
    (the kernel's roundings): 2e-4 in f32 (the reference's bar for sums
    in another order), one bf16 ulp of the largest output in bf16."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((4, 1, 16, 64), generator=gen, device=cuda)
    k, v = (torch.randn((4, Senc, 16, 64), generator=gen, device=cuda)
            .to(dt) for _ in range(2))
    valid = torch.ones((Senc,), dtype=torch.bool, device=cuda)
    n0 = dec.flash_decode_launches
    got = ops.gqa_flash_decode(q, k, v, valid)
    assert dec.flash_decode_launches == n0 + 1
    want = dec.flash_decode_plain(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = 2e-4 * max(big, 1.0) if dtype == "float32" \
        else 2.0 ** (math.floor(math.log2(big)) - 7)
    assert err <= tol
