"""The port's dense model against the reference on ``llama3-8b.reduced()``
(f32), with the reference's params carried over by ``from_jax_params``.
Logits agree to 1e-5 of their largest magnitude: the same f32 arithmetic,
with XLA's and PyTorch's CPU kernels summing in different orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs.base import get_config
from repro_torch.interop import from_jax_params
from repro_torch.models import model as M

ARCH = "llama3-8b"


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def test_init_params_layout_matches_reference(setup):
    """``init_params`` draws the reference's tree: same keys, shapes and
    dtypes, layers stacked on a leading axis, same init scales."""
    jcfg, cfg, jparams, _ = setup
    ours = M.init_params(cfg, torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        node = ours
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        want_std = float(np.std(np.asarray(leaf)))
        assert abs(float(node.float().std()) - want_std) \
            <= 0.1 * want_std + 1e-6, path


def test_interop_bfloat16_bits():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = from_jax_params({"w": x}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


def test_prefill_matches_reference(setup, rng):
    jcfg, cfg, jparams, params = setup
    toks = rng.integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    jlg, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    lg, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(lg, jlg)
    for nm in ("k", "v"):
        _close(cache[nm], jcache[nm])
    assert int(cache["pos"]) == int(jcache["pos"]) == 8


@pytest.mark.parametrize("mode", ["scalar_pos", "vector_pos", "int8"])
def test_decode_step_matches_reference(setup, rng, mode):
    """Six decode steps from a fresh cache: scalar position (the uniform
    batch), per-slot positions (continuous batching) and the int8 cache."""
    jcfg, cfg, jparams, params = setup
    B, S = 2, 16
    quant = mode == "int8"
    jc = JM.init_cache(jcfg, B, S, kv_quant=quant)
    tc = M.init_cache(cfg, B, S, kv_quant=quant, device="cpu")
    if mode == "vector_pos":
        jc["pos"] = jnp.asarray([0, 3], jnp.int32)
        tc["pos"] = torch.tensor([0, 3], dtype=torch.int32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 6)).astype(np.int32)
    for t in range(6):
        jlg, jc = JM.decode_step(jcfg, jparams, jc,
                                 jnp.asarray(toks[:, t:t + 1]))
        lg, tc = M.decode_step(cfg, params, tc,
                               torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlg)
    for nm in jc:
        if nm != "pos":
            _close(tc[nm], np.asarray(jc[nm]).astype(np.float32))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_qk_norm_and_bias_families_match_reference(rng):
    """qwen3 (qk-norm) and qwen1.5 (QKV bias) share the dense path."""
    for arch in ("qwen3-32b", "qwen1.5-32b"):
        jcfg = jget_config(arch).reduced(n_layers=1)
        cfg = get_config(arch).reduced(n_layers=1)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
        if cfg.qkv_bias:
            jp["layers"]["attn"]["bq"] = jnp.asarray(
                rng.standard_normal(jp["layers"]["attn"]["bq"].shape),
                jnp.float32)
        params = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
        toks = rng.integers(0, cfg.vocab_size, size=(1, 6)).astype(np.int32)
        jlg, _ = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
        lg, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
        _close(lg, jlg)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "granite-moe-1b-a400m",
                                  "hymba-1.5b", "seamless-m4t-medium",
                                  "qwen2-vl-72b"])
def test_later_families_raise(arch):
    """The families that raised at init while the port lacked them
    initialise now: the MoE family (granite-moe-1b-a400m), the MLA family
    (deepseek-v2-236b, MoE and MLA), M-RoPE (qwen2-vl-72b), the
    encoder-decoder (seamless-m4t-medium) and the hybrid (hymba-1.5b,
    which also takes one ``value_and_grad``; their parity with the
    reference: tests/test_torch_moe.py, tests/test_torch_mla.py,
    tests/test_torch_mrope.py, tests/test_torch_encdec.py,
    tests/test_torch_hymba.py).  The cases keep the parameter list, and so
    the names, they had while they raised."""
    cfg = get_config(arch).reduced()
    if arch == "granite-moe-1b-a400m":
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        assert "moe" in params["layers"] and "mlp" not in params["layers"]
        return
    if arch == "deepseek-v2-236b":
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        assert "moe" in params["layers"]
        assert {"w_dkv", "w_uk", "w_uv"} <= set(params["layers"]["attn"])
        return
    if arch == "qwen2-vl-72b":
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        assert cfg.m_rope and sum(cfg.m_rope_sections) == cfg.head_dim // 2
        assert {"wq", "wk", "wv", "wo"} == set(params["layers"]["attn"])
        return
    if arch == "seamless-m4t-medium":
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        assert {"encoder", "cross"} <= set(params)
        assert params["encoder"]["layers"]["attn"]["wq"].shape[0] \
            == cfg.n_enc_layers
        assert params["cross"]["attn"]["wk"].shape[0] == cfg.n_layers
        return
    assert arch == "hymba-1.5b"
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert {"attn", "ssm"} <= set(params["layers"])
    assert {"meta_k", "meta_v"} <= set(params["layers"]["attn"])
    toks = torch.arange(16).reshape(2, 8) % cfg.vocab_size
    (loss, _), grads = M.value_and_grad(cfg, params, {"tokens": toks,
                                                      "labels": toks})
    assert bool(torch.isfinite(loss))
    assert float(grads["layers"]["ssm"]["A_log"].abs().max()) > 0
