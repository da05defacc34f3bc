"""The port's mesh layer without ranks: the logical-axis rules and every
spec against the reference's on the production meshes (no devices: the
reference's spec functions run on ``jax.sharding.AbstractMesh``), the
flash-attention prefix under a sliding window, ``remat``, and the dry
run traced on the CPU (``--device cpu``, in a subprocess).  The spawned
ranks' checks are in ``tests/test_torch_mesh_spmd.py``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.models import attention as JA
from repro.parallel.sharding import make_rules as jmake_rules
from repro_torch import tree as T
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.parallel.sharding import AbstractMesh, make_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["16x16", "2x16x16"]
MODES = ("train", "prefill", "decode")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread: the tensors are small, and xdist's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jspec(p) -> tuple:
    return tuple(p)


def _jleaves(tree):
    """{path: leaf} of a reference tree, paths joined by '/'."""
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pleaves(tree):
    return dict(zip(("/".join(k) for k in T.paths(tree)), T.leaves(tree)))


# ------------------------------------------------------------- spec parity --

@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_rules_tables_match_reference(mesh):
    """``make_rules``' table for every mode, ``weight_2d`` and ``fsdp``
    equals the reference's, and so does ``spec`` of every logical name."""
    dims, axes = mesh
    jm, pm = JAbstractMesh(dims, axes), AbstractMesh(dims, axes)
    for mode in MODES:
        for w2 in (None, True, False):
            for fsdp in (False, True):
                jr = jmake_rules(jm, mode, w2, fsdp)
                pr = make_rules(pm, mode, w2, fsdp)
                assert jr.table == pr.table
                for name in jr.table:
                    assert _jspec(jr.spec(name)) == pr.spec(name), name


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_and_opt_specs_match_reference(mesh):
    """Every param leaf of every registered config: shape and
    ``_leaf_spec``; and the moments' ``opt_specs`` (the ZeRO 'pod' shard
    on the multi-pod mesh) equal the reference's."""
    dims, axes = mesh
    jr = jmake_rules(JAbstractMesh(dims, axes), "train")
    pr = make_rules(AbstractMesh(dims, axes), "train")
    n = 0
    for arch in list_configs():
        jp = JSP.param_specs(jget_config(arch), jr)
        pp = SP.param_specs(get_config(arch), pr)
        jl, pl = _jleaves(jp), _pleaves(pp)
        assert set(jl) == set(pl), arch
        for path, j in jl.items():
            p = pl[path]
            assert tuple(j.shape) == p.shape, (arch, path)
            assert _jspec(j.sharding.spec) == p.spec, (arch, path)
            n += 1
        jo, po = JSP.opt_specs(jp, jr), SP.opt_specs(pp, pr)
        pmu = _pleaves(po.mu)
        for path, j in _jleaves(jo.mu).items():
            assert _jspec(j.sharding.spec) == pmu[path].spec, (arch, path)
            assert pmu[path].dtype == torch.float32
    assert n > 200


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_input_and_cache_specs_match_reference(mesh):
    """Every input and cache leaf of every registered config, input shape
    and rule mode: shape and ``_divisible_spec``; ``cache_len_for`` and
    ``logits_sharding``'s spec too."""
    dims, axes = mesh
    jm, pm = JAbstractMesh(dims, axes), AbstractMesh(dims, axes)
    for arch in list_configs():
        jcfg, cfg = jget_config(arch), get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            jshape = JSHAPES[name]
            assert SP.cache_len_for(cfg, shape) == \
                JSP.cache_len_for(jcfg, jshape)
            for mode in MODES:
                jr, pr = jmake_rules(jm, mode), make_rules(pm, mode)
                ji = JSP.input_specs(jcfg, jshape, jr)
                pi = SP.input_specs(cfg, shape, pr)
                assert set(ji) == set(pi)
                for k, j in ji.items():
                    if k == "cache":
                        assert set(j) == set(pi[k])
                        for ck, cj in j.items():
                            p = pi[k][ck]
                            assert tuple(cj.shape) == p.shape
                            assert _jspec(cj.sharding.spec) == p.spec, \
                                (arch, name, mode, ck)
                    else:
                        assert tuple(j.shape) == pi[k].shape
                        assert _jspec(j.sharding.spec) == pi[k].spec
                assert _jspec(JSP.logits_sharding(jcfg, jshape, jr).spec) \
                    == SP.logits_sharding(cfg, shape, pr)


def _reference_model_flops():
    """The reference dry run's ``model_flops``.  Importing the module sets
    ``XLA_FLAGS`` for 512 host devices; the variable is put back at once,
    before any backend reads it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return model_flops


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_microbatches_and_model_flops_match_reference(mesh):
    """``default_microbatches`` (with and without the mesh's cap) and
    ``model_flops`` of every config and input shape equal the
    reference's; so do ``CHUNK_OVERRIDES``."""
    dims, axes = mesh
    jr = jmake_rules(JAbstractMesh(dims, axes), "train")
    pr = make_rules(AbstractMesh(dims, axes), "train")
    jflops = _reference_model_flops()
    assert ST.CHUNK_OVERRIDES == JST.CHUNK_OVERRIDES
    for arch in list_configs():
        jcfg, cfg = jget_config(arch), get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            jshape = JSHAPES[name]
            assert ST.default_microbatches(cfg, shape, pr) == \
                JST.default_microbatches(jcfg, jshape, jr)
            assert ST.default_microbatches(cfg, shape) == \
                JST.default_microbatches(jcfg, jshape)
            assert CA.model_flops(cfg, shape) == jflops(jcfg, jshape)


# ------------------------------------------- B4: a prefix under a window --

@pytest.mark.parametrize("window", [1, 5, 64])
@pytest.mark.parametrize("q_offset", [0, 7])
def test_prefix_under_window_matches_reference(window, q_offset):
    """``chunked_attention`` with an always-visible prefix of 8 keys and
    a sliding window, causal, at G 2: output and the gradients with
    respect to q, k, v and the prefix K/V within 1e-5 of the reference's
    (relative to each one's largest entry), f32."""
    rng = np.random.default_rng(window * 10 + q_offset)
    Bq, Sq, H, K, D, P = 2, 12, 4, 2, 16, 8
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, K, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, K, D)).astype(np.float32)
    pk = rng.standard_normal((P, K, D)).astype(np.float32)
    pv = rng.standard_normal((P, K, D)).astype(np.float32)
    gy = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    opts = dict(causal=True, window=window, q_offset=q_offset, q_chunk=4,
                k_chunk=4)

    def jfn(q_, k_, v_, pk_, pv_):
        pre = tuple(jnp.broadcast_to(t[None], (Bq,) + t.shape)
                    for t in (pk_, pv_))
        return JA.chunked_attention(q_, k_, v_, prefix_kv=pre, **opts)

    jargs = [jnp.asarray(t) for t in (q, k, v, pk, pv)]
    want = np.asarray(jfn(*jargs))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * gy),
                  argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, pk, pv)]
    pre = tuple(t[None].expand((Bq,) + tuple(t.shape)) for t in targs[3:])
    got = A.chunked_attention(*targs[:3], prefix_kv=pre, **opts)
    scale = np.abs(want).max()
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * scale
    (got * torch.from_numpy(gy)).sum().backward()
    for w, t in zip(jg, targs):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ------------------------------------------------------------------ remat --

@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-1b-a400m"])
def test_remat_changes_no_value(arch):
    """``remat`` recomputes each layer in the backward: the loss, the
    metrics and every gradient are bit-equal with it on and off."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    chunks = dict(q_chunk=8, k_chunk=8, loss_chunk=8)
    (l0, m0), g0 = M.value_and_grad(cfg, params, batch, remat=True,
                                    **chunks)
    (l1, m1), g1 = M.value_and_grad(cfg, params, batch, remat=False,
                                    **chunks)
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(m0[k], m1[k])
    for a, b in zip(T.leaves(g0), T.leaves(g1)):
        assert torch.equal(a, b)


# --------------------------------------------------------------- dry run --

DRYRUN_CASES = {
    "small_mesh_train": dict(arch="granite-moe-1b-a400m",
                             shape_name="train_4k", mesh_override="4x4"),
    "small_mesh_decode": dict(arch="llama3-8b", shape_name="decode_32k",
                              mesh_override="4x4"),
    "multi_pod_axis": dict(arch="granite-moe-1b-a400m",
                           shape_name="train_4k", mesh_override="2x2x4"),
    # one request, which the 'data' axis does not divide: the MoE routes
    # the whole batch on every batch shard
    "undivided_batch": dict(arch="granite-moe-1b-a400m",
                            shape_name="long_500k", mesh_override="4x4"),
}
# the training cases cut to one layer, so the trace stays quick
_DRYRUN = r"""
import json, sys
from repro_torch.launch import dryrun
cases = json.loads(sys.argv[1])
out = {k: dryrun.run_one(device="cpu", **v) for k, v in cases.items()}
json.dump(out, open(sys.argv[2], "w"), default=str)
"""


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """The four cases in one subprocess (DTensor's per-op strategy
    caches then serve all three)."""
    cases = {k: dict(v, layers=1 if v["shape_name"] == "train_4k" else None)
             for k, v in DRYRUN_CASES.items()}
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _DRYRUN, json.dumps(cases),
                        str(out)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", list(DRYRUN_CASES))
def test_dryrun_cpu(case, dryruns):
    """The reference's three dry-run cases (tests/test_system.py) and
    granite-moe's long_500k decode of one request on 4x4, traced on the
    CPU under FakeTensorMode at the rank's local shapes: a positive
    peak, FLOPs and collective bytes; the decode cases in decode mode,
    the multi-pod one on ('pod', 'data', 'model')."""
    res = dryruns[case]
    assert res["memory"]["peak_per_device"] > 0
    assert res["memory"]["measured_by"].startswith("FakeTensorMode")
    assert res["cost"]["flops"] > 0
    assert res["collective_bytes"] > 0
    if case in ("small_mesh_decode", "undivided_batch"):
        assert res["mode"] == "decode"
    if case == "multi_pod_axis":
        assert res["axes"] == ["pod", "data", "model"]
        assert res["mesh"] == [2, 2, 4]
