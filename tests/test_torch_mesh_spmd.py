"""The port's mesh layer on ranks: one spawned group of four gloo ranks
(torch on one thread in each, a ``FileStore`` in ``tmp_path``) runs
every check of this module once, and the tests read its results.

* The sharded train step against the single-device step, for llama3-8b
  and granite-moe-1b-a400m on 2x2 (data x model) and 2x1x2 (pod x data
  x model), on the reduced config of ``scripts/check_mesh_equivalence.py``
  (f32): within that script's tolerances (loss 5e-3 relative; params
  rtol 5e-2, atol 5e-3), and within 1e-5 (loss relative, each param
  leaf relative L2) where the MoE capacity does not bind (the sharded
  MoE keeps each batch shard's tokens to its own capacity, as the
  reference's does, so where capacity binds other tokens are dropped).
* The sharded MoE against the reference's ``_moe_block_sharded``, run in
  a subprocess with four host devices, on the same numpy inputs: 1e-5;
  on one row, which 'data' does not divide, against the reference's
  ``_moe_block_global``: 1e-5.
* The sharded decode attention against the reference's unsharded
  ``decode_attention``: 1e-5.
* Prefill, then serve, under decode rules (cache sequence on 'model')
  against the unsharded port: the greedy tokens are equal.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MOE_ARCH = "granite-moe-1b-a400m"
# capacity slots per expert that hold every routed token of the reduced
# config's step (E = 4 experts, top 2): no token is dropped
NO_DROP = {"capacity_factor": 2.0}
STEP_CASES = [("llama3-8b", (2, 2), None), ("llama3-8b", (2, 1, 2), None),
              (MOE_ARCH, (2, 2), None), (MOE_ARCH, (2, 1, 2), None),
              (MOE_ARCH, (2, 2), NO_DROP), (MOE_ARCH, (2, 1, 2), NO_DROP)]
STRICT = 1e-5
DEC = dict(B=4, S=16, H=4, K=2, D=16, slot=5, n_valid=6)
SERVE = dict(B=4, prompt=8, gen=3)


def _inputs(path):
    """The numpy inputs shared by the ranks and the reference."""
    rng = np.random.default_rng(0)
    d, E, ff = 64, 4, 64
    inp = {
        "x": rng.standard_normal((4, 8, d)).astype(np.float32),
        "router": (rng.standard_normal((d, E)) / 8).astype(np.float32),
        "w_gate": (rng.standard_normal((E, d, ff)) / 8).astype(np.float32),
        "w_up": (rng.standard_normal((E, d, ff)) / 8).astype(np.float32),
        "w_down": (rng.standard_normal((E, ff, d)) / 8).astype(np.float32),
    }
    B, S, H, K, D = (DEC[k] for k in ("B", "S", "H", "K", "D"))
    inp["q"] = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    inp["k_new"] = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    inp["v_new"] = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    inp["k_cache"] = rng.standard_normal((B, S, K, D)).astype(np.float32)
    inp["v_cache"] = rng.standard_normal((B, S, K, D)).astype(np.float32)
    np.savez(path, **inp)
    return inp


def _rank(rank, world, store_dir, inputs_path, out_path):
    """Every rank's checks; rank 0 writes the results."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import mesh_check as MC
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps as ST
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import (make_rules, placements,
                                               use_rules)
    MC.init_group(rank, world, store_dir)
    res = {"steps": []}
    for arch, dims, over in STEP_CASES:
        r = MC.rank_body(rank, world, arch, dims, "cpu", over)
        res["steps"].append(dict(r, over=over))

    d = dict(np.load(inputs_path))
    mesh = MC.mesh_of((2, 2), "cpu")

    def put(a, spec, rules):
        return distribute_tensor(torch.from_numpy(a), mesh,
                                 placements(spec, rules.mesh),
                                 src_data_rank=None)

    # the sharded MoE
    cfg = MC.reduced_config(MOE_ARCH)
    rules = make_rules(mesh, "train")
    p = {n: put(d[n], SP._leaf_spec("moe/" + n, d[n].shape, rules), rules)
         for n in ("router", "w_gate", "w_up", "w_down")}
    with torch.no_grad(), use_rules(rules):
        x = put(d["x"], ("data", None, "model"), rules)
        out, aux = MOE.moe_block(cfg, p, x)
        res["moe_out"] = out.full_tensor().numpy().tolist()
        res["moe_aux"] = float(aux.full_tensor())
        # one row, which 'data' does not divide: every batch shard routes
        # it whole
        x = put(d["x"][:1], (None, None, "model"), rules)
        out, aux = MOE.moe_block(cfg, p, x)
        res["moe_row_out"] = out.full_tensor().numpy().tolist()
        res["moe_row_aux"] = float(aux.full_tensor())

    # the sharded decode attention
    drules = make_rules(mesh, "decode")
    with torch.no_grad(), use_rules(drules):
        q, kn, vn = (put(d[n], ("data",), drules)
                     for n in ("q", "k_new", "v_new"))
        ck, cv = (put(d[n], ("data", "model"), drules)
                  for n in ("k_cache", "v_cache"))
        slot = torch.tensor(DEC["slot"])
        valid = torch.arange(DEC["S"]) < DEC["n_valid"]
        o = A.decode_attention(q, A._write_slot(ck, kn, slot),
                               A._write_slot(cv, vn, slot), valid)
        res["decode_out"] = o.full_tensor().numpy().tolist()

    # prefill, then serve under decode rules
    cfg = MC.reduced_config("llama3-8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (SERVE["B"], SERVE["prompt"]),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, {"tokens": tok})
        want = [logits[:, -1].argmax(-1)]
        for _ in range(SERVE["gen"]):
            logits, cache = M.decode_step(cfg, params, cache,
                                          want[-1][:, None])
            want.append(logits[:, -1].argmax(-1))
    prules = make_rules(mesh, "prefill")
    cpl = {}
    for name, t in cache.items():
        logical = [None if n == "layers" else n
                   for n in SP.CACHE_LOGICAL[name]]
        cpl[name] = placements(SP._divisible_spec(drules, t.shape, logical),
                               mesh)
    prefill = ST.make_prefill_step(cfg, rules=prules, cache_placements=cpl)
    serve = ST.make_serve_step(cfg, rules=drules)
    logits, dcache = prefill(SP.shard_params(params, prules),
                             {"tokens": put(tok.numpy(), ("data", None),
                                            prules)})
    got = [logits.full_tensor()[:, -1].argmax(-1)]
    res["cache_placements"] = {k: str(v.placements) for k, v in
                               dcache.items() if hasattr(v, "placements")}
    dparams = SP.shard_params(params, drules)
    for _ in range(SERVE["gen"]):
        t = put(got[-1][:, None].numpy(), ("data", None), drules)
        logits, dcache = serve(dparams, dcache, t)
        got.append(logits.full_tensor()[:, -1].argmax(-1))
    res["serve_want"] = [w.tolist() for w in want]
    res["serve_got"] = [g.tolist() for g in got]
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f, default=str)
    dist.barrier()
    dist.destroy_process_group()


_REF_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.models import moe
from repro.parallel.sharding import make_rules
d = np.load(sys.argv[2])
cfg = get_config("granite-moe-1b-a400m").reduced(
    n_layers=2, d_model=64, d_head=16, vocab_size=256)
p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}
mesh = jax.make_mesh((2, 2), ("data", "model"))
with mesh:
    out, aux = moe._moe_block_sharded(cfg, p, jnp.asarray(d["x"]),
                                      make_rules(mesh, "train"))
np.savez(sys.argv[3], out=np.asarray(out), aux=np.asarray(aux))
"""


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """The ranks' results, and the reference's ``_moe_block_sharded`` on
    four host devices, run in a subprocess beside the ranks."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("spmd")
    inputs = _inputs(tmp / "inputs.npz")
    out = tmp / "result.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REF_MOE,
                            os.path.join(ROOT, "src"),
                            str(tmp / "inputs.npz"), str(tmp / "ref.npz")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_rank, args=(WORLD, str(tmp), str(tmp / "inputs.npz"),
                              str(out)), nprocs=WORLD, join=True)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    return inputs, json.loads(out.read_text()), dict(np.load(tmp /
                                                             "ref.npz"))


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[f"{a}-{'x'.join(map(str, m))}"
                              f"{'-no_drop' if o else ''}"
                              for a, m, o in STEP_CASES])
def test_sharded_step_matches_single_device(spmd, case):
    r = spmd[1]["steps"][case]
    assert r["ok"], r
    assert r["loss_rel"] < 5e-3
    assert r["params_allclose"]
    arch, _, over = STEP_CASES[case]
    if arch != MOE_ARCH or over:
        assert r["loss_rel"] <= STRICT, r
        assert r["params_worst_rel_l2"] <= STRICT, r


def test_sharded_moe_matches_reference(spmd):
    """The port's sharded MoE (each batch shard routing its own tokens,
    the experts over 'model') against the reference's
    ``_moe_block_sharded`` on a 2x2 mesh of host devices: output and aux
    loss within 1e-5."""
    _, res, ref = spmd
    got = np.asarray(res["moe_out"])
    assert np.abs(got - ref["out"]).max() <= STRICT * np.abs(ref["out"]).max()
    assert abs(res["moe_aux"] - float(ref["aux"])) <= STRICT * abs(
        float(ref["aux"]))


def test_sharded_moe_undivided_batch_matches_reference(spmd):
    """A batch of one row on the 2x2 mesh, which 'data' does not divide:
    the port's sharded MoE routes the whole batch on each batch shard, at
    the global capacity, and equals the reference's ``_moe_block_global``
    (which the reference runs there) within 1e-5, output and aux loss."""
    from repro.configs.base import get_config as jget_config
    from repro.models import moe as JMOE
    inputs, res, _ = spmd
    cfg = jget_config(MOE_ARCH).reduced(n_layers=2, d_model=64, d_head=16,
                                        vocab_size=256)
    p = {k: jnp.asarray(inputs[k])
         for k in ("router", "w_gate", "w_up", "w_down")}
    out, aux = JMOE._moe_block_global(cfg, p, jnp.asarray(inputs["x"][:1]))
    want, got = np.asarray(out), np.asarray(res["moe_row_out"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= STRICT * np.abs(want).max()
    assert abs(res["moe_row_aux"] - float(aux)) <= STRICT * abs(float(aux))


def test_sharded_decode_matches_reference(spmd):
    """The sharded flash-decode (cache sequence on 'model', batch on
    'data'), with the new entries written at the slot, against the
    reference's unsharded ``decode_attention`` over the written cache:
    within 1e-5."""
    from repro.models import attention as JA
    inputs, res, _ = spmd
    s = DEC["slot"]
    ck, cv = inputs["k_cache"].copy(), inputs["v_cache"].copy()
    ck[:, s] = inputs["k_new"][:, 0]
    cv[:, s] = inputs["v_new"][:, 0]
    valid = np.arange(DEC["S"]) < DEC["n_valid"]
    want = np.asarray(JA.decode_attention(
        jnp.asarray(inputs["q"]), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(valid)))
    got = np.asarray(res["decode_out"])
    assert np.abs(got - want).max() <= STRICT * np.abs(want).max()


def test_prefill_then_serve_under_decode_rules(spmd):
    """Prefill, then three serve steps with the cache's sequence on
    'model' and its batch on 'data': the greedy tokens equal the
    unsharded port's at every step, and the prefill's cache leaves in the
    decode layout."""
    res = spmd[1]
    assert res["serve_got"] == res["serve_want"]
    assert "Shard(dim=2)" in res["cache_placements"]["k"]
