"""The port's multi-PS and checkpoint slice on ``llama3-8b.reduced()`` (f32,
``device="cpu"``): DiLoCo's outer step and parameter partition against the
reference's on numpy-made trees, the K=2/H=2 island session against one
reference run (two data shards, a checkpoint at the round boundary), and
the port against itself -- K=1/H=1 bit parity with the single-PS session,
in-place islands against copying ones, save -> restore -> resume, and
churn at device and island granularity.  Tolerances: the reference's 1e-4
on the training state (max-relative on losses, L2 on params and the
outer anchor; the velocity's L2 error on the anchor's scale), 1e-6 on one
outer step; bit equality within the port.  One reference run and one run
of the port's K=2/H=2 session are module fixtures."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CleaveRuntime
from repro.api import Fleet as JFleet
from repro.checkpointing import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import diloco as jdiloco
from repro_torch import tree as T
from repro_torch.api import Fleet, PSGroup, ShardedFleet, TorchCleaveRuntime
from repro_torch.checkpointing import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import (from_jax_multi_ps_state,
                                 from_jax_opt_state, from_jax_outer_state,
                                 from_jax_params)
from repro_torch.optim import adam, diloco
from repro_torch.train_loop.multi_ps import MultiPSTrainSession, _own

ARCH = "llama3-8b"
B, S = 2, 32
CHUNKS = dict(q_chunk=16, k_chunk=16, loss_chunk=16)
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
DILOCO = dict(inner_steps=2, outer_lr=0.7)
REL_TOL = 1e-4
SEEDS = (0, 7)        # the two islands' data shards


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op torch thread for this module.  Its tensors are small,
    and with pytest-xdist's workers sharing the host's cores torch's
    default pool (a thread a core in every worker) spends most of its time
    waiting for descheduled threads: the module ran ~4x slower under five
    busy cores with the default pool than with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _l2_rel(want, got, scale=None):
    """Largest per-leaf L2 distance of a port tree from a reference (numpy)
    tree, relative to the reference leaf's norm, or to the norm of the
    same leaf of ``scale`` (a reference tree) where one is given."""
    scale = want if scale is None else scale
    return max(float(np.linalg.norm(np.asarray(a, np.float64)
                                    - b.double().numpy())
                     / (np.linalg.norm(np.asarray(s, np.float64)) + 1e-30))
               for a, b, s in zip(jax.tree.leaves(want), T.leaves(got),
                                  jax.tree.leaves(scale)))


def _bits(t):
    """A tensor's raw bits where its type is bfloat16, else the tensor."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _bit_equal(a, b):
    """Trees (nested dicts, tuples such as ``AdamState``) equal leaf for
    leaf in type and bits."""
    la, lb = list(ckpt._flatten(a).values()), list(ckpt._flatten(b).values())
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _batch(data, step):
    return {k: torch.as_tensor(v) for k, v in data.batch(step).items()}


def _shards(cfg, step):
    return [_batch(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=B,
                                          seed=s)), step) for s in SEEDS]


def _ms_state_np(st):
    """A reference ``MultiPSState`` with its leaves as numpy arrays."""
    return dataclasses.replace(
        st, island_params=_np_tree(st.island_params),
        island_opt=_np_tree(st.island_opt),
        outer=None if st.outer is None else _np_tree(st.outer))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's K=2/H=2 session (numpy executor) over 2 steps on
    two data shards, checkpointing at the round boundary (step 2): its
    initial state, the state after each step and the step reports."""
    jcfg = jget_config(ARCH).reduced()
    jopt = jadam.AdamConfig(**OPT)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    opt = jadam.init(params, jopt)
    ckdir = tmp_path_factory.mktemp("ref_ckpt")
    rt = CleaveRuntime(arch=jcfg, fleet=JFleet.sample(8, seed=0))
    sess = rt.train_session(jopt, n_ps=2,
                            diloco=jdiloco.DiLoCoConfig(**DILOCO),
                            checkpoint=str(ckdir), checkpoint_every=2,
                            **CHUNKS)
    st = sess.init(params, opt)
    out = {"init": _ms_state_np(st), "states": [], "reports": [],
           "ckdir": str(ckdir), "sizes": [len(g) for g in sess.sharded],
           "ids": [sorted(g.fleet.ids()) for g in sess.sharded]}
    for step in range(2):
        batches = [{k: jnp.asarray(v) for k, v in JSyntheticLM(JDataConfig(
            vocab_size=jcfg.vocab_size, seq_len=S, global_batch=B,
            seed=s)).batch(step).items()} for s in SEEDS]
        st, met = sess.step(st, batches)
        out["states"].append(_ms_state_np(st))
        out["reports"].append(met["multi_ps"])
    return out


def _session(n_ps=2, *, checkpoint=None, backend="torch",
             diloco_cfg=diloco.DiLoCoConfig(**DILOCO)):
    """A port runtime on 8 CPU devices and its training session: K=2/H=2
    islands by default, the single-PS session for ``n_ps=1`` without a
    DiLoCo config."""
    cfg = get_config(ARCH).reduced()
    rt = TorchCleaveRuntime(arch=cfg, fleet=Fleet.sample(8, seed=0),
                            device="cpu")
    sess = rt.train_session(
        adam.AdamConfig(**OPT), n_ps=n_ps, backend=backend,
        diloco=diloco_cfg, checkpoint=checkpoint, checkpoint_every=2,
        **CHUNKS)
    return cfg, rt, sess


def _init(ref):
    """The reference's initial params and AdamState, as port trees."""
    st = ref["init"]
    return (from_jax_params(st.island_params[0], "cpu"),
            from_jax_opt_state(st.island_opt[0], "cpu"))


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """The port's K=2/H=2 session (torch backend, copying islands) over 3
    steps from the reference's initial state, checkpointing at the round
    boundary (step 2): the session, the state and metrics after each step.
    Held against the reference, against donated islands and against a
    session restored from its checkpoint; copying steps leave each
    recorded state as it was."""
    ckdir = tmp_path_factory.mktemp("port_ckpt")
    cfg, _, sess = _session(checkpoint=str(ckdir))
    st = from_jax_multi_ps_state(ref["init"], "cpu")
    out = {"sess": sess, "ckdir": str(ckdir), "states": [], "metrics": []}
    for step in range(3):
        st, met = sess.step(st, _shards(cfg, step))
        out["states"].append(st)
        out["metrics"].append(met)
    return out


# ------------------------------------------------ against the reference ----

@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_k2_h2_matches_reference(ref, port, backend):
    """Both packages start from one state (``interop``): losses within
    1e-4, island params after step 1, the merged params and the outer
    anchor within 1e-4 in L2, the velocity's L2 error within 1e-4 of the
    anchor's norm (the velocity is the anchor less the islands' mean, so
    its own norm is ~200 times smaller than the terms it cancels), the
    sync accounting and the island partition exactly equal."""
    if backend == "torch":
        sess, runs = port["sess"], zip(port["states"], port["metrics"])
    else:
        cfg, _, sess = _session(backend=backend)

        def numpy_run():
            st = from_jax_multi_ps_state(ref["init"], "cpu")
            for step in range(2):
                st, met = sess.step(st, _shards(cfg, step))
                yield st, met
        runs = numpy_run()
    assert isinstance(sess, MultiPSTrainSession)
    assert [len(g) for g in sess.sharded] == ref["sizes"]
    assert [sorted(g.fleet.ids()) for g in sess.sharded] == ref["ids"]
    assert all(isl.rt.device == torch.device("cpu") for isl in sess.islands)
    for (want_st, want), (st, met) in zip(zip(ref["states"],
                                              ref["reports"]), runs):
        got = met["multi_ps"]
        for lw, lg in zip(want.island_loss + (want.loss,),
                          got.island_loss + (got.loss,)):
            assert abs(lg - lw) <= REL_TOL * abs(lw)
        assert (got.step, got.round, got.synced, got.n_islands) == \
            (want.step, want.round, want.synced, want.n_islands)
        assert got.cross_ps_sync_bytes == want.cross_ps_sync_bytes
        assert got.predicted_sync_time == want.predicted_sync_time
        assert all(r.verified for r in got.island_reports)
        for wp, gp in zip(want_st.island_params, st.island_params):
            assert _l2_rel(wp, gp) <= REL_TOL
    final = ref["states"][-1]
    assert got.step == 2 and got.synced
    assert _l2_rel(final.outer.anchor, st.outer.anchor) <= REL_TOL
    assert _l2_rel(final.outer.velocity, st.outer.velocity,
                   scale=final.outer.anchor) <= REL_TOL
    assert ref["reports"][-1].cross_ps_sync_bytes == 2 * sum(
        diloco.partition_params(st.params, 2).shard_bytes)


def _tree_pair(rng, dtype):
    """The same random tree (nested, mixed shapes) as numpy-made jax
    arrays and as port tensors, in ``dtype`` (``e`` always bf16)."""
    shapes = {"w": (16, 16), "e": (32, 8), "n": {"g": (16,), "h": (4, 3)}}
    arrs = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype), arrs)
    jt["e"] = jt["e"].astype(jnp.bfloat16)
    return jt, from_jax_params(_np_tree(jt), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partition_params_matches_reference(rng, dtype):
    jt, tt = _tree_pair(rng, getattr(jnp, dtype))
    for k in (1, 2, 3):
        assert diloco.partition_params(tt, k) == \
            jdiloco.partition_params(jt, k)
    with pytest.raises(ValueError):
        diloco.partition_params(tt, 0)


@pytest.mark.parametrize("n_groups", [1, 3])
def test_outer_step_sharded_matches_reference(rng, n_groups):
    """The sharded round within 1e-6 of the reference's, bit-equal to the
    port's monolithic ``outer_step`` at every shard count, and bit-equal
    again in place (``donate``), which writes the merged params into
    every group."""
    jt, tt = _tree_pair(rng, jnp.float32)
    jgroups = [jax.tree.map(lambda p, i=i: p + (0.01 * (i + 1))
                            * jnp.ones_like(p), jt)
               for i in range(n_groups)]
    groups = [from_jax_params(_np_tree(g), "cpu") for g in jgroups]
    cfg = diloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9)
    jcfg = jdiloco.DiLoCoConfig(outer_lr=0.7, outer_momentum=0.9)
    # a second round, so the velocity enters the update
    jstate = jdiloco.outer_init(jt)
    _, jstate = jdiloco.outer_step(jstate, jgroups, jcfg)
    state = from_jax_outer_state(_np_tree(jstate), "cpu")
    mono_p, mono_s = diloco.outer_step(state, groups, cfg)
    for k in (1, 2, 3):
        part = diloco.partition_params(tt, k)
        jp, js, jtraffic = jdiloco.outer_step_sharded(jstate, jgroups,
                                                      jdiloco
                                                      .partition_params(
                                                          jt, k), jcfg)
        p, s, traffic = diloco.outer_step_sharded(state, groups, part, cfg)
        assert traffic == jtraffic
        for want, got in ((jp, p), (js.velocity, s.velocity),
                          (js.anchor, s.anchor)):
            for a, b in zip(jax.tree.leaves(want), T.leaves(got)):
                a = np.asarray(a, np.float32)
                assert np.abs(a - b.float().numpy()).max() \
                    <= 1e-6 * np.abs(a).max()
        assert _bit_equal(mono_p, p) and _bit_equal(mono_s.anchor, s.anchor)
        assert _bit_equal(mono_s.velocity, s.velocity)
        assert (p["w"].dtype, p["e"].dtype) == (torch.float32,
                                                torch.bfloat16)
        d_state, d_groups = _own(state), [_own(g) for g in groups]
        dp, ds, _ = diloco.outer_step_sharded(d_state, d_groups, part, cfg,
                                              donate=True)
        assert _bit_equal(mono_p, dp) and _bit_equal(mono_s.anchor,
                                                     ds.anchor)
        assert _bit_equal(mono_s.velocity, ds.velocity)
        assert all(_bit_equal(mono_p, g) for g in d_groups)
        assert all(x is y for x, y in zip(T.leaves(ds.anchor),
                                          T.leaves(d_state.anchor)))
    with pytest.raises(ValueError):
        diloco.outer_step_sharded(state, groups, diloco.ParamPartition(
            shard_of=(0,), shard_bytes=(1.0,), n_shards=1), cfg)


def test_outer_state_never_aliases_params(rng):
    """``.to(torch.float32)`` of an f32 tensor is the tensor itself: the
    anchor must be a copy, and a round's new params must not be the new
    anchor, or an in-place AdamW on the params would move the anchor."""
    _, tt = _tree_pair(rng, jnp.float32)
    st = diloco.outer_init(tt)
    assert all(a.data_ptr() != p.data_ptr()
               for a, p in zip(T.leaves(st.anchor), T.leaves(tt)))
    new_p, st2 = diloco.outer_step(st, [tt], diloco.DiLoCoConfig())
    before = [a.clone() for a in T.leaves(st2.anchor)]
    for p in T.leaves(new_p):
        p.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(st2.anchor),
                                                 before))


# ------------------------------------------------------- the port itself ----

def test_k1_h1_bit_parity_with_single_ps(ref):
    params, opt = _init(ref)
    cfg, _, single = _session(n_ps=1, diloco_cfg=None)
    assert type(single).__name__ == "FleetTrainSession"
    _, _, multi = _session(n_ps=1,
                           diloco_cfg=diloco.DiLoCoConfig(inner_steps=1))
    assert isinstance(multi, MultiPSTrainSession) and multi.n_islands == 1
    st = multi.init(params, opt)
    assert st.outer is None and st.params is params
    p, o = _own(params), _own(opt)
    for step in range(2):
        batch = _shards(cfg, step)[0]
        p, o, met_s = single.step(p, o, batch)
        st, met_m = multi.step(st, batch)
        assert float(met_s["loss"]) == met_m["loss"]
        assert not met_m["multi_ps"].synced
    assert _bit_equal(p, st.params)
    assert _bit_equal(o.mu, st.opt_state.mu)
    assert _bit_equal(o.nu, st.opt_state.nu)
    assert int(o.step) == int(st.opt_state.step) == 2


def test_donated_islands_equal_copying_ones(ref, port):
    """Two steps (a round) with the islands and the outer round updated in
    place give the copying session's bits (the ``port`` run, which starts
    from the same params); every island owns its tensors (no storage
    shared with another island, the anchor or the caller's trees), and an
    in-place step leaves the anchor as it was."""
    params, opt = _init(ref)
    cfg, _, donated = _session()
    st_d = donated.init(_own(params), _own(opt))

    def ptrs(tree):
        return {t.data_ptr() for t in T.leaves(tree)}
    anchors = ptrs(st_d.outer.anchor) | ptrs(st_d.outer.velocity)
    own = [ptrs(p) | ptrs(o.mu) | ptrs(o.nu)
           for p, o in zip(st_d.island_params, st_d.island_opt)]
    assert not own[0] & own[1] and not (own[0] | own[1]) & anchors
    assert not own[1] & (ptrs(params) | ptrs(opt.mu))
    anchor0 = _own(st_d.outer.anchor)
    for step in range(2):
        st_c, met_c = port["states"][step], port["metrics"][step]
        st_d, met_d = donated.step(st_d, _shards(cfg, step), donate=True)
        assert met_c["loss"] == met_d["loss"]
        if step == 0:
            assert _bit_equal(anchor0, st_d.outer.anchor)
            # the islands' params were updated where they lay
            assert [ptrs(p) for p in st_d.island_params] == \
                [own[0] & ptrs(st_d.island_params[0]),
                 own[1] & ptrs(st_d.island_params[1])]
    assert met_d["multi_ps"].synced
    for a, b in zip(st_c.island_params + st_c.island_opt,
                    st_d.island_params + st_d.island_opt):
        assert _bit_equal(a, b)
    assert _bit_equal(st_c.outer.anchor, st_d.outer.anchor)
    assert _bit_equal(st_c.outer.velocity, st_d.outer.velocity)
    assert _bit_equal(st_d.island_params[0], st_d.island_params[1])
    assert not ptrs(st_d.island_params[0]) & ptrs(st_d.island_params[1])
    assert not ptrs(st_c.island_params[0]) & ptrs(st_c.island_params[1])


def test_single_ps_checkpoint_resume_bit_exact(ref, tmp_path):
    """Kill and resume: 2 steps with a checkpoint every 2, a fresh session
    restores and runs 2 more; losses, params and moments bit-match the
    uninterrupted 4-step run, and the cadence carries on (step 4)."""
    params, opt = _init(ref)
    cfg, _, whole = _session(n_ps=1, diloco_cfg=None)
    p_r, o_r, losses = _own(params), _own(opt), []
    for step in range(4):
        p_r, o_r, met = whole.step(p_r, o_r, _shards(cfg, step)[0],
                                   donate=True)
        losses.append(float(met["loss"]))
    _, _, sess_a = _session(n_ps=1, diloco_cfg=None,
                            checkpoint=str(tmp_path))
    p, o = _own(params), _own(opt)
    for step in range(2):
        # donated: the files must hold each step's values, not later ones
        p, o, met = sess_a.step(p, o, _shards(cfg, step)[0], donate=True)
        assert float(met["loss"]) == losses[step]
    assert sess_a.checkpoint.steps() == [2]
    assert ckpt.load_metadata(sess_a.checkpoint._path(2))["loss"] \
        == losses[1]
    _, _, sess_b = _session(n_ps=1, diloco_cfg=None,
                            checkpoint=str(tmp_path))
    p2, o2, step0 = sess_b.restore(params, opt)
    assert step0 == 2 and sess_b.step_index == 2
    assert _bit_equal(p, p2) and _bit_equal(o.mu, o2.mu)
    assert int(o2.step) == 2 and o2.step.dtype == torch.int32
    for step in range(2, 4):
        p2, o2, met = sess_b.step(p2, o2, _shards(cfg, step)[0])
        assert float(met["loss"]) == losses[step]
    assert _bit_equal(p_r, p2) and _bit_equal(o_r.mu, o2.mu)
    assert _bit_equal(o_r.nu, o2.nu)
    assert sess_b.checkpoint.steps() == [2, 4]
    # no snapshot: the like trees pass through at step 0
    _, _, empty = _session(n_ps=1, diloco_cfg=None,
                           checkpoint=str(tmp_path / "none"))
    assert empty.restore(params, opt) == (params, opt, 0)
    with pytest.raises(RuntimeError, match="no checkpoint manager"):
        _session(n_ps=1, diloco_cfg=None)[2].restore(params, opt)


def test_multi_ps_restore_step_and_round(ref, port):
    """The ``port`` run, checkpointed at its round boundary, restores into
    a fresh session (step 2, round 1, every island and the outer state bit
    for bit), and one resumed step equals the uninterrupted third."""
    params, opt = _init(ref)
    sess, (st, st3), met = port["sess"], port["states"][1:], \
        port["metrics"][2]
    assert sess.checkpoint.steps() == [2]
    assert ckpt.load_metadata(sess.checkpoint._path(2))["round"] == 1
    cfg, _, fresh = _session(checkpoint=port["ckdir"])
    st_r, step_r = fresh.restore(fresh.init(params, opt))
    assert step_r == 2 and st_r.round == 1 and st_r.inner_step == 2
    for a, b in zip(st.island_params + st.island_opt,
                    st_r.island_params + st_r.island_opt):
        assert _bit_equal(a, b)
    assert _bit_equal(st.outer.anchor, st_r.outer.anchor)
    assert _bit_equal(st.outer.velocity, st_r.outer.velocity)
    st_r, met_r = fresh.step(st_r, _shards(cfg, 2))
    assert met["loss"] == met_r["loss"]
    assert _bit_equal(st3.params, st_r.params)
    assert fresh.checkpoint.steps() == [2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_checkpoint_leaf_round_trip(tmp_path, dtype):
    """f32, bf16 (as its raw bits) and int32 leaves, an ``AdamState`` with
    its host int32 step, round-trip bit for bit into the like tree's
    types; a wrong shape raises."""
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(5, 7, generator=g) * 1e3).to(dtype)
    tree = {"a": {"x": x, "s": x[0].clone()},
            "opt": adam.AdamState(step=torch.tensor(3, dtype=torch.int32),
                                  mu={"m": torch.randn(4, generator=g)},
                                  nu={"m": torch.rand(4, generator=g)}),
            "l": [x.clone(), x[:2].clone()]}
    path = str(tmp_path / "c.npz")
    ckpt.save(path, tree, {"k": 1})
    with np.load(path) as z:
        assert sorted(z.files) == sorted(ckpt._flatten(tree))
        if dtype == torch.bfloat16:
            assert z["a/x"].dtype == np.uint16
    like = {
        "a": {"x": torch.zeros_like(x), "s": torch.zeros_like(x[0])},
        "opt": adam.AdamState(step=torch.tensor(0, dtype=torch.int32),
                              mu={"m": torch.zeros(4)},
                              nu={"m": torch.zeros(4)}),
        "l": [torch.zeros_like(x), torch.zeros_like(x[:2])]}
    back = ckpt.restore(path, like)
    assert isinstance(back["opt"], adam.AdamState)
    flat_a, flat_b = ckpt._flatten(tree), ckpt._flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype
        assert torch.equal(_bits(flat_a[k]), _bits(flat_b[k]))
    assert ckpt.load_metadata(path) == {"k": 1}
    like["a"]["x"] = torch.zeros(7, 5, dtype=dtype)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, like)


def test_reference_checkpoint_restores_in_port(ref):
    """The reference session's f32 checkpoint (step 2: islands, moments,
    outer state) restores bit for bit into the port's tree."""
    mgr = ckpt.CheckpointManager(ref["ckdir"])
    assert mgr.steps() == [2]
    want = ref["states"][-1]
    init = from_jax_multi_ps_state(ref["init"], "cpu")
    like = {"island_params": list(init.island_params),
            "island_opt": list(init.island_opt), "outer": init.outer}
    step, tree = mgr.restore_latest(like)
    assert step == 2
    got = from_jax_multi_ps_state(want, "cpu")
    for a, b in zip(T.leaves(got.island_params[1]),
                    T.leaves(tree["island_params"][1])):
        assert torch.equal(a, b)
    assert _bit_equal(got.outer.anchor, tree["outer"].anchor)
    assert _bit_equal(got.island_opt[0].nu, tree["island_opt"][0].nu)
    assert int(tree["island_opt"][0].step) == 2
    assert ckpt.load_metadata(mgr._path(2)) == jckpt.load_metadata(
        mgr._path(2))


def test_port_checkpoint_restores_in_reference(ref, tmp_path):
    """The reverse: the port's f32 save restores bit for bit through the
    reference's ``restore`` into a jax tree of the same structure."""
    params, opt = _init(ref)
    tree = {"params": params, "opt": opt}
    path = str(tmp_path / "p.npz")
    ckpt.save(path, tree)
    jlike = {"params": jax.tree.map(jnp.asarray,
                                    ref["init"].island_params[0]),
             "opt": jax.tree.map(jnp.asarray, ref["init"].island_opt[0])}
    back = jckpt.restore(path, jlike)
    assert isinstance(back["opt"], jadam.AdamState)
    want = ckpt._flatten(tree)
    got = jckpt._flatten(back)
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert np.asarray(a).dtype == want[k].numpy().dtype
        assert np.array_equal(np.asarray(a), want[k].numpy())


# ----------------------------------------------------------------- churn ----

def test_ps_failure_mid_round_recovers(ref):
    params, opt = _init(ref)
    cfg, _, sess = _session()
    st = sess.init(params, opt)
    ids = sorted(i for g in sess.sharded for i in g.fleet.ids())
    st, _ = sess.step(st, _shards(cfg, 0))
    st, met = sess.step(st, _shards(cfg, 1), fail_ps=1)
    rep = met["multi_ps"]
    assert rep.evicted_ps == 1 and rep.n_devices_reassigned == 4
    assert rep.n_islands == sess.n_islands == st.n_islands == 1
    assert not rep.synced and rep.round == 0
    assert sorted(sess.islands[0].rt.fleet.ids()) == ids   # ids kept
    assert sess.islands[0].group._runtime is sess.islands[0].rt
    assert all(r.verified for r in rep.island_reports)
    assert all(bool(torch.isfinite(x).all()) for x in T.leaves(st.params))
    st, met = sess.step(st, _shards(cfg, 2)[0])
    assert np.isfinite(met["loss"])
    assert met["islands"][0].n_tasks > 0
    with pytest.raises(KeyError):
        sess.step(st, _shards(cfg, 3)[0], fail_ps=1)


def test_device_failure_inside_island(ref):
    params, opt = _init(ref)
    cfg, _, sess = _session()
    st = sess.init(params, opt)
    victim = next(iter(sess.sharded[1].fleet.ids()))
    st, met = sess.step(st, _shards(cfg, 0), fail_ids=[victim],
                        fail_island=1, fail_at_gemm=2)
    rep = met["islands"][1]
    assert rep.n_recovered > 0 and rep.verified
    assert rep.failed_ids == (victim,)
    assert victim not in sess.islands[1].rt.fleet.ids()
    assert len(sess.islands[0].rt.fleet) == 4
    assert met["islands"][0].failed_ids == ()


def test_batch_count_mismatch_rejected(ref):
    params, opt = _init(ref)
    cfg, _, sess = _session()
    st = sess.init(params, opt)
    with pytest.raises(ValueError, match="per-island batches"):
        sess.step(st, _shards(cfg, 0) * 2)


def test_sharded_fleet_islands_run_on_the_template_device():
    """Each island's runtime is built once, on the template's device, over
    the island's subfleet (a card template's islands raising here is
    ``tests/test_torch_hygiene.py``'s)."""
    rt = TorchCleaveRuntime(arch=get_config(ARCH).reduced(),
                            fleet=Fleet.sample(6, seed=1), device="cpu")
    sf = ShardedFleet.partition(rt.fleet, 3)
    assert sf.n_ps == 3 and len(sf) == 6
    island = sf[0].runtime_for(rt)
    assert island.device == torch.device("cpu")
    assert island is sf[0].runtime_for(rt)
    assert island.fleet.signature() == sf[0].fleet.signature()
    assert isinstance(sf[0], PSGroup)
