"""The fused Freivalds residuals of a verified band bucket
(``kernels/freivalds.py``): the plain version, fed the packed buffer,
against the torch arithmetic the fleet executor ran before the kernel
(kept here as the oracle); the packed buffer; the CUDA entry's refusals and
launch sizes.  The ``gpu``-marked tests hold the kernel to the plain version
on a card and skip elsewhere."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import freivalds as fv
from repro_torch.kernels import ops

_M32 = 0xFFFFFFFF


def _mul32(h, c):
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _rademacher(seed, task_ids, iters, n, salt):
    """The executor's sign draws as they were written before the kernel."""
    h = _mix32(np.uint64((int(seed) & _M32) ^ 0x9E3779B9))
    h = _mix32(h ^ np.uint64(int(salt) & _M32))
    tid = np.asarray(task_ids, np.uint64)[:, None] & np.uint64(_M32)
    key = _mix32(_mix32(h ^ tid) ^ np.arange(iters, dtype=np.uint64))
    k = torch.as_tensor(key.astype(np.int64))[:, :, None]
    ix = torch.arange(n, dtype=torch.int64)
    h = _mix32(_mix32(k ^ ix) ^ k)
    return 1.0 - 2.0 * ((h >> 31) & 1).to(torch.float32)


def _oracle(As, b_op, C, hs, bidx, slot, c0s, c1s, corrupt, seed, task_ids,
            *, pm, R, iters):
    """The verified bucket's residuals as the executor computed them before
    the kernel (``ops._bucket_gemm_verified``'s body), on the band stack
    ``As`` and its product ``C``, which it poisons in place."""
    qk = C.shape[2]
    Gb = As.shape[0]
    bidx_t = torch.as_tensor(bidx, dtype=torch.int64)
    slot_t = torch.as_tensor(slot, dtype=torch.int64)
    c0_t = torch.as_tensor(c0s, dtype=torch.int64)
    c1_t = torch.as_tensor(c1s, dtype=torch.int64)
    zero = torch.zeros_like(bidx_t)
    corr = torch.as_tensor(corrupt, dtype=torch.float32)
    c00 = C[bidx_t, zero, c0_t]
    C.index_put_((bidx_t, zero, c0_t), corr * (1.0 + c00.abs()),
                 accumulate=True)
    r = _rademacher(seed, task_ids, iters, pm, 0)
    s = _rademacher(seed, task_ids, iters, qk, 1)
    hs_t = torch.as_tensor(hs, dtype=torch.int64)
    rowm = (torch.arange(pm)[None, :] < hs_t[:, None]).float()
    cols = torch.arange(qk)[None, :]
    colm = ((cols >= c0_t[:, None]) & (cols < c1_t[:, None])).float()
    r = r * rowm[bidx_t][:, None, :]
    s = s * colm[:, None, :]
    Af = As.float()
    Bf = b_op.float()
    t = torch.einsum("kq,riq->rki", Bf, s)
    t_g = torch.zeros((Gb, R) + tuple(t.shape[1:]))
    t_g[bidx_t, slot_t] = t
    u = torch.einsum("bmk,brki->bmri", Af, t_g)
    r_g = torch.zeros((Gb, R, iters, pm))
    r_g[bidx_t, slot_t] = r
    lhs = torch.einsum("brim,bmri->bri", r_g, u)[bidx_t, slot_t]
    s_g = torch.zeros((Gb, R, iters, qk))
    s_g[bidx_t, slot_t] = s
    Cs = torch.einsum("bmq,briq->bmri", C, s_g)
    rhs = torch.einsum("brim,bmri->bri", r_g, Cs)[bidx_t, slot_t]
    colm_g = torch.zeros((Gb, R, qk))
    colm_g[bidx_t, slot_t] = colm
    Csa = torch.einsum("bmq,brq->bmr", C.abs(), colm_g)
    scale = torch.einsum("bm,bmr->br", rowm, Csa)[bidx_t, slot_t]
    return lhs, rhs, scale


def _bucket(rng, hs, pm, nk, qk, windows, *, dtype=torch.float32,
            poisoned=(), iters=2, seed=12345):
    """A bucket of bands of heights ``hs`` (padded to ``pm`` rows) over
    an (nk, qk) shared operand; ``windows[b]`` lists band b's rectangles'
    column windows.  Returns the operands, the band products and the host
    arrays ``plan_gemm_buckets`` builds."""
    a_pad = torch.from_numpy(rng.standard_normal(
        (sum(hs) + pm, nk)).astype(np.float32)).to(dtype)
    b_op = torch.from_numpy(rng.standard_normal(
        (nk, qk)).astype(np.float32)).to(dtype)
    r0s = np.cumsum([0] + list(hs[:-1])).astype(np.int32)
    bidx, slot, c0s, c1s = [], [], [], []
    for b, wins in enumerate(windows):
        for si, (c0, c1) in enumerate(wins):
            bidx.append(b)
            slot.append(si)
            c0s.append(c0)
            c1s.append(c1)
    host = {"r0s": r0s, "hs": np.asarray(hs, np.int32),
            "bidx": np.asarray(bidx, np.int32),
            "slot": np.asarray(slot, np.int32),
            "c0s": np.asarray(c0s, np.int32),
            "c1s": np.asarray(c1s, np.int32),
            "corrupt": np.isin(np.arange(len(bidx)), poisoned)
            .astype(np.float32),
            "task_ids": rng.permutation(4 * len(bidx) + 8)[:len(bidx)],
            "seed": seed, "iters": iters}
    As = ops._gather_bands(a_pad, r0s, pm, dtype)
    C = ops._band_matmul(As, b_op, "torch")
    return As, b_op, C, host


def _pack(h):
    return fv.pack(h["hs"], h["bidx"], h["slot"], h["c0s"], h["c1s"],
                   h["corrupt"], h["seed"], h["task_ids"], h["iters"])


def _even(q, n):
    """n column windows splitting [0, q) as evenly as the planner's."""
    edges = np.linspace(0, q, n + 1).round().astype(int)
    return list(zip(edges[:-1], edges[1:]))


BUCKETS = {
    # several bands, ragged heights, full-width and split windows
    "bands": dict(hs=[97, 128, 70], pm=128, nk=256, qk=384,
                  windows=[[(0, 384)], [(0, 150), (150, 384)],
                           [(0, 1), (1, 200), (200, 384)]], poisoned=(4,)),
    # one band at R 16, narrow windows over a wide product
    "r16": dict(hs=[256], pm=256, nk=128, qk=2000,
                windows=[_even(2000, 16)], poisoned=(0, 9)),
    # windows that leave columns of the product to no rectangle
    "narrow": dict(hs=[40, 33], pm=128, nk=128, qk=640,
                   windows=[[(3, 7), (300, 640)], [(128, 129)]],
                   poisoned=(2,)),
    # single-rectangle bands (the router's forward)
    "single": dict(hs=[121, 24, 100, 66], pm=128, nk=384, qk=160,
                   windows=[[(0, 160)]] * 4, poisoned=(1,)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_plain_residuals_match_the_executor_before_the_kernel(case, dtype,
                                                               rng):
    """The plain version reads everything from the packed buffer and
    computes what the executor computed: 1e-6 of each number, the poisoned
    band products identical."""
    As, b_op, C, h = _bucket(rng, dtype=dtype, **BUCKETS[case])
    C_want = C.clone()
    R = int(np.bincount(h["bidx"]).max())
    lhs, rhs, scale = _oracle(As, b_op, C_want, h["hs"], h["bidx"],
                              h["slot"], h["c0s"], h["c1s"], h["corrupt"],
                              h["seed"], h["task_ids"], pm=As.shape[1], R=R,
                              iters=h["iters"])
    meta, geom = _pack(h)
    got = fv.residuals(As, b_op, C, fv.to_device(meta, C.device), geom)
    want = torch.cat([lhs, rhs, scale[:, None]], dim=1)
    assert tuple(got.shape) == (len(h["bidx"]), 2 * h["iters"] + 1)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(C, C_want)
    # the poisoning moved exactly the flagged rectangles' first elements
    sites = {(int(h["bidx"][g]), int(h["c0s"][g]))
             for g in np.flatnonzero(h["corrupt"])}
    clean = ops._band_matmul(As, b_op, "torch")
    moved = {(b, q) for b, m, q in (C != clean).nonzero().tolist()
             if m == 0}
    assert moved == sites and int((C != clean).sum()) == len(sites)


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_packed_buffer_round_trips(case, rng):
    _, _, _, h = _bucket(rng, **BUCKETS[case])
    meta, geom = _pack(h)
    assert meta.dtype == np.int32
    f = fv.unpack(meta, geom)
    for name, key in (("h", "hs"), ("bidx", "bidx"),
                      ("slot", "slot"), ("c0", "c0s"), ("c1", "c1s"),
                      ("corrupt", "corrupt")):
        np.testing.assert_array_equal(f[name], h[key])
    np.testing.assert_array_equal(
        f["first"], np.searchsorted(h["bidx"], np.arange(len(h["hs"]) + 1)))
    for name, salt in (("key_r", 0), ("key_s", 1)):
        np.testing.assert_array_equal(f[name], fv.probe_keys(
            h["seed"], h["task_ids"], h["iters"], salt))
    assert f["counter"].tolist() == [0]
    R = int(np.bincount(h["bidx"]).max())
    width = int((h["c1s"] - h["c0s"]).max())
    assert geom == fv.Geometry(bands=len(h["hs"]), rects=len(h["bidx"]),
                               most=R, width=width, iters=h["iters"])
    with pytest.raises(ValueError):
        fv.unpack(meta[:-1], geom)


def test_pack_refuses_rectangles_out_of_band_order(rng):
    _, _, _, h = _bucket(rng, **BUCKETS["bands"])
    h["slot"] = h["slot"][::-1].copy()
    with pytest.raises(ValueError):
        _pack(h)
    _, _, _, h = _bucket(rng, **BUCKETS["bands"])
    h["iters"] = fv.MAXIT + 1
    with pytest.raises(ValueError):
        _pack(h)


def test_signs_are_the_executors_draws():
    """``ops.rademacher`` (and so the kernel's keys and hash) draws the
    signs the executor drew before the kernel, bit for bit."""
    for seed, tids, n, salt in ((11, [3, 5, 9], 64, 0),
                                (2 ** 31 - 2, [0, 2 ** 20 + 7], 1000, 1),
                                (0, list(range(40)), 3, 1)):
        want = _rademacher(seed, tids, 2, n, salt)
        assert torch.equal(ops.rademacher(seed, tids, 2, n, salt, "cpu"),
                           want)


def test_cuda_entry_refuses_what_it_does_not_take(rng):
    """CPU tensors take the plain version only through ``residuals``; the
    CUDA entry raises on them, on types it does not take, and on a packed
    buffer that does not fit."""
    As, b_op, C, h = _bucket(rng, **BUCKETS["bands"])
    meta, geom = _pack(h)
    meta_t = torch.from_numpy(meta)
    with pytest.raises(ValueError, match="CUDA"):
        fv.residuals_cuda(As, b_op, C, meta_t, geom)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fv.residuals_cuda(As.half(), b_op.half(), C, meta_t, geom)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fv.residuals_cuda(As, b_op.bfloat16(), C, meta_t, geom)
    with pytest.raises(ValueError, match="int32"):
        fv.residuals_cuda(As, b_op, C, meta_t.long(), geom)
    dev = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        fv.residuals(As.to(dev), b_op.to(dev), C.to(dev), meta_t.to(dev),
                     geom)


def _smoke():
    """``chip_smoke.py`` as a module (its phases import torch lazily)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("at", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_sign_probe_reads_rademachers_signs(case, at, rng):
    """The probe that holds the kernel's signs on the card reads, through
    the plain version's residuals, exactly ``ops.rademacher``'s sign
    products, and a draw under another seed differs."""
    As, b_op, _, h = _bucket(rng, **BUCKETS[case])
    meta, geom = _pack(h)
    smoke = _smoke()
    got = smoke.sign_probe(As, b_op, torch.from_numpy(meta), geom,
                           h["seed"], h["task_ids"], at)
    assert got["signs_equal"] and got["sign_products"] > 0
    other = smoke.sign_probe(As, b_op, torch.from_numpy(meta), geom,
                             h["seed"] + 1, h["task_ids"], at)
    assert not other["signs_equal"]


def test_kernel_launches_through_one_op(monkeypatch, rng):
    """The two launches run inside one op of the dispatcher (which a
    profiler records where the bucket runs), on the scratch the result is
    read from, C and the packed buffer as given."""
    op = fv._op()
    assert op is fv._op()
    schema = str(op.default._schema)
    assert "Tensor(a!) C" in schema and "int[] dims" in schema
    As, b_op, C, h = _bucket(rng, **BUCKETS["bands"])
    meta, geom = _pack(h)
    meta_t = torch.from_numpy(meta)
    p = fv.plan(As.shape[2], As.shape[1], geom)
    sizes = fv._scratch_sizes(geom.bands, As.shape[2], geom.rects,
                              geom.iters, p)
    scratch = torch.zeros(sum(sizes))
    calls = {}

    def kernel(name):
        def launch(*args):
            calls[name] = args
            return 0
        return launch
    monkeypatch.setattr(fv, "_kernel", kernel)
    monkeypatch.setattr(fv, "_on_card", lambda device, launch: launch(7))
    fv._launch(As, b_op, C, meta_t, scratch,
               [geom.rects, geom.iters] + [p[k] for k in fv._PLAN_KEYS])
    t, cpart, apart, res = torch.split(scratch, sizes)
    prod, opnd = calls["product_f32"], calls["operands_f32"]
    assert prod[0] == b_op.data_ptr() and prod[2] == C.data_ptr()
    assert prod[5] == meta_t.data_ptr() and prod[-1] == 7
    assert (prod[6], prod[7]) == (t.data_ptr(), cpart.data_ptr())
    assert opnd[0] == As.data_ptr() and opnd[-1] == 7
    assert opnd[3:8] == (t.data_ptr(), meta_t.data_ptr(), cpart.data_ptr(),
                         apart.data_ptr(), res.data_ptr())
    assert res.data_ptr() == scratch[-sizes[-1]:].data_ptr()
    assert opnd[-2] == p["row_tiles"] * p["splits"]


@pytest.mark.parametrize("nk,pm,most,width,want", [
    # the LM head's dW at the benchmark's cell: one band of 5,120 rows, 16
    # rectangles of 6,400 columns over a contraction of 256
    (256, 5120, 16, 6400, dict(kt_tiles=4, row_tiles=80, splits=7, np=32,
                               groups=1, tx=128, k_tiles=1)),
    # its dA: 256 rows, 16 rectangles of 320 columns, contraction 102,400
    (102400, 256, 16, 320, dict(kt_tiles=1600, row_tiles=4, splits=1, np=32,
                                groups=1, tx=256, k_tiles=200)),
    # the router's forward: single-rectangle bands
    (5120, 128, 1, 160, dict(kt_tiles=80, row_tiles=2, splits=1, np=4,
                             groups=1, tx=256, k_tiles=10)),
    # more pairs than a block holds, a contraction of one tile
    (128, 640, 20, 1025, dict(kt_tiles=2, row_tiles=10, splits=2, np=32,
                              groups=2, tx=64, k_tiles=1)),
])
def test_launch_plan(nk, pm, most, width, want):
    geom = fv.Geometry(bands=1, rects=most, most=most, width=width, iters=2)
    assert fv.plan(nk, pm, geom) == want


def test_shared_constants_match_the_cuda_source():
    """The wrapper sizes its launches and scratch with the kernel's tile
    constants and packs the layout the kernel unpacks."""
    src = (Path(fv.__file__).resolve().parents[1] / "csrc"
           / "freivalds.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("MAXIT"), const("KT"), const("MR")) == (fv.MAXIT, fv.KT,
                                                          fv.MR)
    assert fv.NPART == fv.MAXIT + 1
    assert re.search(r"case (\d+): FV_OPERANDS", src)
    assert tuple(int(n) for n in re.findall(r"case (\d+): FV_OPERANDS",
                                            src)) == fv.PAIRS
    fields = re.findall(r"^  M\.(\w+) = ", src, flags=re.M)
    assert tuple(fields) == fv._FIELDS


# ------------------------------------------------------------------ card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_kernel_matches_plain_on_card(cuda, case, dtype, aligned, rng):
    """Both sides sum the same f32 products in another order: each number
    within 1e-5 of the rectangle's noise scale Σ|C| and of its own size;
    the poisoned band products identical, also for an operand B that
    starts off any alignment."""
    As, b_op, C, h = _bucket(rng, dtype=dtype, **BUCKETS[case])
    As, b_op, C = As.to(cuda), b_op.to(cuda), C.to(cuda)
    if not aligned:
        b_op = torch.cat([torch.zeros_like(b_op[:, :1]), b_op], 1)[:, 1:]
    meta, geom = _pack(h)
    C_plain = C.clone()
    want = fv.residuals_plain(As, b_op, C_plain, torch.from_numpy(meta),
                              geom)
    n0 = fv.launches
    got = fv.residuals(As, b_op, C, fv.to_device(meta, cuda), geom)
    torch.cuda.synchronize()
    assert fv.launches == n0 + 1
    assert torch.equal(C, C_plain)
    tol = 1e-5 * (want[:, -1:] + want.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("at", [0.0, 0.5, 1.0])
def test_kernel_signs_are_rademachers_on_card(cuda, at, rng):
    """The kernel's signs, read through its residuals
    (``chip_smoke.sign_probe``), are ``ops.rademacher``'s bit for bit, at a
    large seed and task ids, over a product 37,000 columns wide."""
    h = dict(hs=[256], pm=256, nk=128, qk=37000,
             windows=[_even(37000, 16)])
    As, b_op, _, host = _bucket(rng, seed=2 ** 31 - 5, **h)
    host["task_ids"] = np.arange(16) * 7919 + 2 ** 20
    meta, geom = _pack(host)
    n0 = fv.launches
    got = _smoke().sign_probe(As.to(cuda), b_op.to(cuda),
                              torch.from_numpy(meta), geom, 2 ** 31 - 5,
                              host["task_ids"], at)
    assert fv.launches == n0 + 1
    assert got["signs_equal"] and got["sign_products"] == 16 * 23 * 2
