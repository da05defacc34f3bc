"""The port's kernels against the reference's Pallas kernels (interpret
mode on the CPU).  Here the wrappers run their plain versions, since the
tensors lie on the CPU; the ``gpu``-marked tests hold the CUDA kernels
against the same plain versions on a card and skip elsewhere."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_gemm as jbg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import block_gemm as bg
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wkv
from repro_torch.models import attention as attn

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


# ---------------------------------------------------------------- band GEMM --

@pytest.mark.parametrize("G,m,k,n", [(1, 128, 128, 128), (3, 128, 256, 128),
                                     (2, 64, 128, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_gemm_plain_matches_pallas(G, m, k, n, dtype, rng):
    """Both sides sum the exact products of the same (bf16-rounded) values
    in f32, so they agree to f32 summation order: 1e-5 of the largest
    output."""
    a = rng.standard_normal((G, m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jbg.block_gemm_batched_shared(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), bm=64, bn=64, bk=64,
        out_dtype=jnp.float32, interpret=True))
    got = bg.block_gemm_batched_shared(
        torch.from_numpy(a).to(TORCH_DT[dtype]),
        torch.from_numpy(b).to(TORCH_DT[dtype]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_band_gemm_wrapper_never_falls_back():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises."""
    a = torch.empty((1, 8, 8), device="meta")
    b = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError):
        bg.block_gemm_batched_shared(a, b)
    with pytest.raises(ValueError):
        bg.block_gemm_batched_shared(torch.zeros(1, 8, 8), torch.zeros(9, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_gemm_kernel_on_card(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((3, 100, 1000), generator=gen, device=cuda)
    b = torch.randn((1000, 777), generator=gen, device=cuda)
    a, b = a.to(TORCH_DT[dtype]), b.to(TORCH_DT[dtype])
    n0 = bg.launches
    got = bg.block_gemm_batched_shared(a, b)
    want = bg.block_gemm_batched_shared_plain(a, b)
    assert bg.launches == n0 + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------------- batched and plain GEMM --

@pytest.mark.parametrize("G,m,k,n", [(1, 128, 128, 128), (3, 128, 256, 128),
                                     (2, 64, 128, 192), (4, 40, 96, 72),
                                     (3, 5, 130, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_gemm_batched_plain_matches_pallas(G, m, k, n, dtype, rng):
    """``block_gemm_batched`` (here its plain version) against the Pallas
    kernel in interpret mode, at the reference test's shapes and at ragged
    ones (the Pallas kernel gets them zero-padded to its 64-wide tiles and
    cropped): both sides sum exact products of the same values in f32, so
    they agree to summation order, 1e-5 of the largest output."""
    a = rng.standard_normal((G, m, k)).astype(np.float32)
    b = rng.standard_normal((G, k, n)).astype(np.float32)
    pad = [(-x) % 64 for x in (m, k, n)]
    ap = np.pad(a, ((0, 0), (0, pad[0]), (0, pad[1])))
    bp = np.pad(b, ((0, 0), (0, pad[1]), (0, pad[2])))
    want = np.asarray(jbg.block_gemm_batched(
        jnp.asarray(ap, dtype), jnp.asarray(bp, dtype), bm=64, bn=64, bk=64,
        out_dtype=jnp.float32, interpret=True))[:, :m, :n]
    got = bg.block_gemm_batched(torch.from_numpy(a).to(TORCH_DT[dtype]),
                                torch.from_numpy(b).to(TORCH_DT[dtype]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (64, 192, 128),
                                   (100, 70, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_gemm_plain_matches_pallas(m, k, n, dtype, rng):
    """``block_gemm`` against the Pallas ``block_gemm`` in interpret mode
    (zero-padded to its tiles, cropped), 1e-5 of the largest output."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    pad = [(-x) % 64 for x in (m, k, n)]
    ap = np.pad(a, ((0, pad[0]), (0, pad[1])))
    bp = np.pad(b, ((0, pad[1]), (0, pad[2])))
    want = np.asarray(jbg.block_gemm(
        jnp.asarray(ap, dtype), jnp.asarray(bp, dtype), bm=64, bn=64, bk=64,
        out_dtype=jnp.float32, interpret=True))[:m, :n]
    got = bg.block_gemm(torch.from_numpy(a).to(TORCH_DT[dtype]),
                        torch.from_numpy(b).to(TORCH_DT[dtype]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (200, 300, 170)])
def test_ops_block_gemm_matches_reference(m, k, n, rng):
    """``ops.block_gemm`` against ``repro.kernels.ops.block_gemm`` (the
    kernels benchmark's entry, which pads to 128 and crops), f32."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jops.block_gemm(jnp.asarray(a), jnp.asarray(b)))
    got = ops.block_gemm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_matmul_grads_match_bmm_autograd(dtype, rng):
    """``ops.expert_matmul`` (forward, dA and dW on the batched block GEMM)
    against autograd through ``torch.bmm`` on the same operands: the
    operands' dtype out; 1e-5 of the largest value in f32, one bf16 unit
    in the last place (2^-7) of the largest value in bf16, where both
    sides round each result to bf16 once after f32 sums."""
    dt = TORCH_DT[dtype]
    a0 = torch.from_numpy(rng.standard_normal((4, 10, 48))
                          .astype(np.float32)).to(dt)
    w0 = torch.from_numpy(rng.standard_normal((4, 48, 24))
                          .astype(np.float32)).to(dt)
    gy = torch.from_numpy(rng.standard_normal((4, 10, 24))
                          .astype(np.float32)).to(dt)
    outs = []
    for fn in (ops.expert_matmul,
               lambda x, y: torch.bmm(x.float(), y.float()).to(dt)):
        a, w = a0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = fn(a, w)
        assert y.dtype == dt
        y.backward(gy)
        outs.append((y.detach(), a.grad, w.grad))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for got, want in zip(*outs):
        assert got.dtype == want.dtype == dt
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())


def test_batched_and_plain_wrappers_never_fall_back():
    """Only CPU tensors take the plain versions: any other device launches
    the kernel or raises, as do mismatched shapes."""
    with pytest.raises(ValueError):
        bg.block_gemm_batched(torch.empty((2, 8, 8), device="meta"),
                              torch.empty((2, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        bg.block_gemm(torch.empty((8, 8), device="meta"),
                      torch.empty((8, 8), device="meta"))
    with pytest.raises(ValueError):
        bg.block_gemm_batched(torch.zeros(2, 8, 8), torch.zeros(3, 8, 8))
    with pytest.raises(ValueError):
        bg.block_gemm(torch.zeros(8, 8), torch.zeros(9, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,m,k,n", [(32, 4, 1024, 512), (5, 100, 333, 77)])
def test_block_gemm_batched_kernel_on_card(cuda, G, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((G, m, k), generator=gen, device=cuda).to(TORCH_DT[dtype])
    b = torch.randn((G, k, n), generator=gen, device=cuda).to(TORCH_DT[dtype])
    n0 = bg.batched_launches
    got = bg.block_gemm_batched(a, b)
    want = bg.block_gemm_batched_plain(a, b)
    assert bg.batched_launches == n0 + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_gemm_kernel_on_card(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((512, 512), generator=gen, device=cuda).to(TORCH_DT[dtype])
    b = torch.randn((512, 300), generator=gen, device=cuda).to(TORCH_DT[dtype])
    n0 = bg.block_gemm_launches
    got = ops.block_gemm(a, b)
    want = bg.block_gemm_plain(a, b)
    assert bg.block_gemm_launches == n0 + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------- the bf16 body's host-side plan --

# (G, m, k, n) of the bf16 launches on the full-width paths: llama3-8b's
# decode products (one band of 128 padded rows), its training buckets
# (forward, dA with the LM head's k = 128256, dW), and granite's experts
SPLIT_SHAPES = {
    "decode_q_o": (1, 128, 4096, 4096), "decode_k_v": (1, 128, 4096, 1024),
    "decode_gate_up": (1, 128, 4096, 14336),
    "decode_down": (1, 128, 14336, 4096),
    "decode_lm_head": (1, 128, 4096, 128256),
    "train_fwd": (1, 1024, 4096, 14336), "train_dA": (2, 512, 14336, 4096),
    "train_lm_head_dA": (1, 512, 128256, 4096),
    "train_dW": (4, 1920, 1024, 4096), "train_lm_head_dW": (1, 4096, 512,
                                                            128256),
    "expert_up": (32, 320, 1024, 512), "expert_down": (32, 320, 512, 1024),
    "expert_dW": (32, 1024, 320, 512), "expert_decode": (32, 4, 1024, 512),
    "ragged": (3, 100, 1000, 777), "short_k": (2, 7, 100, 30),
}


def _check_bounds(bounds, k):
    """The slices cover [0, k) in order, and each but the last is a whole
    number of KSPAN spans (each partial restarts on a span boundary), as
    the kernel's launch demands."""
    assert bounds[0] == 0 and bounds[-1] == k
    assert all(k1 > k0 for k0, k1 in zip(bounds, bounds[1:]))
    assert all(x % bg.KSPAN == 0 for x in bounds[:-1])
    assert len(bounds) - 1 <= bg.MAX_SLICES


@pytest.mark.parametrize("name", sorted(SPLIT_SHAPES))
def test_split_plan_properties(name):
    """The bounds the wrapper passes to the kernel: the slices cover [0, k)
    in order; each but the last is a whole number of KSPAN spans; a grid
    of more than a third of the 132 SMs is not split; a smaller one (the
    decode products) is split until S x tiles is the multiple of tiles
    nearest half the SMs -- one wave, never a second -- or every slice is
    one span."""
    G, m, k, n = SPLIT_SHAPES[name]
    bounds = bg.split_plan(G, m, n, k)
    tiles = G * -(-m // bg.TILE) * -(-n // bg.TILE)
    spans = -(-k // bg.KSPAN)
    _check_bounds(bounds, k)
    S = len(bounds) - 1
    assert 1 <= S <= spans
    if 3 * tiles > bg.SMS:
        assert S == 1
    else:
        assert tiles * S <= bg.SMS
        assert S == spans or abs(tiles * S - bg.SMS / 2) <= tiles / 2
    if name.startswith("decode") and tiles < bg.SMS // 3:
        assert S > 1


@pytest.mark.parametrize("slices", [1, 3, 7, 16, 200])
def test_split_plan_forced(slices):
    """A forced number of slices (the split sweep's) keeps the bounds'
    rules, capped at one slice per span and at MAX_SLICES."""
    for k in (1, 255, 256, 1000, 4096, 14336):
        bounds = bg.split_plan(1, 1024, 14336, k, slices)
        _check_bounds(bounds, k)
        assert len(bounds) - 1 == min(slices, -(-k // bg.KSPAN),
                                      bg.MAX_SLICES)


@pytest.mark.parametrize("G,m,k,n", [(3, 100, 1000, 777), (2, 5, 999, 130),
                                     (1, 7, 13, 1), (2, 9, 64, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aligned_copy_is_exact(G, m, k, n, dtype, rng):
    """The plain product of the zero-padded operands, cropped, equals the
    plain product of the originals bit for bit (small integers: every sum
    is exact, in any order), and the view the wrapper hands to TMA holds
    the same values at 16-byte-aligned strides."""
    dt = TORCH_DT[dtype]
    a = torch.from_numpy(rng.integers(-4, 5, (G, m, k))
                         .astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.integers(-4, 5, (k, n))
                         .astype(np.float32)).to(dt)
    ap, bp = bg.pad_inner(a), bg.pad_inner(b)
    per = 16 // a.element_size()
    assert ap.shape[-1] % per == 0 and bp.shape[-1] % per == 0
    assert bool((ap[..., k:] == 0).all()) and bool((bp[..., n:] == 0).all())
    bp = torch.nn.functional.pad(bp, (0, 0, 0, ap.shape[-1] - k))
    want = bg.block_gemm_batched_shared_plain(a, b)
    got = bg.block_gemm_batched_shared_plain(ap, bp)[..., :n]
    assert torch.equal(got, want)
    for x in (a, b):
        y = bg.tma_aligned(x)
        assert bg.tma_ready(y) and torch.equal(y, x)
        assert (y is x) == bg.tma_ready(x)
        assert all(st * y.element_size() % 16 == 0
                   for st, sz in zip(y.stride()[:-1], y.shape[:-1])
                   if sz > 1)


def test_tma_ready_rules():
    """TMA reads a unit-stride inner dimension, a 16-byte-aligned base, and
    16-byte-aligned outer strides that clear the dimensions inside them."""
    x = torch.zeros((4, 64, 256), dtype=torch.bfloat16)
    assert bg.tma_ready(x)
    assert bg.tma_ready(x[1:3, 8:40])                 # band views
    assert bg.tma_ready(x[:, :, :100])                # ragged, aligned rows
    assert not bg.tma_ready(x[:, :, 4:])              # base 8 bytes off
    assert not bg.tma_ready(x[:, :, ::2])             # inner stride 2
    assert not bg.tma_ready(x.transpose(1, 2))
    assert not bg.tma_ready(torch.zeros((10, 777), dtype=torch.bfloat16))
    assert bg.tma_ready(torch.zeros((10, 776), dtype=torch.bfloat16))
    assert bg.tma_ready(torch.zeros((1, 1, 5), dtype=torch.bfloat16))
    assert not bg.tma_ready(x[:1].expand(4, 64, 256))  # batch stride 0


@pytest.mark.gpu
@pytest.mark.parametrize("G,m,k,n,batched", [
    (3, 100, 1000, 777, False), (2, 100, 999, 130, False),
    (1, 37, 77, 5, False), (1, 128, 4096, 1024, False),
    (5, 100, 333, 77, True), (6, 100, 336, 200, True),
    (32, 4, 1024, 512, True)])
def test_bf16_body_ragged_on_card(cuda, G, m, k, n, batched):
    """The wgmma/TMA body against its plain version off the tile grid and
    off TMA's alignment, with a shared and a per-g B: one launch of the
    bf16 body, one aligned copy per misaligned operand, 1e-5 relative."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((G, m, k), generator=gen, device=cuda).bfloat16()
    bsh = (G, k, n) if batched else (k, n)
    b = torch.randn(bsh, generator=gen, device=cuda).bfloat16()
    fn, plain = ((bg.block_gemm_batched, bg.block_gemm_batched_plain)
                 if batched else (bg.block_gemm_batched_shared,
                                  bg.block_gemm_batched_shared_plain))
    n_tc, n_cp = bg.tc_launches, bg.aligned_copies
    copies = sum(not bg.tma_ready(x) for x in (a, b))
    got = fn(a, b)
    want = plain(a, b)
    assert bg.tc_launches == n_tc + 1
    assert bg.aligned_copies == n_cp + copies
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("G,m,k,n", [(1, 128, 64, 128), (1, 128, 16, 128),
                                     (1, 64, 64, 64), (2, 128, 512, 256)])
def test_bf16_body_exact_on_card(cuda, G, m, k, n):
    """Small integers make every product and sum exact in f32, in any
    order: the body must equal its plain version bit for bit, so a
    misplaced element of a swizzled tile shows as a wrong value."""
    ia = torch.arange(G * m * k, device=cuda).reshape(G, m, k)
    ib = torch.arange(k * n, device=cuda).reshape(k, n)
    a = ((ia * 7 + 3) % 17 - 8).bfloat16()
    b = ((ib * 5 + 1) % 13 - 6).bfloat16()
    assert torch.equal(bg.block_gemm_batched_shared(a, b),
                       bg.block_gemm_batched_shared_plain(a, b))


@pytest.mark.gpu
def test_bf16_body_long_contraction_on_card(cuda):
    """k = 128256, the LM head's dA: the two-level sum keeps the kernel
    within 1e-5 of the plain version (one running f32 sum drifted to
    3e-5)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    k = 128256
    a = torch.randn((1, 512, k), generator=gen, device=cuda).bfloat16()
    b = (torch.randn((k, 1024), generator=gen, device=cuda)
         / k ** 0.5).bfloat16()
    got = bg.block_gemm_batched_shared(a, b)
    want = bg.block_gemm_batched_shared_plain(a, b)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("G,m,k,n", [(1, 128, 4096, 1024),
                                     (1, 128, 14336, 4096)])
def test_split_k_repeatable_on_card(cuda, G, m, k, n):
    """A split contraction sums its slices in order, without atomics: two
    launches on the same operands give the same bits."""
    assert len(bg.split_plan(G, m, n, k)) > 2
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((G, m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    n_split = bg.split_launches
    first = bg.block_gemm_batched_shared(a, b)
    again = bg.block_gemm_batched_shared(a, b)
    assert bg.split_launches == n_split + 2
    assert torch.equal(first, again)


# ------------------------------------------- the f32 body's host-side plan --

# (G, m, k, n) of f32 launches: the kernels benchmark's 512^3, granite's
# expert decode products (4 rows), f32-policy cells' buckets and experts,
# llama's training buckets at full width (the gemm phase's f32 checks),
# and ragged or empty ones
FMA_SHAPES = {
    "bgemm_512": (1, 512, 512, 512), "decode_up": (32, 4, 1024, 512),
    "decode_down": (32, 4, 512, 1024), "cell_q": (2, 128, 256, 128),
    "cell_down": (1, 128, 1024, 256), "cell_dw": (1, 256, 128, 1024),
    "cell_expert": (4, 40, 256, 64), "cell_expert_dw": (4, 256, 40, 64),
    "train_fwd": (1, 1024, 4096, 14336), "lm_head_da": (1, 512, 128256,
                                                       4096),
    "train_down_da": (2, 512, 14336, 4096),
    "lm_head_dw": (1, 4096, 512, 128256), "decode_q": (1, 128, 4096, 4096),
    "decode_q2": (2, 128, 4096, 4096), "decode_q3": (3, 128, 4096, 4096),
    "skinny_16": (3, 16, 1000, 777), "wide_17": (3, 17, 999, 130),
    "short_k": (2, 7, 100, 30), "empty_k": (2, 9, 0, 24),
}


@pytest.mark.parametrize("name", sorted(FMA_SHAPES))
def test_fma_plan_properties(name):
    """The f32 body's plan: slice bounds 0, then multiples of KSPAN, then
    k, at most one slice per span; the skinny tiling (every row in one
    block) only for up to 16 rows, a wide one above, 128 x 128 where its
    grid split as far as allowed gives every SM a block; the tile grid
    covers m and n; a 128 x 128 grid of less than a wave takes the fewest
    slices with the fewest waves for the work, another grid that covers
    half the SMs is not split."""
    G, m, k, n = FMA_SHAPES[name]
    tiling, bounds = bg.fma_plan(G, m, n, k)
    rows, cols = bg.FMA_TILES[tiling]
    assert (tiling == bg.SKINNY) == (m <= 16)
    assert rows * -(-m // rows) >= m and cols * -(-n // cols) >= n
    assert rows >= m or tiling != bg.SKINNY
    S = len(bounds) - 1
    assert bounds[0] == 0 and bounds[-1] == k
    if k:
        _check_bounds(bounds, k)
    assert 1 <= S <= max(1, -(-k // bg.KSPAN))
    tiles = bg._tiles(G, m, n, tiling)
    assert tiles >= G * -(-m // rows) * -(-n // cols)
    most = min(max(1, -(-k // bg.KSPAN)), bg.WIDE_128_SLICES)
    if m > 16:
        t128 = G * -(-m // 128) * -(-n // 128)
        assert (tiling == bg.WIDE_128) == (t128 * most >= bg.SMS)
    if tiling == bg.WIDE_128 and tiles < bg.SMS:
        def waves(s):        # waves of the grid over the work
            return Fraction(-(-tiles * s // bg.SMS), s)
        assert S <= most
        assert all(waves(S) < waves(s) for s in range(1, S))
        assert all(waves(S) <= waves(s) for s in range(S, most + 1))
    elif 2 * tiles >= bg.SMS:
        assert S == 1
    for t in bg.FMA_TILES:
        if t != bg.SKINNY or m <= 16:
            forced = bg.fma_plan(G, m, n, k, t, 3)
            assert forced[0] == t and forced[1] == bg._slice_bounds(k, 3)


def test_shared_constants_match_the_cuda_sources():
    """The constants that Python and CUDA share, read from the sources as
    text: the two-level sum's span and the slice cap of the band GEMM, the
    f32 body's tiling numbers, and flash attention's key tile (the plain
    version's online-softmax tile) and its instantiations: every (q/k
    tile, v tile, rows a block) that the wrapper's plan picks for head
    dims up to 192 / 128 is built for both types, and the f32 sweep's
    rows at (128, 128) besides."""
    import re
    from pathlib import Path
    csrc = Path(bg.__file__).resolve().parents[1] / "csrc"
    gemm = (csrc / "band_gemm.cu").read_text()
    flash = (csrc / "flash_attention.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const(gemm, "KSPAN") == bg.KSPAN
    assert const(gemm, "MAX_SLICES") == bg.MAX_SLICES
    enum = re.search(r"enum Tiling \{([^}]*)\}", gemm)[1]
    tilings = {k.strip(): int(v) for k, v in
               (x.split("=") for x in enum.split(","))}
    assert tilings == {"SKINNY": bg.SKINNY, "WIDE_64": bg.WIDE_64,
                       "WIDE_128": bg.WIDE_128}
    assert const(flash, "BK") == fa.BLOCK_K
    launcher = flash[flash.index("int launch("):]
    both, f32 = launcher.split("if constexpr (sizeof(T) == 4)", 1)
    case = r"^  +FLASH_CASE\((\d+), (\d+), (\d+)\)$"

    def cases(src):
        return {tuple(map(int, c)) for c in re.findall(case, src, re.M)}
    plans = {fa.plan(dk, dv) for dk in range(1, fa.MAX_DK + 1)
             for dv in range(1, fa.MAX_DV + 1)}
    assert cases(both) == plans
    assert cases(f32) == {(128, 128, 32), (128, 128, 128)}


@pytest.mark.parametrize("grad", [False, True])
def test_expert_matmul_f32_buffer_bf16_weights(grad, rng):
    """An f32 capacity buffer against bf16 expert weights (the serving
    decode step): with no gradient asked the product goes to the batched
    GEMM with the weights as stored, and on the CPU it equals the promoted
    product bit for bit; with gradients it takes the promoted route, whose
    output and gradients are unchanged."""
    a0 = torch.from_numpy(rng.standard_normal((4, 6, 48)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((4, 48, 24))
                          .astype(np.float32)).bfloat16()
    gy = torch.from_numpy(rng.standard_normal((4, 6, 24)).astype(np.float32))
    if not grad:
        with torch.no_grad():
            got = ops.expert_matmul(a0, w0)
            want = ops.expert_matmul(a0, w0.float())
        assert got.dtype == torch.float32 and torch.equal(got, want)
        return
    a, w = a0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = ops.expert_matmul(a, w)
    y.backward(gy)
    ap, wp = a0.clone().requires_grad_(), w0.clone().requires_grad_()
    a2, w2 = ops._promote(ap, wp)
    y2 = ops._ExpertMatmul.apply(a2, w2)
    y2.backward(gy)
    assert torch.equal(y, y2)
    assert torch.equal(a.grad, ap.grad) and torch.equal(w.grad, wp.grad)
    assert w.grad.dtype == torch.bfloat16


def _small_ints(G, m, k, n, cuda, per_g=False, b_dtype=torch.float32):
    ia = torch.arange(G * m * k, device=cuda).reshape(G, m, k)
    ib = torch.arange((G if per_g else 1) * k * n, device=cuda)
    a = ((ia * 7 + 3) % 17 - 8).float()
    b = ((ib * 5 + 1) % 13 - 6).reshape((G, k, n) if per_g else (k, n))
    return a, b.to(b_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("tiling", ["skinny", "64", "128"])
@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
def test_fma_body_exact_on_card(cuda, tiling, slices, b_dtype):
    """Small integers make every product and sum exact in f32, in any
    order: each tiling of the f32 body, split or not, with an f32 or (the
    per-g entry) a bf16 B, equals its plain version bit for bit, off the
    tile grid in m, n and k."""
    t = {"skinny": bg.SKINNY, "64": bg.WIDE_64, "128": bg.WIDE_128}[tiling]
    m = 13 if t == bg.SKINNY else 150
    per_g = b_dtype == "bfloat16"
    a, b = _small_ints(3, m, 600, 203, cuda, per_g, TORCH_DT[b_dtype])
    entry = "block_gemm_batched" if per_g else "band_gemm"
    c = torch.empty((3, m, 203), device=cuda)
    n_fma = bg.fma_launches
    bg._launch(entry, a, b, c, slices=slices, tiling=t)
    assert bg.fma_launches == n_fma + 1
    assert torch.equal(c, bg.block_gemm_batched_plain(
        a, b if per_g else b.expand(3, -1, -1)))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_fma_body_long_contraction_on_card(cuda, m):
    """k = 128,256 (the LM head's dA) in f32: the two-level sum keeps the
    f32 body within 1e-5 of the plain version, skinny and wide."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    k = 128256
    a = torch.randn((1, m, k), generator=gen, device=cuda)
    b = torch.randn((k, 256), generator=gen, device=cuda) / k ** 0.5
    got = bg.block_gemm_batched_shared(a, b)
    want = bg.block_gemm_batched_shared_plain(a, b)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("G,m,k,n", [(1, 512, 512, 512),
                                     (32, 4, 1024, 512),
                                     (1, 128, 1024, 256)])
def test_fma_split_repeatable_on_card(cuda, G, m, k, n):
    """A split f32 contraction sums its slices in order, without atomics:
    two launches on the same operands give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((G, m, k), generator=gen, device=cuda)
    b = torch.randn((k, n), generator=gen, device=cuda)
    c1, c2 = (torch.empty((G, m, n), device=cuda) for _ in range(2))
    n_split = bg.fma_split_launches
    bg._launch("band_gemm", a, b, c1, slices=2)
    bg._launch("band_gemm", a, b, c2, slices=2)
    assert bg.fma_split_launches == n_split + 2
    assert torch.equal(c1, c2)


@pytest.mark.gpu
@pytest.mark.parametrize("G,m,k,n", [(32, 4, 1024, 512), (32, 4, 512, 1024),
                                     (5, 3, 333, 77), (4, 40, 256, 64)])
def test_mixed_entry_equals_promoted_on_card(cuda, G, m, k, n):
    """The f32 x bf16 entry (the weights as stored, off 16-byte alignment
    too) gives the bits of the launch on the f32 copy, within 1e-5 of the
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((G, m, k), generator=gen, device=cuda)
    w = torch.randn((G, k, n), generator=gen, device=cuda).bfloat16()
    got = bg.block_gemm_batched(a, w)
    assert torch.equal(got, bg.block_gemm_batched(a, w.float()))
    want = bg.block_gemm_batched_plain(a, w)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ------------------------------------------------------------- paged decode --

def _paged_inputs(rng, page, H, K, D, lengths):
    B, maxp, n_pages = len(lengths), 3, 12
    perm = rng.permutation(n_pages)
    pt = np.stack([perm[3 * b:3 * b + maxp] for b in range(B)]) \
        .astype(np.int32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, K, D)).astype(np.float32)
    return q, kp, vp, pt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("page,H,K,D", [(16, 4, 2, 32), (8, 4, 4, 16)])
def test_paged_decode_plain_matches_pallas(page, H, K, D, rng):
    """Shuffled page tables, lengths off the page grid and a request of
    length 0 (all-zero output).  2e-4: f32 sums in another order (the
    reference's own tolerance for this kernel)."""
    lengths = [page * 3 - 4, 0, page, 2 * page + 3]
    q, kp, vp, pt, ln = _paged_inputs(rng, page, H, K, D, lengths)
    want = np.asarray(jops.gqa_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ln)))
    got = ops.gqa_flash_decode_paged(*(torch.from_numpy(x) for x in
                                       (q, kp, vp, pt, ln)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert not got[1].any()


def test_paged_decode_plain_direct_kernel_layout(rng):
    """The (B, K, G, D) entry point itself against the Pallas kernel."""
    from repro.kernels import decode_attention as jdec
    q, kp, vp, pt, ln = _paged_inputs(rng, 8, 8, 2, 16, [20, 5, 0])
    qg = q.reshape(3, 2, 4, 16)
    want = np.asarray(jdec.flash_decode_paged(
        jnp.asarray(qg), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ln), interpret=True))
    got = dec.flash_decode_paged(*(torch.from_numpy(x) for x in
                                   (qg, kp, vp, pt, ln)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_on_card(cuda, dtype, rng):
    q, kp, vp, pt, ln = _paged_inputs(rng, 16, 32, 8, 128, [37, 0, 16, 41])
    args = [torch.from_numpy(x).to(cuda) for x in (q, kp, vp, pt, ln)]
    args[0] = args[0].reshape(4, 8, 4, 128)
    args[1], args[2] = args[1].to(TORCH_DT[dtype]), args[2].to(TORCH_DT[dtype])
    n0 = dec.launches
    got = dec.flash_decode_paged(*args)
    want = dec.flash_decode_paged_plain(*args)
    assert dec.launches == n0 + 1
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())
    assert not got[1].any()


def _paged_tables(rng, B, page, lengths, spare=3):
    """Page tables of ``lengths`` shuffled over a pool with ``spare`` pages
    more than the requests hold; a request's unused entries point at its
    last page."""
    maxp = max(1, -(-max(lengths) // page))
    n_pages = B * maxp + spare
    perm = rng.permutation(n_pages)
    return perm[:B * maxp].reshape(B, maxp).astype(np.int32), n_pages


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [4, 16, 64])
def test_paged_decode_plain_forced_split_matches_pallas(page, dtype, split,
                                                        rng):
    """The plain version cut at a forced split, against the Pallas
    ``flash_decode_paged`` in interpret mode: shuffled tables, ragged
    lengths (on and off the page and split grids) and a request of length
    0.  f32: sums in another order, 2e-4 (the reference's tolerance).
    bf16: the TPU kernel rounds p against each page's running max, the
    plain version against the split's, and both round the output: 2^-7 of
    the largest output (``FLASH_TOL``)."""
    B, K, G, D = 4, 2, 4, 32
    lengths = [0, 3 * page + 5, 200, 130]
    pt, n_pages = _paged_tables(rng, B, page, lengths)
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, page, K, D)).astype(np.float32)
              for _ in range(2))
    ln = np.asarray(lengths, np.int32)
    from repro.kernels import decode_attention as jdec
    want = np.asarray(jdec.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kp).astype(JAX_DT[dtype]),
        jnp.asarray(vp).astype(JAX_DT[dtype]), jnp.asarray(pt),
        jnp.asarray(ln), interpret=True).astype(jnp.float32))
    got = dec.flash_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kp).to(TORCH_DT[dtype]),
        torch.from_numpy(vp).to(TORCH_DT[dtype]), torch.from_numpy(pt),
        torch.from_numpy(ln), _split=split)
    assert got.dtype == TORCH_DT[dtype]
    assert not got[0].any()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        assert _rel_err(got.float().numpy(), want) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("page", [1, 3, 16, 100])
def test_paged_decode_plain_matches_dense_oracle(page, rng):
    """Pages of any size: the plain version at the split rule's cut against
    the dense gather oracle ``ref.paged_decode_ref`` (one softmax over the
    whole request), f32, 1e-5 of the largest output (the splits' combine is
    exact up to f32 rounding)."""
    B, K, G, D = 3, 2, 2, 16
    lengths = [301, 1, 150]
    pt, n_pages = _paged_tables(rng, B, page, lengths)
    q = torch.from_numpy(rng.standard_normal((B, K, G, D)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, page, K, D)).astype(np.float32)) for _ in range(2))
    args = (q, kp, vp, torch.from_numpy(pt),
            torch.as_tensor(lengths, dtype=torch.int32))
    got = dec.flash_decode_paged(*args)
    want = ref.paged_decode_ref(*args)
    assert dec.paged_splits(B, K, pt.shape[1] * page, G)[1] > 1
    assert _rel_err(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("B,K,S,G", [(4, 8, 32768, 4), (4, 8, 32, 4),
                                     (4, 8, 32, 2), (1, 1, 100000, 16),
                                     (64, 8, 200, 4), (2, 2, 5000, 8),
                                     (1, 8, 131072, 1), (4, 8, 32768, 24)])
def test_paged_splits_properties(B, K, S, G):
    """The split rule: splits are multiples of SPLIT_QUANTUM tokens, cover
    the table with the last one ragged (no empty split), hold their scores
    in PAGED_SCORE_BYTES, and give no more blocks than the aim
    (PAGED_BLOCKS) unless the score cap forces it, nor fewer than the aim
    unless the table runs out of 64-token splits; with G <= 8 and pages of
    16, two blocks of the fast route fit an SM."""
    split, ns = dec.paged_splits(B, K, S, G)
    assert split % dec.SPLIT_QUANTUM == 0 and split > 0
    assert split * ns >= S > split * (ns - 1)
    stride = dec.group_bucket(G) if G <= dec.GROUPS_MAX else G
    assert split == dec.SPLIT_QUANTUM \
        or 4 * split * stride <= dec.PAGED_SCORE_BYTES
    capped = 4 * (split + dec.SPLIT_QUANTUM) * stride \
        > dec.PAGED_SCORE_BYTES
    want = -(-dec.PAGED_BLOCKS // (B * K))
    assert ns <= want or capped
    aim = min(want, -(-S // dec.SPLIT_QUANTUM))
    assert (split - dec.SPLIT_QUANTUM) * aim < S or capped
    if G <= dec.GROUPS_MAX:
        for D, esz in ((64, 2), (128, 2), (128, 4), (256, 4), (8, 2)):
            smem = dec.paged_smem(G, D, esz, split, 16)
            assert smem <= dec.SMEM_MAX
            if G <= 8 and D * esz <= 256:
                assert 2 * (smem + 1024) <= 233472   # an SM's 228 KB


def test_paged_shared_constants_match_the_cuda_source():
    """The constants the paged wrapper shares with ``csrc/paged_decode.cu``
    (warps, ring depth and stage size, the fast route's caps, the shared-
    memory limit) and its shared-memory carve-up, read from the source as
    text."""
    import re
    from pathlib import Path
    src = (Path(dec.__file__).resolve().parents[1] / "csrc"
           / "paged_decode.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("CWARPS") == dec.PAGED_CWARPS
    assert 32 * const("CWARPS") + 32 == dec.PAGED_THREADS
    assert const("STAGES") == dec.PAGED_STAGES
    assert const("STAGE_BYTES") == dec.PAGED_STAGE_BYTES
    assert const("TILE_MAX") == dec.PAGED_TILE_MAX
    assert const("GROUPS_MAX") == dec.GROUPS_MAX
    assert const("D_MAX") == dec.PAGED_D_MAX
    assert const("ELEM_THREADS") == dec.PAGED_ELEM_THREADS
    assert const("SMEM_MAX") == dec.SMEM_MAX
    assert "enum Route { ELEMENT = 0, TMA = 1 };" in src
    # the TMA box: a divisor of the page and of the tiles' offsets
    assert "const int box = gcd_int(page, geo.tk < 64 ? geo.tk : 64);" in src
    assert "int t = STAGE_BYTES / rowb;" in src
    assert "if (t > TILE_MAX) t = TILE_MAX;" in src
    # the fast route: region, then (split, GB) + (GB, D) + 2 (CWARPS, GB)
    # floats, 2 STAGES mbarriers, the split's page ids
    assert "max(STAGES * STAGE_BYTES, CTHREADS * 16 * G)" in src
    assert "reinterpret_cast<float4*>(sc + split * GB)" in src
    assert "float* wred = reinterpret_cast<float*>(qs4) + GB * D;" in src
    assert "float* lred = wred + CWARPS * GB;" in src
    assert "reinterpret_cast<uint64_t*>(lred + CWARPS * GB)" in src
    assert "reinterpret_cast<int*>(bars + 2 * STAGES)" in src
    # the element route: (G, D) + (split, G) + 2 G floats, the page ids
    assert "float* sc = qs + G * D;" in src
    assert "float* mg = sc + split * G;" in src
    assert "reinterpret_cast<int*>(lg + G)" in src
    # a split touches at most (split - 1) / page + 2 pages
    for split in (64, 128, 3648):
        for page in (1, 3, 16, 64, 256):
            spans = {(t0 + n - 1) // page - t0 // page + 1
                     for t0 in range(0, 4 * page + split, 64)
                     for n in (1, split)}
            assert max(spans) <= dec.paged_pages(split, page)


def test_paged_route_rule_and_any_page_size():
    """The fast route takes 16-byte rows of aligned pools with G <= 16 and
    D <= 256 whose TMA boxes start on 128 bytes; anything else goes to the
    element route.  Pages of 256
    tokens (refused before: 48 KB) fit either route at llama's heads."""
    def pools(dtype, D, offset=0):
        buf = torch.zeros(2 * 4 * 2 * D + offset, dtype=dtype)
        return buf[offset:].view(2, 4, 2, D)
    kp = pools(torch.bfloat16, 128)
    assert dec._paged_fast_route(kp, kp, 4, 128)
    assert dec._paged_fast_route(kp, kp, 16, 128)
    assert not dec._paged_fast_route(kp, kp, 17, 128)
    assert not dec._paged_fast_route(pools(torch.bfloat16, 128, 1),
                                     pools(torch.bfloat16, 128, 1), 4, 128)
    assert not dec._paged_fast_route(pools(torch.float32, 6),
                                     pools(torch.float32, 6), 4, 6)
    assert not dec._paged_fast_route(pools(torch.float32, 260),
                                     pools(torch.float32, 260), 4, 260)
    # TMA boxes start on 128 bytes: rows of 160 bytes need boxes of 4 rows
    kp80 = torch.zeros((2, 16, 2, 80), dtype=torch.bfloat16)
    assert dec.paged_box(16, 80, 2) == 16
    assert dec._paged_fast_route(kp80, kp80, 4, 80)
    kp80 = torch.zeros((40, 1, 2, 80), dtype=torch.bfloat16)
    assert dec.paged_box(1, 80, 2) == 1
    assert not dec._paged_fast_route(kp80, kp80, 4, 80)
    assert [dec.paged_box(p, 128, 2) for p in (1, 3, 16, 64, 100, 256)] \
        == [1, 1, 16, 64, 4, 64]
    assert dec.paged_box(256, 128, 4) == 32
    split, _ = dec.paged_splits(4, 8, 32768, 4)
    for page in (16, 64, 256, 1):
        assert dec.paged_smem(4, 128, 2, split, page) <= dec.SMEM_MAX
        assert dec.paged_element_smem(4, 128, split, page) <= dec.SMEM_MAX


def test_paged_decode_wrapper_never_falls_back(monkeypatch):
    """On a device other than the CPU the wrapper launches or raises: the
    plain version is never its way out."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(dec, "flash_decode_paged_plain", refuse)
    q = torch.empty((2, 2, 4, 16), device="meta")
    kv = torch.empty((8, 16, 2, 16), device="meta")
    pt = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    ln = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dec.flash_decode_paged(q, kv, kv, pt, ln)
    with pytest.raises(ValueError):      # pools that do not fit q
        dec.flash_decode_paged(q, kv[..., :8], kv[..., :8], pt, ln)
    with pytest.raises(ValueError):      # operands on two devices
        dec.flash_decode_paged(torch.zeros(2, 2, 4, 16), kv, kv, pt, ln)


def _paged_case_on(dev, gen, B, K, G, D, page, lengths, dtype, spare=5,
                   offset=0):
    """Card inputs: tables shuffled over a pool of ``spare`` pages more
    than the requests hold; ``offset`` elements shift both pools off the
    16-byte grid."""
    maxp = max(1, -(-max(lengths) // page))
    n_pages = B * maxp + spare
    pt = torch.randperm(n_pages, generator=gen, device=dev)[:B * maxp] \
        .reshape(B, maxp).to(torch.int32).contiguous()
    q = torch.randn((B, K, G, D), generator=gen, device=dev)
    n = n_pages * page * K * D

    def pool():
        buf = torch.randn((n + offset,), generator=gen, device=dev).to(dtype)
        return buf[offset:].view(n_pages, page, K, D)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return q, pool(), pool(), pt, ln


def _check_paged_on_card(args, dtype, element=False, split=None):
    """The kernel against the plain version cut alike (FLASH_TOL), two
    launches equal bit for bit, both counted on the expected route."""
    n0, e0 = dec.launches, dec.paged_element_launches
    got = dec.flash_decode_paged(*args, _split=split)
    again = dec.flash_decode_paged(*args, _split=split)
    assert dec.launches == n0 + 2
    assert dec.paged_element_launches == e0 + 2 * element
    want = dec.flash_decode_paged_plain(*args, split=split)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())
    assert torch.equal(got, again)
    for b in range(args[4].shape[0]):
        if int(args[4][b]) == 0:
            assert not got[b].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [1, 3, 16, 64, 100, 256])
def test_paged_decode_pages_on_card(cuda, page, dtype):
    """B3 at pages of any size (a tile spans several pages or part of
    one), ragged lengths over several splits and a request of length 0,
    all on the fast route."""
    gen = torch.Generator(device=cuda).manual_seed(page)
    args = _paged_case_on(cuda, gen, 4, 8, 4, 128, page,
                          [1000, 0, 3 * page + 7, 2500], TORCH_DT[dtype])
    _check_paged_on_card(args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [32, 64, 80, 128, 256])
def test_paged_decode_groups_dims_on_card(cuda, D, G, dtype):
    """The fast route at G 1-16 and D 32-256 (80: rows of 10 or 20
    chunks), f32 and bf16, one split and several."""
    gen = torch.Generator(device=cuda).manual_seed(G * D)
    args = _paged_case_on(cuda, gen, 3, 2, G, D, 16, [40, 3000, 1],
                          TORCH_DT[dtype])
    _check_paged_on_card(args, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["misaligned", "groups24", "d6", "d260",
                                  "box160"])
def test_paged_decode_element_route_on_card(cuda, case, dtype):
    """Pools off the fast route's rule take the element route: pools off
    the 16-byte grid, G over 16, rows under 16 bytes, D over 256, TMA boxes
    off 128 bytes (one-token pages of D 80); the same results as the plain
    version, counted on that route."""
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    G, D, offset, page = {
        "misaligned": (4, 128, 1, 16), "groups24": (24, 64, 0, 16),
        "d6": (4, 6, 0, 16), "d260": (2, 260, 0, 16),
        "box160": (4, 80, 0, 1)}[case]
    args = _paged_case_on(cuda, gen, 3, 2, G, D, page, [700, 0, 33],
                          TORCH_DT[dtype], offset=offset)
    _check_paged_on_card(args, dtype, element=True)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [64, 256, 1024, 3648])
def test_paged_decode_forced_split_on_card(cuda, split):
    """The split sweep's knob: every forced split against the plain version
    cut alike (bf16, G 4, D 128, pages of 16)."""
    gen = torch.Generator(device=cuda).manual_seed(split)
    args = _paged_case_on(cuda, gen, 2, 4, 4, 128, 16, [6000, 4097],
                          torch.bfloat16)
    _check_paged_on_card(args, "bfloat16", split=split)


# ---------------------------------------------------------- flash attention --

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# f32: the same arithmetic summed in another order.  bf16: the output is
# rounded to bf16, so one unit in the last place of the largest output.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _qkv(rng, B, Sq, Sk, H, K, D):
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32),
            rng.standard_normal((B, Sk, K, D)).astype(np.float32))


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("S,H,K,D,window", [
    (128, 4, 4, 32, 0), (256, 4, 2, 32, 0), (256, 8, 2, 64, 64),
    (128, 2, 1, 16, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_flash_plain_matches_pallas(S, H, K, D, window, dtype, rng):
    """``ops.mha_flash`` (CPU: the plain version, GQA by index) against the
    Pallas kernel in interpret mode, which repeats k and v per group."""
    q, k, v = _qkv(rng, 2, S, S, H, K, D)
    want = jops.mha_flash(*(jnp.asarray(x, JAX_DT[dtype]) for x in (q, k, v)),
                          causal=True, window=window, bq=64, bk=64)
    got = ops.mha_flash(*(torch.from_numpy(x).to(TORCH_DT[dtype])
                          for x in (q, k, v)), causal=True, window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (2, S, H, D)
    assert _rel_err(got.float().numpy(), want) <= FLASH_TOL[dtype]


@pytest.mark.parametrize("Sq,Sk,G,causal,window", [
    (64, 64, 1, True, 0), (48, 48, 4, True, 16), (15, 15, 4, True, 0),
    (40, 72, 2, False, 0), (100, 100, 8, True, 33)])
def test_flash_attention_plain_matches_attention_ref(Sq, Sk, G, causal,
                                                     window, rng):
    """The (BH, S, D) entry point against the naive oracles of both
    packages (k and v repeated per group for them); ragged lengths and a
    non-causal case included.  f32, 1e-5 of the largest output."""
    BHk, D = 3, 32
    q = rng.standard_normal((BHk * G, Sq, D)).astype(np.float32)
    k = rng.standard_normal((BHk, Sk, D)).astype(np.float32)
    v = rng.standard_normal((BHk, Sk, D)).astype(np.float32)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window, groups=G)
    kr, vr = np.repeat(k, G, axis=0), np.repeat(v, G, axis=0)
    want_j = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(kr),
                                           jnp.asarray(vr), causal=causal,
                                           window=window))
    want_t = ref.attention_ref(*(torch.from_numpy(x) for x in (q, kr, vr)),
                               causal=causal, window=window)
    assert _rel_err(got.numpy(), want_j) <= 1e-5
    assert _rel_err(want_t.numpy(), want_j) <= 1e-5


@pytest.mark.parametrize("q_offset", [0, 24, -5])
def test_flash_q_offset_matches_reference_chunked(q_offset, rng):
    """``q_offset`` shifts query positions as the reference's
    ``chunked_attention`` does; rows that see no key (negative offsets,
    causal) come out as zeros in both."""
    q, k, v = _qkv(rng, 2, 16, 40, 4, 2, 32)
    want = np.asarray(jattn.chunked_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, window=12,
        q_offset=q_offset, q_chunk=8, k_chunk=8))
    got = ops.mha_flash(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=True, window=12, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if q_offset < 0:
        assert not got[:, :-q_offset].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_function_grad_matches_plain_autograd(dtype, rng):
    """The model's attention (flash forward, recomputed-reference
    backward) against autograd through the plain chunked body, and the
    reference's ``jax.grad`` of ``chunked_attention``."""
    import jax
    q, k, v = _qkv(rng, 2, 32, 32, 4, 2, 16)
    g = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    opts = dict(causal=True, window=20, q_chunk=8, k_chunk=8)

    def grads(fn):
        ts = [torch.from_numpy(x).to(TORCH_DT[dtype]).requires_grad_()
              for x in (q, k, v)]
        out = fn(*ts)
        return out.detach(), torch.autograd.grad(
            out, ts, torch.from_numpy(g).to(out.dtype))

    out, got = grads(lambda *t: attn.chunked_attention(*t, **opts))
    out_p, want = grads(lambda *t: attn._chunked_reference(
        *t, q_offset=0, **opts).to(t[2].dtype))
    assert out.dtype == TORCH_DT[dtype]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert _rel_err(out.float().numpy(), out_p.float().numpy()) <= tol
    for a, b in zip(got, want):
        assert a.dtype == TORCH_DT[dtype]
        assert _rel_err(a.float().numpy(), b.float().numpy()) <= tol
    if dtype == "float32":
        _, vjp = jax.vjp(lambda *t: jattn.chunked_attention(*t, **opts),
                         *(jnp.asarray(x) for x in (q, k, v)))
        for a, b in zip(got, vjp(jnp.asarray(g))):
            assert _rel_err(a.numpy(), np.asarray(b)) <= 1e-4


def test_flash_wrapper_never_falls_back():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises; shapes that do not fit raise everywhere."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    kv = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError):
        ops.mha_flash(q, kv, kv)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(4, 8, 16), torch.zeros(3, 8, 16),
                           torch.zeros(3, 8, 16), groups=1)
    with pytest.raises(ValueError):
        ops.mha_flash(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                      torch.zeros(1, 8, 2, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,K,D,window", [(128, 32, 8, 128, 0),
                                            (15, 32, 8, 128, 0),
                                            (200, 16, 2, 64, 64)])
def test_flash_kernel_on_card(cuda, S, H, K, D, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, S, n, D), generator=gen, device=cuda)
               .to(TORCH_DT[dtype]) for n in (H, K, K))
    n0 = fa.launches
    got = ops.mha_flash(q, k, v, causal=True, window=window)
    assert fa.launches == n0 + 1
    want = torch.empty_like(got)
    want.copy_(fa._attend_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window, q_offset=0).transpose(1, 2))
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset", [-5, 24])
@pytest.mark.parametrize("G,D", [(1, 64), (2, 128), (4, 128), (8, 64),
                                 (4, 80), (1, 100)])
def test_flash_kernel_groups_offsets_on_card(cuda, G, D, q_offset, dtype):
    """The kernel's blocks over the G query heads of a kv head, at head
    dims on and off its 32-column grid, with a window and a query offset
    (negative: the first rows see no key and come out as zeros), against
    the plain version: 1e-5 in f32, 2^-7 in bf16."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, Sq, Sk, K = 2, 70, 100, 2
    q, k, v = (torch.randn((B, n, S, D), generator=gen, device=cuda)
               .to(TORCH_DT[dtype]) for n, S in ((G * K, Sq), (K, Sk),
                                                 (K, Sk)))
    opts = dict(causal=True, window=40, q_offset=q_offset)
    got = fa.attend(q, k, v, torch.empty_like(q), **opts)
    want = fa._attend_plain(q, k, v, **opts)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


# ------------------------------------------------- contiguous-cache decode --

def _decode_inputs(rng, B, S, H, K, D):
    return (rng.standard_normal((B, 1, H, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32))


@pytest.mark.parametrize("S,H,K,D,n_valid", [(256, 4, 2, 32, 256),
                                             (512, 2, 2, 64, 300),
                                             (128, 4, 1, 16, 60)])
def test_flash_decode_plain_matches_pallas(S, H, K, D, n_valid, rng):
    """The reference's kernel test shapes: the plain version (what the
    wrapper runs on the CPU) against the Pallas ``flash_decode`` in
    interpret mode and against both packages' ``decode_attention``.  2e-4:
    f32 sums in another order (the reference's tolerance)."""
    q, k, v = _decode_inputs(rng, 2, S, H, K, D)
    valid = np.arange(S) < n_valid
    jargs = [jnp.asarray(x) for x in (q, k, v, valid)]
    args = [torch.from_numpy(x) for x in (q, k, v, valid)]
    got = ops.gqa_flash_decode(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, H, D)
    for want in (jops.gqa_flash_decode(*jargs, bs=64),
                 jattn.decode_attention(*jargs),
                 attn.decode_attention(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,H,K,D", [(24, 32, 8, 32), (3000, 4, 1, 16)])
def test_flash_decode_plain_per_request_mask(S, H, K, D, rng):
    """A per-request (B, Smax) occupancy mask (the serving path's), one
    split (S = 24) and many (S = 3000, 47 splits combined): against the
    reference's ``decode_attention``, 2e-4."""
    B = 3
    q, k, v = _decode_inputs(rng, B, S, H, K, D)
    lens = np.asarray([S, 1, S // 2 + 3])
    valid = np.arange(S)[None, :] < lens[:, None]
    assert dec.decode_splits(B, K, S)[1] == (1 if S == 24 else 47)
    want = jattn.decode_attention(*(jnp.asarray(x) for x in (q, k, v, valid)))
    got = dec.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_decode_all_masked_row_gives_zeros(rng):
    """A request with no valid slot: zeros from the kernel's plain version
    (as from the TPU kernel), the mean of V from ``decode_attention`` (a
    uniform softmax over -1e30 scores).  ``decode_step`` never forms such
    a row, since n_valid = min(pos + 1, cache_len) >= 1."""
    q, k, v = (torch.from_numpy(x) for x in _decode_inputs(rng, 2, 16, 4, 2,
                                                           8))
    valid = torch.ones((2, 16), dtype=torch.bool)
    valid[1] = False
    got = dec.flash_decode_plain(q, k, v, valid)
    assert not got[1].any() and got[0].abs().sum() > 0
    mean_v = attn.decode_attention_plain(q, k, v, valid)[1, 0]
    torch.testing.assert_close(
        mean_v, v[1].mean(dim=0).repeat_interleave(2, dim=0), rtol=1e-5,
        atol=1e-6)


def test_flash_decode_bf16_rounds_like_the_tpu_kernel(rng):
    """In bf16 the plain version rounds where the TPU kernel does (p before
    the V product): against the Pallas kernel in interpret mode at one
    split of 64 (its block), within one bf16 unit of the largest
    output."""
    q, k, v = _decode_inputs(rng, 2, 64, 4, 2, 32)
    valid = np.arange(64) < 50
    kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (k, v))
    want = np.asarray(jops.gqa_flash_decode(jnp.asarray(q), kb, vb,
                                            jnp.asarray(valid), bs=64),
                      np.float32)
    got = ops.gqa_flash_decode(torch.from_numpy(q),
                               torch.from_numpy(k).bfloat16(),
                               torch.from_numpy(v).bfloat16(),
                               torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(), want) <= 2.0 ** -7


def test_flash_decode_wrapper_never_falls_back():
    q = torch.empty((1, 1, 4, 16), device="meta")
    kv = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        dec.flash_decode(q, kv, kv, torch.ones(8, dtype=torch.bool,
                                               device="meta"))
    with pytest.raises(ValueError):
        dec.flash_decode(torch.zeros(1, 1, 3, 16), torch.zeros(1, 8, 2, 16),
                         torch.zeros(1, 8, 2, 16),
                         torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        dec.flash_decode(torch.zeros(1, 1, 4, 16), torch.zeros(1, 8, 2, 16),
                         torch.zeros(1, 8, 2, 16),
                         torch.ones(7, dtype=torch.bool))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D", [(4, 24, 32, 8, 128),
                                       (2, 5000, 16, 2, 64)])
def test_flash_decode_kernel_on_card(cuda, B, S, H, K, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, 1, H, D), generator=gen, device=cuda)
    k, v = (torch.randn((B, S, K, D), generator=gen, device=cuda)
            .to(TORCH_DT[dtype]) for _ in range(2))
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=cuda)
    valid = torch.arange(S, device=cuda)[None, :] < lens[:, None]
    n0 = dec.flash_decode_launches
    got = dec.flash_decode(q, k, v, valid)
    assert dec.flash_decode_launches == n0 + 1
    want = dec.flash_decode_plain(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())


@pytest.mark.parametrize("B,K,S", [(4, 8, 32), (4, 8, 32768), (1, 8, 4096),
                                   (2, 2, 5000), (3, 1, 3000), (1, 1, 1),
                                   (64, 8, 200), (1, 1, 100000)])
def test_decode_splits_properties(B, K, S):
    """The split rule: splits are multiples of SPLIT_QUANTUM slots, at most
    SPLIT_MAX, cover the cache with the last one ragged (no empty split),
    and a block's shared memory fits at every group count the kernel
    takes."""
    split, ns = dec.decode_splits(B, K, S)
    assert split % dec.SPLIT_QUANTUM == 0 and 0 < split <= dec.SPLIT_MAX
    assert split * ns >= S > split * (ns - 1)
    for G in (1, 2, 4, 8, 16):
        for D, esz in ((64, 2), (128, 2), (128, 4), (256, 4), (8, 2)):
            assert dec.decode_smem(G, D, esz, split) <= dec.SMEM_MAX


def test_decode_shared_constants_match_the_cuda_source():
    """The constants the flash-decode wrapper shares with
    ``csrc/flash_decode.cu`` (threads, ring depth, slices a thread copies,
    the group cap and the shared-memory limit), and its shared-memory
    size, read from the source as text."""
    import re
    from pathlib import Path
    src = (Path(dec.__file__).resolve().parents[1] / "csrc"
           / "flash_decode.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("THREADS") == dec.THREADS
    assert const("STAGES") == dec.STAGES
    assert const("STAGE_CHUNKS") == dec.STAGE_CHUNKS
    assert const("GROUPS_MAX") == dec.GROUPS_MAX
    assert const("SMEM_MAX") == dec.SMEM_MAX
    # the kernel's carve-up: region, then (split, GB) + (GB, DP) + (2,
    # WARPS, GB) floats, WARPS ints, split mask bytes
    assert "float* qs = sc + split * GB;" in src
    assert "float* wred = qs + GB * DP;" in src
    assert "int* wlast = reinterpret_cast<int*>(wred + 2 * WARPS * GB);" \
        in src
    assert "ok = reinterpret_cast<unsigned char*>(wlast + WARPS);" in src
    assert "max(STAGES * geo.stage, THREADS * 16 * G)" in src
    # 32k cell, G 4, D 128, bf16: the ring (64 KB) and 2 blocks an SM
    split, _ = dec.decode_splits(4, 8, 32768)
    assert dec.decode_smem(4, 128, 2, split) <= 113 * 1024


@pytest.mark.parametrize("split", [64, 192, 1024])
def test_flash_decode_plain_forced_split(split, rng):
    """A forced split (the split sweep's) cuts the plain version alike:
    against the reference's ``decode_attention``, 2e-4."""
    B, S, H, K, D = 2, 1000, 8, 2, 32
    q, k, v = _decode_inputs(rng, B, S, H, K, D)
    valid = np.arange(S)[None, :] < np.asarray([S, 333])[:, None]
    want = jattn.decode_attention(*(jnp.asarray(x) for x in (q, k, v, valid)))
    got = dec.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, valid)),
                           _split=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def _decode_case(dev, gen, B, S, H, K, D, dtype, lens, per_request,
                 strided):
    q = torch.randn((B, 1, H, D), generator=gen, device=dev)
    if strided:     # a layer of a stacked (L, B, Smax, K, D) cache, and
        # a (B, Smax, 2K, D) buffer whose K heads are every other one
        kv = torch.randn((2, B, S, 2 * K, D), generator=gen, device=dev) \
            .to(dtype)
        k, v = kv[0, :, :, ::2], kv[1, :, :, 1::2]
    else:
        k, v = (torch.randn((B, S, K, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
    ln = torch.as_tensor(lens, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < ln[:, None]
    if not per_request:
        valid = valid[0]
    return q, k, v, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["one_split", "many_splits", "shared_mask",
                                  "strided"])
def test_flash_decode_groups_masks_strides_on_card(cuda, case, D, G, dtype):
    """B5 at G 1-16, D 64 and 128, f32 and bf16: one split (Smax 40) and
    many (Smax 5000), lengths 1 and Smax, a per-request or a shared mask,
    a strided cache view; against the plain version at its tolerance, the
    launch counted on the route the strides pick, and two launches equal
    bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(G * D)
    K = 2
    B, S = (3, 40) if case == "one_split" else (3, 5000)
    lens = [1, S, S // 2 + 3] if case != "shared_mask" else [S - 7] * 3
    q, k, v, valid = _decode_case(cuda, gen, B, S, G * K, K, D,
                                  TORCH_DT[dtype], lens,
                                  case != "shared_mask", case == "strided")
    n0, e0 = dec.flash_decode_launches, dec.flash_decode_element_launches
    got = dec.flash_decode(q, k, v, valid)
    again = dec.flash_decode(q, k, v, valid)
    assert dec.flash_decode_launches == n0 + 2
    assert dec.flash_decode_element_launches == e0
    want = dec.flash_decode_plain(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [2, 4, 16, 256])
def test_flash_decode_element_route_on_card(cuda, D, dtype):
    """Caches off the 16-byte rule (an odd slot stride, or rows under 16
    bytes) take the element route: the same results as the plain version,
    counted on that route; a bf16 query is read as it lies."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    B, S, K, G = 2, 300, 2, 4
    buf = torch.randn((B, S, K * D + 1), generator=gen, device=cuda) \
        .to(TORCH_DT[dtype])
    k = buf[:, :, :K * D].unflatten(2, (K, D))
    v = buf[:, :, 1:].unflatten(2, (K, D))
    q = torch.randn((B, 1, G * K, D), generator=gen, device=cuda) \
        .to(TORCH_DT[dtype])
    valid = torch.arange(S, device=cuda)[None, :] < torch.as_tensor(
        [S, 17], device=cuda)[:, None]
    e0 = dec.flash_decode_element_launches
    got = dec.flash_decode(q, k, v, valid)
    assert dec.flash_decode_element_launches == e0 + 1
    want = dec.flash_decode_plain(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL[dtype] * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("split", [256, 512, 2048, 4096])
def test_flash_decode_forced_split_on_card(cuda, split):
    """The split sweep's knob: every forced split against the plain version
    cut alike (bf16, G 4, D 128)."""
    gen = torch.Generator(device=cuda).manual_seed(split)
    q, k, v, valid = _decode_case(cuda, gen, 2, 6000, 16, 4, 128,
                                  torch.bfloat16, [6000, 4097], True, False)
    got = dec.flash_decode(q, k, v, valid, _split=split)
    want = dec.flash_decode_plain(q, k, v, valid, split=split)
    err = float((got.float() - want.float()).abs().max())
    assert err <= FLASH_TOL["bfloat16"] * float(want.float().abs().max())


# -------------------------------------------------------------------- WKV --

def _wkv_args(rng, B, S, H, hd):
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)] \
        + [rng.uniform(0.1, 0.999, (B, S, H, hd)).astype(np.float32),
           rng.standard_normal((H, hd)).astype(np.float32)]


def _flat_bh(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("S,H,hd,chunk", [(64, 2, 16, 16), (128, 1, 32, 32),
                                          (96, 2, 16, 32)])
def test_wkv6_plain_matches_pallas_and_ref(S, H, hd, chunk, rng):
    """The reference's kernel test shapes: the plain version (what the
    wrapper runs on the CPU) against the Pallas ``wkv6`` in interpret mode
    over the same chunks (1e-5 of the largest output: f32 sums in another
    order) and, with both packages' step-exact oracles, at the
    reference's own 1e-4 relative / 1e-3 absolute."""
    B = 2
    r, k, v, w, u = _wkv_args(rng, B, S, H, hd)
    jy = np.asarray(jops.wkv6(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                              chunk=chunk))
    y, s_last = ops.wkv6(*(torch.from_numpy(x) for x in (r, k, v, w, u)),
                         chunk=chunk)
    assert y.dtype == s_last.dtype == torch.float32
    assert tuple(s_last.shape) == (B, H, hd, hd)
    assert _rel_err(y.numpy(), jy) <= 1e-5
    uu = np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd)
    flat = [_flat_bh(x) for x in (r, k, v, w)]
    jwant = np.asarray(jref.wkv6_ref(*(jnp.asarray(x) for x in flat),
                                     jnp.asarray(uu)))
    want = ref.wkv6_ref(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in flat), torch.from_numpy(uu.copy()))
    np.testing.assert_allclose(want.numpy(), jwant, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_flat_bh(y.numpy()), jwant, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("S,chunk", [(1, 32), (45, 32), (45, 16), (7, 4)])
def test_wkv6_plain_ragged_chunks_and_state(S, chunk, rng):
    """Any S: the last chunk ragged (and S = 1, the decode step), from a
    random incoming state: y and the last state against the step-exact
    recurrence run from that state (1e-4 relative / 1e-3 absolute, the
    reference's bar for chunked against step-exact)."""
    B, H, hd = 2, 2, 16
    r, k, v, w, u = (torch.from_numpy(x) for x in _wkv_args(rng, B, S, H,
                                                            hd))
    s0 = torch.from_numpy(rng.standard_normal((B, H, hd, hd))
                          .astype(np.float32))
    y, s_last = ops.wkv6(r, k, v, w, u, s0=s0, chunk=chunk)
    s = s0.clone()
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        yt = torch.einsum("bhd,bhde->bhe", r[:, t], s + u[None, :, :, None]
                          * kv)
        np.testing.assert_allclose(y[:, t].numpy(), yt.numpy(), rtol=1e-4,
                                   atol=1e-3)
        s = w[:, t, :, :, None] * s + kv
    np.testing.assert_allclose(s_last.numpy(), s.numpy(), rtol=1e-4,
                               atol=1e-3)


def test_wkv6_wrapper_never_falls_back():
    x = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError):
        ops.wkv6(x, x, x, x, torch.empty((2, 16), device="meta"))
    z = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError):
        ops.wkv6(z, z, z, z, torch.zeros(2, 8))
    with pytest.raises(ValueError):
        ops.wkv6(z, z, z, z, torch.zeros(2, 16), s0=torch.zeros(1, 2, 8, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_state", [(128, False), (100, True),
                                          (1, True)])
def test_wkv6_kernel_on_card(cuda, S, with_state, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, H, hd = 2, 8, 64
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=cuda)
               .to(TORCH_DT[dtype]) for _ in range(3))
    w = torch.rand((B, S, H, hd), generator=gen, device=cuda) * 0.9 + 0.05
    u = torch.randn((H, hd), generator=gen, device=cuda)
    s0 = torch.randn((B, H, hd, hd), generator=gen, device=cuda) \
        if with_state else None
    n0 = wkv.launches
    y, s_last = wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
    assert wkv.launches == n0 + 1
    yp, sp = wkv.wkv6_plain(r, k, v, w, u, s0, chunk=32)
    for got, want in ((y, yp), (s_last, sp)):
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("cut", [1, 31, 32, 33, 99])
def test_wkv6_state_carries_across_calls(cut, rng):
    """A prefill of 100 steps cut in two calls, the second from the first's
    last state (as serving runs a prompt, then decode steps): y and the
    last state equal one call's over the 100 steps up to the rounding of
    the shifted chunk bounds (1e-5 of the largest value)."""
    B, S, H, hd = 2, 100, 2, 16
    r, k, v, w, u = (torch.from_numpy(x) for x in _wkv_args(rng, B, S, H,
                                                            hd))
    s0 = torch.from_numpy(rng.standard_normal((B, H, hd, hd))
                          .astype(np.float32))
    y, s_last = ops.wkv6(r, k, v, w, u, s0=s0)
    y1, s1 = ops.wkv6(*(x[:, :cut] for x in (r, k, v, w)), u, s0=s0)
    y2, s2 = ops.wkv6(*(x[:, cut:] for x in (r, k, v, w)), u, s0=s1)
    assert _rel_err(torch.cat([y1, y2], dim=1).numpy(), y.numpy()) <= 1e-5
    assert _rel_err(s2.numpy(), s_last.numpy()) <= 1e-5


def test_wkv_shared_constants_match_the_cuda_source():
    """The constants the WKV wrapper shares with ``csrc/wkv6.cu`` and the
    block's shared memory (the ``Smem`` struct, read from the source as
    text): four bf16 blocks fit an SM's 228 KB."""
    import re
    from pathlib import Path
    src = (Path(wkv.__file__).resolve().parents[1] / "csrc"
           / "wkv6.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+)", src)[1]
                   .replace("MAXHD", str(wkv.MAX_HD)))
    assert const("THREADS") == wkv.THREADS
    assert const("MAXT") == wkv.MAX_CHUNK
    assert const("MAXHD") == wkv.MAX_HD
    assert "constexpr int WP = MAXHD + 4;" in src
    body = re.search(r"struct Smem \{(.*?)\};", src, re.S)[1]
    fields = re.findall(r"(T|float) (\w+)((?:\[[^\]]+\])+);", body)
    assert [f[1] for f in fields] == ["r", "k", "v", "w", "vf", "rw", "kd",
                                      "A", "dec", "u"]
    env = {"MAXT": wkv.MAX_CHUNK, "MAXHD": wkv.MAX_HD, "WP": wkv.MAX_HD + 4}
    for esz in (2, 4):
        size = 0
        for typ, _, dims in fields:
            count = 1
            for d in re.findall(r"\[([^\]]+)\]", dims):
                count *= eval(d, {}, env)
            size += count * (esz if typ == "T" else 4)
        assert size == wkv.wkv_smem(esz)
    assert 4 * (wkv.wkv_smem(2) + 1024) <= 228 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 7, 32, 100, 128])
def test_wkv6_shapes_on_card(cuda, S, hd, dtype):
    """B6 at S 1, 7, 32, 100 and 128 and hd 16, 32 and 64, from a zero and
    a random incoming state: y and the last state within 1e-5 of the plain
    version, and two launches equal bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(S * hd)
    B, H = 2, 3
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=cuda)
               .to(TORCH_DT[dtype]) for _ in range(3))
    w = torch.rand((B, S, H, hd), generator=gen, device=cuda) * 0.9 + 0.05
    u = torch.randn((H, hd), generator=gen, device=cuda)
    for s0 in (None, torch.randn((B, H, hd, hd), generator=gen,
                                 device=cuda)):
        yp, sp = wkv.wkv6_plain(r, k, v, w, u, s0, chunk=32)
        n0 = wkv.launches
        y, s_last = wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
        assert wkv.launches == n0 + 1
        for got, want in ((y, yp), (s_last, sp)):
            assert float((got - want).abs().max()) \
                <= 1e-5 * float(want.abs().max())
        y2, s2 = wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
        assert torch.equal(y, y2) and torch.equal(s_last, s2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False])
def test_wkv6_strided_inputs_on_card(cuda, aligned, dtype):
    """Strided (B, S, H, hd) views, as a fused projection gives them: on
    16-byte strides the cp.async route, off them the element route (each
    counted); both within 1e-5 of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(int(aligned))
    B, S, H, hd = 2, 45, 4, 64
    extra = 0 if aligned else 1
    buf = torch.randn((B, S, H, 3 * hd + extra), generator=gen, device=cuda) \
        .to(TORCH_DT[dtype])
    r, k, v = (buf[..., i * hd + extra:(i + 1) * hd + extra]
               for i in range(3))
    wbuf = torch.rand((B, S, H, 2 * hd), generator=gen, device=cuda) \
        * 0.9 + 0.05
    w = wbuf[..., hd:]
    u = torch.randn((H, hd), generator=gen, device=cuda)
    s0 = torch.randn((B, H, hd, hd), generator=gen, device=cuda)
    e0 = wkv.element_launches
    y, s_last = wkv.wkv6(r, k, v, w, u, s0=s0, chunk=32)
    assert wkv.element_launches == e0 + (0 if aligned else 1)
    yp, sp = wkv.wkv6_plain(r, k, v, w, u, s0, chunk=32)
    for got, want in ((y, yp), (s_last, sp)):
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
