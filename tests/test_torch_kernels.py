"""The port's kernels against the reference's Pallas kernels (interpret
mode on the CPU).  Here the wrappers run their plain versions, since the
tensors lie on the CPU; the ``gpu``-marked tests hold the CUDA kernels
against the same plain versions on a card and skip elsewhere."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_gemm as jbg
from repro.kernels import ops as jops
from repro_torch.kernels import block_gemm as bg
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops

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
    tol = 2e-4 if dtype == "float32" else 1e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert not got[1].any()
