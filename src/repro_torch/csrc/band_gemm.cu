// Band GEMM for Hopper: C[g] = A[g] · B[g], f32 accumulation, f32 output.
//
// One template, three C entry points, one for each Pallas GEMM kernel of
// src/repro/kernels/block_gemm.py:
//
//   band_gemm_{f32,bf16}          replaces block_gemm_batched_shared (:59,
//                                 body `_batched_shared_b_kernel`): G row
//                                 bands of one padded height multiply ONE
//                                 shared right operand (B batch stride 0).
//                                 It is the compute kernel of every fleet
//                                 GEMM (`kernels/ops._band_matmul`).
//   block_gemm_batched_{f32,bf16} replaces block_gemm_batched (:92, body
//                                 `_batched_matmul_kernel`): G independent
//                                 products, B batch stride > 0. It runs the
//                                 MoE routed experts (`ops.expert_matmul`:
//                                 one product per expert, forward, dA, dW).
//   block_gemm_{f32,bf16}         replaces block_gemm (:125, body
//                                 `_matmul_kernel`): the plain product, G = 1
//                                 (`ops.block_gemm`).
//
// What bounds them on an H100. Band GEMM: at the decode shapes of the
// serving path a band is 4 real rows padded to 128, against a B of up to
// 4096 x 128256; streaming B once is the least the card must do (bytes /
// memory rate). Batched: at the MoE training shape (32 experts x 320
// capacity rows x 1024 x 512) each product is 10.7 GFLOP against 76 MB of
// operands and output, so operations bound it; at the decode shape (4
// capacity rows per expert) reading the 32 expert weights (33.5 MB in
// bf16) is the least the card must do. Plain: 512^3 in f32 is bound by
// operations. This first version computes all three on the CUDA cores in
// f32 FMA (IEEE, never TF32: the f32 Freivalds tolerance is 16 x 1.2e-7 x
// sqrt(n / area)), so at 64-row tiles it is bound by FMA issue, not by
// bytes, and a tile of 64 rows holding 4 real ones wastes 15/16 of it.
// Tensor cores (wgmma, TMA, bf16) for the template are the next kernel
// work.
//
// Design: one block per (64 x 64 output tile, batch g); the contraction is
// a loop inside the block (the TPU's sequential grid axis), staging 16-deep
// slices of A and B in shared memory as f32. Each of the 256 threads keeps
// a 4 x 4 accumulator in registers, fed by a 4 x 4 partial sum that
// restarts every KSPAN contraction steps. Summed in one running f32 value,
// the rounding error over k terms grows like sqrt(k) -- beyond 1e-5 of the
// output at the LM head's k = 128256 in the training backward; the two
// levels cut it to about sqrt(KSPAN) + sqrt(k / KSPAN). With a shared B
// every block reads the same B columns for all g, so the G bands share B
// through L2; with per-g B (the experts) each block streams its own. The
// batch strides are arguments, so one body serves all three entries.
// Ragged edges are masked, so no shape must tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int KSPAN = 256;  // contraction steps per partial sum
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 float* __restrict__ C, int M, int N, int K,
                 long long sAg, long long sAm, long long sBg, long long sBk,
                 long long sCg, long long sCm) {
  // +4 keeps each row 16-byte aligned for the float4 reads below
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* Ag = A + (long long)g * sAg;
  const T* Bg = B + (long long)g * sBg;
  float* Cg = C + (long long)g * sCg;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK), stored transposed so a thread reads TM rows at once
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(Ag[gm * sAm + gk]) : 0.f;
    }
    // B tile (BK x BN), neighbouring threads on neighbouring columns
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(Bg[gk * sBk + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    __syncthreads();
    if ((k0 + BK) % KSPAN == 0 || k0 + BK >= K) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) Cg[gm * sCm + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* A, const void* B, void* C, int G, int M, int N, int K,
           long long sAg, long long sAm, long long sBg, long long sBk,
           long long sCg, long long sCm, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  band_gemm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<float*>(C), M, N, K, sAg, sAm, sBg, sBk, sCg, sCm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int band_gemm_f32(const void* A, const void* B, void* C, int G,
                             int M, int N, int K, long long sAg, long long sAm,
                             long long sBg, long long sBk, long long sCg,
                             long long sCm, void* stream) {
  return launch<float>(A, B, C, G, M, N, K, sAg, sAm, sBg, sBk, sCg, sCm,
                       stream);
}

extern "C" int band_gemm_bf16(const void* A, const void* B, void* C, int G,
                              int M, int N, int K, long long sAg,
                              long long sAm, long long sBg, long long sBk,
                              long long sCg, long long sCm, void* stream) {
  return launch<__nv_bfloat16>(A, B, C, G, M, N, K, sAg, sAm, sBg, sBk, sCg,
                               sCm, stream);
}

extern "C" int block_gemm_batched_f32(const void* A, const void* B, void* C,
                                      int G, int M, int N, int K,
                                      long long sAg, long long sAm,
                                      long long sBg, long long sBk,
                                      long long sCg, long long sCm,
                                      void* stream) {
  return launch<float>(A, B, C, G, M, N, K, sAg, sAm, sBg, sBk, sCg, sCm,
                       stream);
}

extern "C" int block_gemm_batched_bf16(const void* A, const void* B, void* C,
                                       int G, int M, int N, int K,
                                       long long sAg, long long sAm,
                                       long long sBg, long long sBk,
                                       long long sCg, long long sCm,
                                       void* stream) {
  return launch<__nv_bfloat16>(A, B, C, G, M, N, K, sAg, sAm, sBg, sBk, sCg,
                               sCm, stream);
}

extern "C" int block_gemm_f32(const void* A, const void* B, void* C, int M,
                              int N, int K, long long sAm, long long sBk,
                              long long sCm, void* stream) {
  return launch<float>(A, B, C, 1, M, N, K, 0, sAm, 0, sBk, 0, sCm, stream);
}

extern "C" int block_gemm_bf16(const void* A, const void* B, void* C, int M,
                               int N, int K, long long sAm, long long sBk,
                               long long sCm, void* stream) {
  return launch<__nv_bfloat16>(A, B, C, 1, M, N, K, 0, sAm, 0, sBk, 0, sCm,
                               stream);
}
