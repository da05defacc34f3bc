// Band GEMM for Hopper: C[g] = A[g] · B[g], f32 accumulation, f32 output.
//
// Three C entry points for each operand type, one for each Pallas GEMM
// kernel of src/repro/kernels/block_gemm.py:
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
// The operand type alone picks one of two bodies; nothing else does.
//
// What bounds them on an H100. Training shapes (llama3-8b's fleet buckets,
// 512-1920 rows against 4096-14336-wide B; the MoE experts, 32 x 320 rows x
// 1024 x 512) are bound by operations: 989 TFLOP/s of bf16 on the tensor
// cores. The decode shapes (a band of 4 real rows padded to 128 against a
// B of up to 4096 x 128256) are bound by bytes: streaming B once over the
// 3.35 TB/s memory is the least the card must do, and the 124 zero rows
// cost tensor-core cycles that this bound hides (the MoE experts' decode
// products run in f32, on the FMA body). The 512^3 product in f32 is
// bound by operations at 67 TFLOP/s on the CUDA cores.
//
// Both bodies keep a two-level f32 sum: a partial restarts every KSPAN
// contraction steps and is then added into the running sum. Summed in one
// running f32 value, the rounding error over k terms grows like sqrt(k) --
// beyond 1e-5 of the output at the LM head's k = 128256 in the training
// backward; the two levels cut it to about sqrt(KSPAN) + sqrt(k / KSPAN).
//
// f32 body (`band_gemm_kernel`, the IEEE-f32 path of the f32 policy, never
// TF32: the f32 Freivalds tolerance is 16 x 1.2e-7 x sqrt(n / area)): one
// block of 256 threads per (64 x 64 output tile, batch g); the contraction
// is a loop inside the block (the TPU's sequential grid axis), staging
// 16-deep slices of A and B in shared memory; each thread keeps a 4 x 4
// sum in registers. It runs f32 FMA on the CUDA cores.
//
// bf16 body (`band_gemm_tc_kernel`): the tensor cores through wgmma, fed by
// TMA. A block computes a 128 x 128 output tile with three warpgroups: one
// producer warp issues the TMA loads of 64-deep contraction slices (A as
// one 128 x 64 box, B as two 64 x 64 boxes, 128-byte rows with the
// 128-byte swizzle) into a ring of STAGES slices in dynamic shared memory,
// each stage with a "full" and an "empty" mbarrier; two consumer
// warpgroups each own 64 rows and issue wgmma m64n128k16 on the slices
// that have arrived. A is row-major (K-major for wgmma); B is row-major
// (k, n), MN-major, read as it lies through the instruction's transpose
// bit -- no transposed copy. `setmaxnreg` gives the producer's registers
// to the consumers, which hold 64 + 64 f32 accumulators a thread: the
// wgmma partial (restarted with scale-d = 0 every KSPAN = 4 slices) and
// the running sum. TMA fills out-of-bounds boxes with zeros and the
// epilogue masks its stores, so no dimension has to tile; TMA needs
// 16-byte-aligned bases and strides, which the wrapper provides
// (`kernels/block_gemm.tma_aligned`). One 3-d tensor map per operand,
// (inner, rows, G) with the caller's strides, covers the shared B (one
// batch), the per-expert B and G = 1. With a shared B the tiles that read
// one B column tile run together, for L2 reuse. When the tile grid covers
// a third of the 132 SMs or less (the decode products: 8-32 tiles), the
// contraction is split into S slices until the grid nears half the SMs: a
// block's 5-stage ring keeps enough bytes in flight that half the SMs
// stream B at the memory's rate, and every further split costs an f32
// partial of the output written and read back. The wrapper plans the
// slices (`kernels/block_gemm.split_plan`) and passes their bounds; the
// launch refuses bounds that are not 0, then multiples of KSPAN rising to
// K. The S partials go to a scratch buffer and `splitk_sum_kernel` adds
// them in slice order into C -- no atomics, so two launches on the same
// operands give equal bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KSPAN = 256;  // contraction steps per partial sum

// ------------------------------------------------------------ f32 body --

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
band_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int M, int N, int K,
                 long long sAg, long long sAm, long long sBg, long long sBk,
                 long long sCg, long long sCm) {
  // +4 keeps each row 16-byte aligned for the float4 reads below
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float* Ag = A + (long long)g * sAg;
  const float* Bg = B + (long long)g * sBg;
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
      As[c][r] = (gm < M && gk < K) ? Ag[gm * sAm + gk] : 0.f;
    }
    // B tile (BK x BN), neighbouring threads on neighbouring columns
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? Bg[gk * sBk + gn] : 0.f;
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

int launch(const void* A, const void* B, void* C, int G, int M, int N, int K,
           long long sAg, long long sAm, long long sBg, long long sBk,
           long long sCg, long long sCm, void* stream) {
  if (G <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  band_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(C), M, N, K, sAg, sAm, sBg, sBk, sCg, sCm);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- bf16 body --

namespace tc {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;                       // 128-byte rows of bf16
constexpr int STAGES = 5;
constexpr int MAX_SLICES = 64;               // as block_gemm.MAX_SLICES
constexpr int SPAN_SLICES = KSPAN / BK;      // 4
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;         // 16 KB
constexpr int B_HALF = BK * 64 * 2;          // one 64 x 64 box, 8 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
// smem descriptors, 128-byte swizzle: 8-row groups lie 1024 bytes apart in
// both operands; B's two 64-column boxes lie B_HALF apart
constexpr uint32_t GROUP_BYTES = 1024;
constexpr int ERR_TMAP = 10000;              // + the CUresult of the encode
constexpr int ERR_NO_ENCODE = 20000;         // no encoder in the CUDA driver

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity` to complete. A lost arrival traps
// (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving register reads or writes of `x` across
// the asynchronous wgmma's issue and wait
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// D (64 x 128, f32) = [D +] A (64 x 16, K-major) · B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The contraction slices' bounds: slice s covers [k[s], k[s + 1]).
struct KSlices {
  int k[MAX_SLICES + 1];
};

// One block per (128 x 128 tile, contraction slice). blockIdx.x walks the
// tiles: with a shared B the row tiles of all G bands first, so that the
// blocks reading one B column tile run together; with a per-g B the row
// tiles, the column tiles, then g. blockIdx.y is the slice s, which covers
// [ks.k[s], ks.k[s + 1]) and writes its f32 sums at out + s * sOs.
__global__ void __launch_bounds__(THREADS, 1)
band_gemm_tc_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB,
                    const __grid_constant__ KSlices ks,
                    float* __restrict__ out, int G, int M, int N,
                    int m_tiles, int n_tiles, int shared_b,
                    long long sOs, long long sOg, long long sOm) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t full0 = base + STAGES * STAGE_BYTES;
  const uint32_t empty0 = full0 + STAGES * 8;

  int t = blockIdx.x, mt, nt, g;
  mt = t % m_tiles;
  t /= m_tiles;
  if (shared_b) {
    g = t % G;
    nt = t / G;
  } else {
    nt = t % n_tiles;
    g = t / n_tiles;
  }
  const int s = blockIdx.y;
  const int k_begin = ks.k[s], k_end = ks.k[s + 1];
  const int n_slices = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      const int gb = shared_b ? 0 : g;
      for (int i = 0; i < n_slices; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * st, ((i / STAGES) - 1) & 1);
        const uint32_t bar = full0 + 8 * st;
        const uint32_t a_dst = base + st * STAGE_BYTES;
        const uint32_t b_dst = a_dst + A_BYTES;
        const int kc = k_begin + i * BK;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_3d(a_dst, &tmA, bar, kc, mt * BM, g);
        tma_load_3d(b_dst, &tmB, bar, nt * BN, kc, gb);
        tma_load_3d(b_dst + B_HALF, &tmB, bar, nt * BN + 64, kc, gb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[64], part[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = part[j] = 0.f;

    for (int i = 0; i < n_slices; ++i) {
      const int st = i % STAGES;
      mbar_wait(full0 + 8 * st, (i / STAGES) & 1);
      // this warpgroup's 64 rows of A: 64 x 128 bytes further on
      const uint32_t a_t = base + st * STAGE_BYTES + wg * 64 * 128;
      const uint32_t b_t = base + st * STAGE_BYTES + A_BYTES;
#pragma unroll
      for (int j = 0; j < 64; ++j) fence_reg(part[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 16 k-steps are 32 bytes along a swizzled row; B: 16 k-rows of
        // 128 bytes. A new span restarts the partial (scale-d = 0).
        const uint64_t da = smem_desc(a_t + 32 * kk, 16, GROUP_BYTES);
        const uint64_t db = smem_desc(b_t + 16 * 128 * kk, B_HALF,
                                      GROUP_BYTES);
        wgmma_m64n128k16(part, da, db, (i % SPAN_SLICES) != 0 || kk != 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 64; ++j) fence_reg(part[j]);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * st);
      if ((i + 1) % SPAN_SLICES == 0 || i + 1 == n_slices) {
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += part[j];
      }
    }

    // accumulator layout of m64nNk16: thread t of the warpgroup holds rows
    // 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 j + 2 (t % 4) (+ 1)
    const int tt = threadIdx.x % 128;
    const int row0 = mt * BM + wg * 64 + (tt / 32) * 16 + (tt % 32) / 4;
    const int col0 = nt * BN + 2 * (tt % 4);
    float* O = out + s * sOs + (long long)g * sOg;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M || col >= N) continue;
        float* p = O + (long long)row * sOm + col;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (col + 1 < N && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        }
      }
    }
  }
}

// C[g, m, n] = sum over s = 0 .. S-1, in that order, of P[s, g, m, n]
// (P contiguous (S, G, M, N)); S = 0 writes zeros.
__global__ void __launch_bounds__(256)
splitk_sum_kernel(const float* __restrict__ P, float* __restrict__ C, int S,
                  int G, int M, int N, long long sCg, long long sCm) {
  const long long plane = (long long)G * M * N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < plane;
       i += (long long)gridDim.x * 256) {
    float sum = 0.f;
    for (int j = 0; j < S; ++j) sum += P[j * plane + i];
    const long long r = i / N;
    C[(r / M) * sCg + (r % M) * sCm + i % N] = sum;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, through the runtime, so that the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d bf16 map (inner, rows, batch) with 128-byte swizzle; strides in
// elements, the batch stride ignored for one batch.
int encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int inner,
           int rows, int batch, long long s_row, long long s_batch,
           int box_inner, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const long long sb = batch > 1 ? s_batch : s_row * rows;
  const cuuint64_t strides[2] = {(cuuint64_t)s_row * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP + (int)r;
}

// S slices of the contraction, bounded by k_bounds[0 .. S] (host memory):
// 0, then multiples of KSPAN rising to K, so that every partial restarts
// on a span boundary. With S > 1, P is the (S, G, M, N) f32 scratch the
// wrapper allocated.
int launch(const void* A, const void* B, void* C, void* P, int G, int M,
           int N, int K, long long sAg, long long sAm, long long sBg,
           long long sBk, long long sCg, long long sCm, const int* k_bounds,
           int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  float* Cf = static_cast<float*>(C);
  const long long plane = (long long)G * M * N;
  const int sum_blocks = (int)((plane + 255) / 256 < 4096 ? (plane + 255) / 256
                                                          : 4096);
  if (K <= 0) {  // an empty contraction: C = 0
    splitk_sum_kernel<<<sum_blocks, 256, 0, st>>>(nullptr, Cf, 0, G, M, N,
                                                  sCg, sCm);
    return (int)cudaGetLastError();
  }
  if (S < 1 || S > MAX_SLICES || k_bounds == nullptr ||
      (S > 1 && P == nullptr))
    return (int)cudaErrorInvalidValue;
  KSlices ks;
  for (int i = 0; i <= S; ++i) {
    ks.k[i] = k_bounds[i];
    const bool ok = i == 0   ? ks.k[0] == 0
                    : i == S ? ks.k[S] == K && K > ks.k[S - 1]
                             : ks.k[i] > ks.k[i - 1] && ks.k[i] % KSPAN == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const bool shared_b = sBg == 0;
  CUtensorMap ta, tb;
  int err = encode(enc, &ta, A, K, M, G, sAm, sAg, BK, BM);
  if (err == 0)
    err = encode(enc, &tb, B, N, K, shared_b ? 1 : G, sBk, sBg, 64, BK);
  if (err) return err;

  static bool attr_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaFuncSetAttribute(band_gemm_tc_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    attr_set[dev] = true;
  }
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)G * m_tiles * n_tiles;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, S);
  if (S == 1) {
    band_gemm_tc_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        ta, tb, ks, Cf, G, M, N, m_tiles, n_tiles, shared_b, 0, sCg, sCm);
  } else {
    band_gemm_tc_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        ta, tb, ks, static_cast<float*>(P), G, M, N, m_tiles, n_tiles,
        shared_b, plane, (long long)M * N, N);
    err = (int)cudaGetLastError();
    if (err) return err;
    splitk_sum_kernel<<<sum_blocks, 256, 0, st>>>(
        static_cast<const float*>(P), Cf, S, G, M, N, sCg, sCm);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int band_gemm_f32(const void* A, const void* B, void* C, int G,
                             int M, int N, int K, long long sAg, long long sAm,
                             long long sBg, long long sBk, long long sCg,
                             long long sCm, void* stream) {
  return launch(A, B, C, G, M, N, K, sAg, sAm, sBg, sBk, sCg, sCm,
                       stream);
}

extern "C" int band_gemm_bf16(const void* A, const void* B, void* C, void* P,
                              int G, int M, int N, int K, long long sAg,
                              long long sAm, long long sBg, long long sBk,
                              long long sCg, long long sCm,
                              const int* k_bounds, int S, void* stream) {
  return tc::launch(A, B, C, P, G, M, N, K, sAg, sAm, sBg, sBk, sCg, sCm,
                    k_bounds, S, stream);
}

extern "C" int block_gemm_batched_f32(const void* A, const void* B, void* C,
                                      int G, int M, int N, int K,
                                      long long sAg, long long sAm,
                                      long long sBg, long long sBk,
                                      long long sCg, long long sCm,
                                      void* stream) {
  return launch(A, B, C, G, M, N, K, sAg, sAm, sBg, sBk, sCg, sCm,
                       stream);
}

extern "C" int block_gemm_batched_bf16(const void* A, const void* B, void* C,
                                       void* P, int G, int M, int N, int K,
                                       long long sAg, long long sAm,
                                       long long sBg, long long sBk,
                                       long long sCg, long long sCm,
                                       const int* k_bounds, int S,
                                       void* stream) {
  return tc::launch(A, B, C, P, G, M, N, K, sAg, sAm, sBg, sBk, sCg, sCm,
                    k_bounds, S, stream);
}

extern "C" int block_gemm_f32(const void* A, const void* B, void* C, int M,
                              int N, int K, long long sAm, long long sBk,
                              long long sCm, void* stream) {
  return launch(A, B, C, 1, M, N, K, 0, sAm, 0, sBk, 0, sCm, stream);
}

extern "C" int block_gemm_bf16(const void* A, const void* B, void* C, void* P,
                               int M, int N, int K, long long sAm,
                               long long sBk, long long sCm,
                               const int* k_bounds, int S, void* stream) {
  return tc::launch(A, B, C, P, 1, M, N, K, 0, sAm, 0, sBk, 0, sCm, k_bounds,
                    S, stream);
}
