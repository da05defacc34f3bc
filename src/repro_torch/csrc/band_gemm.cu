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
//   block_gemm_batched_f32_bf16   block_gemm_batched for an f32 A against a
//                                 bf16 B, read as stored: the MoE decode
//                                 step's f32 buffers against its bf16 expert
//                                 weights, with no f32 copy of the weights.
//
// The operand types alone pick one of two bodies: bf16 A and B the
// tensor-core body, an f32 A the f32 body.
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
// f32 body (`simt::`, the IEEE-f32 path of the f32 policy, never TF32:
// the f32 Freivalds tolerance is 16 x 1.2e-7 x sqrt(n / area) and the
// parity bars assume IEEE products). FMA on the CUDA cores peaks at 67
// TFLOP/s, so a wide product is bound by how close the FMA pipes run to
// that, which shared-memory traffic and idle SMs decide; a product of a
// few rows (the MoE decode step: 4 rows against a 1024 x 512 expert) is
// bound by reading B, and padding its rows to a tile multiplies the FMAs
// (a 64-row tile ran 16 x the product's own, which made the set bound by
// operations). Two tilings, which the wrapper's rule picks
// (`kernels/block_gemm.fma_plan`) and passes with the slice bounds:
// - wide (m > 16): 256 threads per 64 x 64 or 128 x 128 output tile, each
//   thread a 4 x 4 or 8 x 8 register tile (8 or 16 FMAs per shared load;
//   the larger tile only where its grid nearly fills the card); 32-deep
//   slices in a 4-stage ring, one barrier a slice; A staged k-major so a
//   thread's rows come in one float4, B as it lies in 16-byte cp.async
//   copies (4-byte zero-filled ones at a ragged edge);
// - skinny (m <= 16): one block per 128 or 256 columns holds all the
//   band's rows; B streams through the ring in 16-byte copies, A's rows
//   are broadcast from shared memory, and the FMAs are the product's own.
// A bf16 B (`block_gemm_batched_f32_bf16`) stays bf16 in shared memory and
// widens in registers, exactly, so its products and sums are those of the
// call on the f32 copy. Small grids split the contraction as the bf16 body
// does, with the same bounds checks and in-order sum.
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

constexpr int MAX_SLICES = 64;  // as block_gemm.MAX_SLICES

// The contraction slices' bounds: slice s covers [k[s], k[s + 1]).
struct KSlices {
  int k[MAX_SLICES + 1];
};

// Copies the S + 1 slice bounds k_bounds[0 .. S] (host memory) into `ks`
// after checking them: 0, then multiples of KSPAN rising to K, so that
// every partial restarts on a span boundary.
int make_slices(const int* k_bounds, int S, int K, KSlices* ks) {
  if (S < 1 || S > MAX_SLICES || k_bounds == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= S; ++i) {
    ks->k[i] = k_bounds[i];
    const bool ok = i == 0   ? ks->k[0] == 0
                    : i == S ? ks->k[S] == K && K > ks->k[S - 1]
                             : ks->k[i] > ks->k[i - 1] &&
                                   ks->k[i] % KSPAN == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  return 0;
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

int sum_blocks(long long plane) {
  return (int)((plane + 255) / 256 < 4096 ? (plane + 255) / 256 : 4096);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ f32 body --

namespace simt {

constexpr int THREADS = 256;
constexpr int STAGES = 4;      // cp.async ring depth (3 slices in flight)
// the tilings, numbered as block_gemm.FMA_TILES; the wrapper's rule picks
enum Tiling { SKINNY = 0, WIDE_64 = 1, WIDE_128 = 2 };

// 16 bytes into shared memory; zeros when !ok (the source is then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes; zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element of B at a ragged edge: f32 by a 4-byte copy, bf16 (below
// cp.async's 4 bytes) by a load and a store.
__device__ __forceinline__ void stage1(float* dst, const float* src,
                                       bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void stage1(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __ushort_as_bfloat16(0);
}

// Four consecutive values from shared memory, as f32. bf16 widens
// exactly: its 16 bits become the high half of the f32.
__device__ __forceinline__ void ld4(float* v, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ld4(float* v, const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

// A stage of A, ROWS x DEPTH from `src` (row stride sAm), stored k-major
// at dst[c * LD + r]: one 4-byte copy per element, since the copy
// transposes; rows past `rows` and steps past `depth` read as zeros.
template <int ROWS, int DEPTH, int LD>
__device__ __forceinline__ void stage_a(float* dst, const float* src,
                                        long long sAm, int rows,
                                        int depth) {
  const int c = threadIdx.x % DEPTH;
  for (int r = threadIdx.x / DEPTH; r < ROWS; r += THREADS / DEPTH)
    cp_async4(dst + c * LD + r, src + r * sAm + c, r < rows && c < depth);
}

// A stage of B, ROWS x COLS from `src` (row stride sBk), stored as it
// lies, in 16-byte copies; a copy that would cross the operand's edge takes
// the element path, and rows past `rows` read as zeros.
template <int ROWS, int COLS, typename TB>
__device__ __forceinline__ void stage_b(TB* dst, const TB* src,
                                        long long sBk, int rows, int cols,
                                        int b_vec) {
  constexpr int VEC = 16 / sizeof(TB), CPR = COLS / VEC;
  const int c = (threadIdx.x % CPR) * VEC;
  const bool inside = b_vec && c + VEC <= cols;
  for (int r = threadIdx.x / CPR; r < ROWS; r += THREADS / CPR) {
    const TB* s = src + r * sBk + c;
    TB* d = dst + r * COLS + c;
    const bool row = r < rows;
    if (inside || (b_vec && !row)) {
      cp_async16(d, s, row);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) stage1(d + e, s + e, row && c + e < cols);
    }
  }
}

// A launch's operands. O is C, or with a split contraction the (S, G, M,
// N) scratch of partials, sOs apart; a_vec, b_vec: A's and B's bases and
// strides allow 16-byte loads and copies; o_vec: O's allow float4 stores.
template <typename TB>
struct Args {
  const float* A;
  const TB* B;
  float* O;
  int G, M, N, m_tiles, n_tiles, shared_b, a_vec, b_vec, o_vec;
  long long sAg, sAm, sBg, sBk, sOs, sOg, sOm;
};

// Wide tiling (m > 16): one block of 16 x 16 threads per (BM x BN output
// tile, batch g, contraction slice). A thread owns (BM / 16) x (BN / 16)
// outputs in 4 x 4 groups BM / 2 rows and BN / 2 columns apart, so that a
// quarter warp's float4 reads of B fall on distinct banks. Slices of BK =
// 32 contraction steps go through a ring of STAGES in shared memory: B as
// it lies, by cp.async; A k-major (a thread's 4 rows in one float4), which
// a copy cannot transpose, so A's slice is read into registers in 16-byte
// loads while the block computes and stored transposed after (measured
// about 10% faster than a 4-byte copy per element). A thread's FMAs run in
// k order whatever BK is, so the slice depth does not change the bits.
constexpr int BK = 32;

// A's share of one thread in a wide slice: AV float4s of 4 contraction
// steps of one row, read from global memory into registers.
template <int BM>
struct ASlice {
  static constexpr int AV = BM * BK / (4 * THREADS);
  float4 v[AV];

  // rows [0, rows) and steps [0, depth) of `src` (row stride sAm) are
  // the operand's; `vec`: 16-byte loads are aligned
  __device__ __forceinline__ void fetch(const float* src, long long sAm,
                                        int rows, int depth, int vec) {
#pragma unroll
    for (int u = 0; u < AV; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
      const float* a = src + r * sAm + c;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) {
        if (vec && c + 4 <= depth) {
          const float4 t = *reinterpret_cast<const float4*>(a);
          x[0] = t.x;
          x[1] = t.y;
          x[2] = t.z;
          x[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < depth) x[e] = a[e];
        }
      }
      v[u] = make_float4(x[0], x[1], x[2], x[3]);
    }
  }

  // transposed into dst[c * LD + r]
  template <int LD>
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int u = 0; u < AV; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
      dst[c * LD + r] = v[u].x;
      dst[(c + 1) * LD + r] = v[u].y;
      dst[(c + 2) * LD + r] = v[u].z;
      dst[(c + 3) * LD + r] = v[u].w;
    }
  }
};

template <int BM, int BN, typename TB>
struct Wide {
  static constexpr int LDA = BM + 4;    // padded A rows: fewer conflicts
  static constexpr int A_STAGE = BK * LDA;                // floats
  static constexpr int B_STAGE = BK * BN;                 // elements
  static constexpr int SMEM =
      STAGES * (A_STAGE * 4 + B_STAGE * (int)sizeof(TB));
};

template <int BM, int BN, typename TB>
__global__ void __launch_bounds__(THREADS)
wide_kernel(const Args<TB> p, const KSlices ks) {
  using L = Wide<BM, BN, TB>;
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  TB* Bs = reinterpret_cast<TB*>(smem + STAGES * L::A_STAGE * 4);

  int t = blockIdx.x, mt, nt, g;
  mt = t % p.m_tiles;
  t /= p.m_tiles;
  if (p.shared_b) {  // the bands that read one B column tile run together
    g = t % p.G;
    nt = t / p.G;
  } else {
    nt = t % p.n_tiles;
    g = t / p.n_tiles;
  }
  const int s = blockIdx.y;
  const int k_begin = ks.k[s], k_end = ks.k[s + 1];
  const int n_steps = (k_end - k_begin + BK - 1) / BK;
  const int m0 = mt * BM, n0 = nt * BN;
  const float* Ag = p.A + g * p.sAg + m0 * p.sAm;
  const TB* Bg = p.B + g * p.sBg + n0;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  ASlice<BM> a_next;
  auto fetch = [&](int step) {   // A into registers, B by cp.async
    const int k0 = k_begin + step * BK;
    a_next.fetch(Ag + k0, p.sAm, p.M - m0, k_end - k0, p.a_vec);
    stage_b<BK, BN>(Bs + (step % STAGES) * L::B_STAGE, Bg + k0 * p.sBk,
                    p.sBk, k_end - k0, p.N - n0, p.b_vec);
    cp_async_commit();
  };
  auto store = [&](int step) {
    a_next.template store<L::LDA>(As + (step % STAGES) * L::A_STAGE);
  };

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) {
      fetch(i);
      store(i);
    } else {
      cp_async_commit();
    }
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice i has landed; slice i - 1's readers are done
    const bool more = i + STAGES - 1 < n_steps;
    if (more)
      fetch(i + STAGES - 1);
    else
      cp_async_commit();
    const float* as = As + (i % STAGES) * L::A_STAGE + ty * 4;
    const TB* bs = Bs + (i % STAGES) * L::B_STAGE + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h)
        ld4(a + 4 * h, as + kk * L::LDA + h * (BM / 2));
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        ld4(b + 4 * h, bs + kk * BN + h * (BN / 2));
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) part[r][c] = fmaf(a[r], b[c], part[r][c]);
    }
    if ((k_begin + (i + 1) * BK) % KSPAN == 0 || i + 1 == n_steps) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          acc[r][c] += part[r][c];
          part[r][c] = 0.f;
        }
    }
    if (more) store(i + STAGES - 1);   // its stage's readers passed the barrier
  }

  float* O = p.O + s * p.sOs + g * p.sOg;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = m0 + (r / 4) * (BM / 2) + ty * 4 + r % 4;
    if (row >= p.M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = n0 + h * (BN / 2) + tx * 4;
      float* q = O + (long long)row * p.sOm + col;
      const float* v = &acc[r][4 * h];
      if (p.o_vec && col + 4 <= p.N) {
        *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.N) q[e] = v[e];
      }
    }
  }
}

// Skinny tiling (m <= 16; the MoE decode experts have 4 rows): one block
// per (N columns, batch g, contraction slice) holds every row. Lane l of
// each warp owns CPL columns of all MT rows (8 up to 8 rows, else 4); the
// 8 warps share each stage's BK contraction steps and add their sums in
// warp order at the end. B streams through the ring in 16-byte copies (16
// KB a stage for bf16, 32 for f32; BK does not depend on B's type, so an
// f32 x bf16 launch sums as the launch on an f32 copy does), and A's few
// rows are broadcast from shared memory, so the FMAs are the product's own
// and the launch is bound by B's bytes.
constexpr int SK_WARPS = THREADS / 32;

template <int MT, typename TB>
struct Skinny {
  static constexpr int CPL = MT <= 8 ? 8 : 4;
  static constexpr int N = 32 * CPL;                       // 256 or 128
  static constexpr int BK = 8192 / N;                      // 32 or 64
  static constexpr int A_STAGE = BK * MT;                  // floats
  static constexpr int B_STAGE = BK * N;                   // elements
  static constexpr int RING =
      STAGES * (A_STAGE * 4 + B_STAGE * (int)sizeof(TB));
  static constexpr int RED = SK_WARPS * MT * N * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
};

// Column of value j (< CPL) of lane l within the block's N columns: 8
// contiguous bf16 (one 16-byte read), else groups of 4 (one read each)
// 128 columns apart, so that a warp's reads are contiguous.
template <int CPL, typename TB>
__device__ __forceinline__ int lane_col(int lane, int j) {
  if constexpr (sizeof(TB) == 2 && CPL == 8) return 8 * lane + j;
  return (j / 4) * 128 + 4 * lane + j % 4;
}

template <int CPL>
__device__ __forceinline__ void ld_lane(float* v, const float* row,
                                        int lane) {
#pragma unroll
  for (int h = 0; h < CPL / 4; ++h) ld4(v + 4 * h, row + h * 128 + 4 * lane);
}
template <int CPL>
__device__ __forceinline__ void ld_lane(float* v, const __nv_bfloat16* row,
                                        int lane) {
  if constexpr (CPL == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(row + 8 * lane);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[2 * h] = __uint_as_float(w[h] << 16);
      v[2 * h + 1] = __uint_as_float(w[h] & 0xFFFF0000u);
    }
  } else {
    ld4(v, row + 4 * lane);
  }
}

template <int MT, typename TB>
__global__ void __launch_bounds__(THREADS)
skinny_kernel(const Args<TB> p, const KSlices ks) {
  using L = Skinny<MT, TB>;
  constexpr int CPL = L::CPL, N = L::N, SBK = L::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  TB* Bs = reinterpret_cast<TB*>(smem + STAGES * L::A_STAGE * 4);

  const int nt = blockIdx.x % p.n_tiles, g = blockIdx.x / p.n_tiles;
  const int s = blockIdx.y;
  const int k_begin = ks.k[s], k_end = ks.k[s + 1];
  const int n_steps = (k_end - k_begin + SBK - 1) / SBK;
  const int n0 = nt * N;
  const float* Ag = p.A + g * p.sAg;
  const TB* Bg = p.B + g * p.sBg + n0;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;

  auto load = [&](int step) {
    const int st = step % STAGES, k0 = k_begin + step * SBK;
    stage_a<MT, SBK, MT>(As + st * L::A_STAGE, Ag + k0, p.sAm, p.M,
                         k_end - k0);
    stage_b<SBK, N>(Bs + st * L::B_STAGE, Bg + k0 * p.sBk, p.sBk,
                    k_end - k0, p.N - n0, p.b_vec);
  };

  float acc[MT][CPL], part[MT][CPL];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = part[r][c] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_steps) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_steps) load(i + STAGES - 1);
    cp_async_commit();
    const float* as = As + (i % STAGES) * L::A_STAGE;
    const TB* bs = Bs + (i % STAGES) * L::B_STAGE;
#pragma unroll
    for (int j = 0; j < SBK / SK_WARPS; ++j) {
      const int kk = w * (SBK / SK_WARPS) + j;
      float a[MT], b[CPL];
#pragma unroll
      for (int h = 0; h < MT / 4; ++h) ld4(a + 4 * h, as + kk * MT + 4 * h);
      ld_lane<CPL>(b, bs + kk * N, lane);
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) part[r][c] = fmaf(a[r], b[c], part[r][c]);
    }
    if ((k_begin + (i + 1) * SBK) % KSPAN == 0 || i + 1 == n_steps) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          acc[r][c] += part[r][c];
          part[r][c] = 0.f;
        }
    }
  }

  // the warps' sums meet in the ring's shared memory, added in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [SK_WARPS][MT][N]
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int h = 0; h < CPL / 4; ++h)
      *reinterpret_cast<float4*>(red + (w * MT + r) * N +
                                 lane_col<CPL, TB>(lane, 4 * h)) =
          make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                      acc[r][4 * h + 3]);
  __syncthreads();
  float* O = p.O + s * p.sOs + g * p.sOg;
  for (int i = tid; i < MT * N; i += THREADS) {
    const int r = i / N, c = i % N;
    if (r >= p.M || n0 + c >= p.N) continue;
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < SK_WARPS; ++v) sum += red[(v * MT + r) * N + c];
    O[(long long)r * p.sOm + n0 + c] = sum;
  }
}

// Raises a kernel's dynamic shared memory limit, once per device.
template <typename K>
int allow_smem(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && done[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) done[dev] = true;
  return 0;
}

template <int BM, int BN, typename TB>
int run_wide(Args<TB> a, const KSlices& ks, int S, cudaStream_t st) {
  constexpr int smem = Wide<BM, BN, TB>::SMEM;
  static bool smem_set[64] = {};
  const int err = allow_smem(wide_kernel<BM, BN, TB>, smem, smem_set);
  if (err) return err;
  a.m_tiles = (a.M + BM - 1) / BM;
  a.n_tiles = (a.N + BN - 1) / BN;
  const long long tiles = (long long)a.G * a.m_tiles * a.n_tiles;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  wide_kernel<BM, BN, TB>
      <<<dim3((unsigned)tiles, S), THREADS, smem, st>>>(a, ks);
  return (int)cudaGetLastError();
}

template <int MT, typename TB>
int run_skinny(Args<TB> a, const KSlices& ks, int S, cudaStream_t st) {
  using L = Skinny<MT, TB>;
  static bool smem_set[64] = {};
  const int err = allow_smem(skinny_kernel<MT, TB>, L::SMEM, smem_set);
  if (err) return err;
  a.m_tiles = 1;
  a.n_tiles = (a.N + L::N - 1) / L::N;
  const long long tiles = (long long)a.G * a.n_tiles;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  skinny_kernel<MT, TB>
      <<<dim3((unsigned)tiles, S), THREADS, L::SMEM, st>>>(a, ks);
  return (int)cudaGetLastError();
}

// S slices of the contraction bounded by k_bounds[0 .. S], in the given
// tiling; with S > 1, P is the (S, G, M, N) f32 scratch the wrapper
// allocated, summed into C in slice order.
template <typename TB>
int launch(const void* A, const void* B, void* C, void* P, int G, int M,
           int N, int K, long long sAg, long long sAm, long long sBg,
           long long sBk, long long sCg, long long sCm, const int* k_bounds,
           int S, int tiling, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  float* Cf = static_cast<float*>(C);
  const long long plane = (long long)G * M * N;
  if (K <= 0) {  // an empty contraction: C = 0
    splitk_sum_kernel<<<sum_blocks(plane), 256, 0, st>>>(nullptr, Cf, 0, G,
                                                         M, N, sCg, sCm);
    return (int)cudaGetLastError();
  }
  KSlices ks;
  int err = make_slices(k_bounds, S, K, &ks);
  if (err) return err;
  if (S > 1 && P == nullptr) return (int)cudaErrorInvalidValue;
  constexpr int VEC = 16 / sizeof(TB);
  Args<TB> a;
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const TB*>(B);
  a.O = S > 1 ? static_cast<float*>(P) : Cf;
  a.G = G;
  a.M = M;
  a.N = N;
  a.shared_b = sBg == 0;
  a.sAg = sAg;
  a.sAm = sAm;
  a.sBg = sBg;
  a.sBk = sBk;
  a.sOs = S > 1 ? plane : 0;
  a.sOg = S > 1 ? (long long)M * N : sCg;
  a.sOm = S > 1 ? N : sCm;
  a.a_vec = reinterpret_cast<uintptr_t>(A) % 16 == 0 && sAm % 4 == 0 &&
            sAg % 4 == 0;
  a.b_vec = reinterpret_cast<uintptr_t>(B) % 16 == 0 && sBk % VEC == 0 &&
            sBg % VEC == 0;
  a.o_vec = reinterpret_cast<uintptr_t>(a.O) % 16 == 0 && a.sOm % 4 == 0 &&
            a.sOg % 4 == 0 && a.sOs % 4 == 0;
  switch (tiling) {
    case SKINNY:
      err = M <= 4    ? run_skinny<4>(a, ks, S, st)
            : M <= 8  ? run_skinny<8>(a, ks, S, st)
            : M <= 16 ? run_skinny<16>(a, ks, S, st)
                      : (int)cudaErrorInvalidValue;
      break;
    case WIDE_64:
      err = run_wide<64, 64>(a, ks, S, st);
      break;
    case WIDE_128:
      err = run_wide<128, 128>(a, ks, S, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err || S == 1) return err;
  splitk_sum_kernel<<<sum_blocks(plane), 256, 0, st>>>(
      static_cast<const float*>(P), Cf, S, G, M, N, sCg, sCm);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ----------------------------------------------------------- bf16 body --

namespace tc {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;                       // 128-byte rows of bf16
constexpr int STAGES = 5;
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
  if (K <= 0) {  // an empty contraction: C = 0
    splitk_sum_kernel<<<sum_blocks(plane), 256, 0, st>>>(nullptr, Cf, 0, G,
                                                         M, N, sCg, sCm);
    return (int)cudaGetLastError();
  }
  KSlices ks;
  int err = make_slices(k_bounds, S, K, &ks);
  if (err) return err;
  if (S > 1 && P == nullptr) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const bool shared_b = sBg == 0;
  CUtensorMap ta, tb;
  err = encode(enc, &ta, A, K, M, G, sAm, sAg, BK, BM);
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
    splitk_sum_kernel<<<sum_blocks(plane), 256, 0, st>>>(
        static_cast<const float*>(P), Cf, S, G, M, N, sCg, sCm);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The f32 entries take the tiling from the wrapper's rule
// (`kernels/block_gemm.fma_plan`) beside the slice bounds.
extern "C" int band_gemm_f32(const void* A, const void* B, void* C, void* P,
                             int G, int M, int N, int K, long long sAg,
                             long long sAm, long long sBg, long long sBk,
                             long long sCg, long long sCm,
                             const int* k_bounds, int S, int tiling,
                             void* stream) {
  return simt::launch<float>(A, B, C, P, G, M, N, K, sAg, sAm, sBg, sBk, sCg,
                            sCm, k_bounds, S, tiling, stream);
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
                                      void* P, int G, int M, int N, int K,
                                      long long sAg, long long sAm,
                                      long long sBg, long long sBk,
                                      long long sCg, long long sCm,
                                      const int* k_bounds, int S, int tiling,
                                      void* stream) {
  return simt::launch<float>(A, B, C, P, G, M, N, K, sAg, sAm, sBg, sBk, sCg,
                            sCm, k_bounds, S, tiling, stream);
}

// f32 A against a bf16 B (the MoE decode step: f32 capacity buffers, bf16
// expert weights as stored), f32 out: the f32 body widens B in registers,
// exactly, so the result has the bits of the call on B converted to f32.
extern "C" int block_gemm_batched_f32_bf16(
    const void* A, const void* B, void* C, void* P, int G, int M, int N,
    int K, long long sAg, long long sAm, long long sBg, long long sBk,
    long long sCg, long long sCm, const int* k_bounds, int S, int tiling,
    void* stream) {
  return simt::launch<__nv_bfloat16>(A, B, C, P, G, M, N, K, sAg, sAm, sBg,
                                    sBk, sCg, sCm, k_bounds, S, tiling,
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

extern "C" int block_gemm_f32(const void* A, const void* B, void* C, void* P,
                              int M, int N, int K, long long sAm,
                              long long sBk, long long sCm,
                              const int* k_bounds, int S, int tiling,
                              void* stream) {
  return simt::launch<float>(A, B, C, P, 1, M, N, K, 0, sAm, 0, sBk, 0, sCm,
                            k_bounds, S, tiling, stream);
}

extern "C" int block_gemm_bf16(const void* A, const void* B, void* C, void* P,
                               int M, int N, int K, long long sAm,
                               long long sBk, long long sCm,
                               const int* k_bounds, int S, void* stream) {
  return tc::launch(A, B, C, P, 1, M, N, K, 0, sAm, 0, sBk, 0, sCm, k_bounds,
                    S, stream);
}
