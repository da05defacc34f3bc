// Freivalds residuals of one verified band bucket, fused, for Hopper.
//
// Replaces no Pallas kernel: the reference computes these residuals as XLA
// einsums beside its band GEMM (src/repro/kernels/ops.py:169,
// `_bucket_gemm_verified`), and so did the port, in plain PyTorch (kept as
// `kernels/freivalds.residuals_plain`). Per rectangle g of band b (rows
// [0, h_b) of the band product C, columns [c0, c1)) and probe i < iters,
// with row signs r_i and column signs s_i:
//   rhs_i = Σ_m r_i[m] Σ_q C[b, m, q] s_i[q]
//   lhs_i = Σ_m r_i[m] Σ_k A_b[m, k] t_i[k],   t_i[k] = Σ_q B[k, q] s_i[q]
//   scale = Σ_m Σ_q |C[b, m, q]|
// after the poisoning C[b, 0, c0] += corr (1 + |C[b, 0, c0]|) of a flagged
// rectangle, which is written back into C. The signs are those of
// `ops.rademacher`, bit for bit: two rounds of its 32-bit hash over the
// index, from per-(rectangle, probe) keys that the host hashes from the
// seed, the salt and the task id. Every sum is IEEE f32 (FMA on the CUDA
// cores); the order of the sums is the kernel's own, and fixed.
//
// What bounds it on an H100: bytes. It reads the band stack A and the
// shared B in their stored type (bf16 or f32) and C in f32, each once
// (B once per band of the bucket, the bands' blocks side by side so that
// the repeats come from L2). B and C cost 2-5 FMAs an element; A costs one
// FMA per (rectangle, probe) pair of its band, up to 32 at 16 rectangles,
// where the FMAs and the bytes of A are about even.
//
// Design: two kernels on the stream, fed by one packed int32 buffer (the
// layout is `Meta` below; `kernels/freivalds.pack` writes it).
//  - product: a grid of two kinds of block. A t-block takes 64 rows of B
//    and one rectangle's columns; per 256-column chunk the block hashes the
//    chunk's column signs once into shared memory, then each warp walks 8
//    rows with a lane per column, and a transposing butterfly leaves each
//    lane one of the warp's 8 rows x 4 probes of t. (Lanes reading 8
//    columns with one 16-byte load sped the LM head's forward by a quarter
//    but, sharing this kernel's registers, slowed the c-blocks as much.) A c-block takes 64
//    band rows and up to 1024 columns of one rectangle: row and column
//    signs in shared memory, per row the column sums Σ C s_i, then r_i
//    times them; its (rhs, scale) partial goes to scratch. The c-block
//    that owns C[b, 0, c0] poisons it before the block reads it.
//  - operands: a block takes 64 rows of one band, 2 TX columns of A and up
//    to NP (rectangle, probe) pairs of that band: u_p[k] = Σ_m r_p[m] A[m,k]
//    in registers (the pairs' row signs in shared memory), then
//    Σ_k u_p[k] t_p[k], one partial per pair. The last block to finish (a
//    counter in the packed buffer) sums every partial, lhs and (rhs,
//    scale), in a fixed order into the (rects, 2 iters + 1) result: the
//    result does not depend on the order in which blocks ran.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXIT = 4;            // probes a rectangle takes at most
constexpr int KT = 64;              // t-block: rows of B
constexpr int ROWS_W = KT / WARPS;  // t-block: rows of B a warp walks
constexpr int CHUNK = 256;          // t- and c-blocks: columns a step
constexpr int MR = 64;              // c- and operand blocks: band rows
constexpr int NPART = MAXIT + 1;    // a c-block's partial: rhs_i, scale
constexpr unsigned FULL = 0xffffffffu;
static_assert(ROWS_W * MAXIT == 32, "a t-block warp's sums fill its lanes");
static_assert(CHUNK == THREADS, "one column sign a thread and probe");

// The packed buffer, int32 words: h[Gb] first[Gb + 1] bidx[Gr] slot[Gr]
// c0[Gr] c1[Gr] corrupt[Gr] (f32 bits) key_r[Gr iters] key_s[Gr iters]
// counter[1]. The rectangles of band b are first[b] ..
// first[b + 1] - 1, in slot order.
struct Meta {
  const int* h;
  const int* first;
  const int* bidx;
  const int* slot;
  const int* c0;
  const int* c1;
  const float* corrupt;
  const uint32_t* key_r;
  const uint32_t* key_s;
  unsigned* counter;
};

__device__ __forceinline__ Meta unpack(int* p, int Gb, int Gr, int iters) {
  Meta M;
  M.h = p;
  p += Gb;
  M.first = p;
  p += Gb + 1;
  M.bidx = p;
  p += Gr;
  M.slot = p;
  p += Gr;
  M.c0 = p;
  p += Gr;
  M.c1 = p;
  p += Gr;
  M.corrupt = reinterpret_cast<const float*>(p);
  p += Gr;
  M.key_r = reinterpret_cast<const uint32_t*>(p);
  p += Gr * iters;
  M.key_s = reinterpret_cast<const uint32_t*>(p);
  p += Gr * iters;
  M.counter = reinterpret_cast<unsigned*>(p);
  return M;
}

// ops._mix32: a 32-bit avalanche hash
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return h ^ (h >> 16);
}

// ops.rademacher's sign at index ix under one (rectangle, probe) key
__device__ __forceinline__ float probe_sign(uint32_t key, uint32_t ix) {
  return (mix32(mix32(key ^ ix) ^ key) >> 31) ? -1.0f : 1.0f;
}

// one element, and two neighbours, as f32: bf16 (raw bits) is the upper
// half of an f32, so the widening is exact
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const uint16_t* p) {
  return __uint_as_float(uint32_t(__ldg(p)) << 16);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const uint16_t* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Sums each of N values (N a power of two, at most 32) over the warp;
// lane l returns the sum of value l % N. The values that differ in the
// lanes' bits >= log2(N) are added plainly, then each stage halves the
// values a lane keeps: N - 1 + N log2(32 / N) shuffles in all.
template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N], int lane) {
#pragma unroll
  for (int o = 16; o >= N; o >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(FULL, v[j], o);
  }
#pragma unroll
  for (int o = N / 2; o >= 1; o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int j = 0; j < o; ++j) {
      const float send = up ? v[j] : v[j + o];
      const float keep = up ? v[j + o] : v[j];
      v[j] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  return v[0];
}

// t[g, i, k] for the block's 64 rows k of B and rectangle g's columns
template <typename T>
__device__ __forceinline__ void t_block(const T* __restrict__ B,
                                        long long s_bk, int nk,
                                        const Meta& M, int iters, int g,
                                        int kt, float* __restrict__ t,
                                        float* ssg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = M.c0[g], c1 = M.c1[g];
  const int k0 = kt * KT + warp * ROWS_W;
  uint32_t key[MAXIT];
#pragma unroll
  for (int i = 0; i < MAXIT; ++i) key[i] = i < iters ? M.key_s[g * iters + i] : 0u;
  float acc[ROWS_W * MAXIT];
#pragma unroll
  for (int j = 0; j < ROWS_W * MAXIT; ++j) acc[j] = 0.0f;
  for (int cb = c0; cb < c1; cb += CHUNK) {
    __syncthreads();  // the previous chunk's signs are read
    {
      const int q = cb + threadIdx.x;
#pragma unroll
      for (int i = 0; i < MAXIT; ++i)
        ssg[i * CHUNK + threadIdx.x] =
            (i < iters && q < c1) ? probe_sign(key[i], uint32_t(q)) : 0.0f;
    }
    __syncthreads();
    const int ncol = min(CHUNK, c1 - cb);
    const T* base = B + (long long)k0 * s_bk + cb;
#pragma unroll 2
    for (int j = lane; j < ncol; j += 32) {
      float s[MAXIT];
#pragma unroll
      for (int i = 0; i < MAXIT; ++i) s[i] = ssg[i * CHUNK + j];
      float v[ROWS_W];
#pragma unroll
      for (int r = 0; r < ROWS_W; ++r)
        v[r] = k0 + r < nk ? ld1(base + r * s_bk + j) : 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS_W; ++r) {
#pragma unroll
        for (int i = 0; i < MAXIT; ++i)
          acc[r * MAXIT + i] = fmaf(v[r], s[i], acc[r * MAXIT + i]);
      }
    }
  }
  const float sum = warp_transpose_sum<ROWS_W * MAXIT>(acc, lane);
  const int r = lane / MAXIT, i = lane % MAXIT;
  if (i < iters && k0 + r < nk) t[((long long)g * iters + i) * nk + k0 + r] = sum;
}

// rectangle g's (rhs_i, scale) partial over band rows [64 rt, 64 rt + 64)
// and columns [c0 + split_cols cs, + split_cols)
__device__ __forceinline__ void c_block(float* C, long long s_cb,
                                        long long s_cm, const Meta& M,
                                        int iters, int g, int rt, int cs,
                                        int split_cols,
                                        float* __restrict__ part, float* sr,
                                        float* ssg, float* red) {
  const int b = M.bidx[g], h = M.h[b], c0 = M.c0[g], c1 = M.c1[g];
  const int m0 = rt * MR;
  const int qa = c0 + cs * split_cols, qb = min(c1, qa + split_cols);
  float* Cb = C + (long long)b * s_cb;
  uint32_t key[MAXIT];
#pragma unroll
  for (int i = 0; i < MAXIT; ++i) key[i] = i < iters ? M.key_s[g * iters + i] : 0u;
  for (int e = threadIdx.x; e < MAXIT * MR; e += THREADS) {
    const int i = e / MR, m = m0 + e % MR;
    sr[e] = (i < iters && m < h) ? probe_sign(M.key_r[g * iters + i], uint32_t(m))
                                 : 0.0f;
  }
  if (threadIdx.x == 0 && rt == 0 && cs == 0) {
    const float corr = M.corrupt[g];
    if (corr != 0.0f) {
      // C[0, c0] + corr (1 + |C[0, c0]|), rounded as the plain version
      // rounds it (no fused multiply-add)
      const float v = Cb[c0];
      Cb[c0] = __fadd_rn(v, __fmul_rn(corr, __fadd_rn(1.0f, fabsf(v))));
    }
  }
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
  float acc[MAXIT];
#pragma unroll
  for (int i = 0; i < MAXIT; ++i) acc[i] = 0.0f;
  float asum = 0.0f;
  for (int cb = qa; cb < qb; cb += CHUNK) {
    __syncthreads();  // row signs and the poisoned element are in; the
                      // previous chunk's column signs are read
    {
      const int q = cb + threadIdx.x;
#pragma unroll
      for (int i = 0; i < MAXIT; ++i)
        ssg[i * CHUNK + threadIdx.x] =
            (i < iters && q < qb) ? probe_sign(key[i], uint32_t(q)) : 0.0f;
    }
    __syncthreads();
    const int ncol = qb - cb;
    float s[4][MAXIT];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < MAXIT; ++i) s[j][i] = ssg[i * CHUNK + tx + 64 * j];
    }
    const int rows = min(MR, h - m0);
#pragma unroll 4
    for (int u = ty; u < rows; u += 4) {
      const float* row = Cb + (long long)(m0 + u) * s_cm + cb;
      float w[MAXIT];
#pragma unroll
      for (int i = 0; i < MAXIT; ++i) w[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 64 * j;
        if (col < ncol) {
          const float v = row[col];
          asum += fabsf(v);
#pragma unroll
          for (int i = 0; i < MAXIT; ++i) w[i] = fmaf(v, s[j][i], w[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MAXIT; ++i) acc[i] = fmaf(sr[i * MR + u], w[i], acc[i]);
    }
  }
  float v[NPART];
#pragma unroll
  for (int i = 0; i < MAXIT; ++i) v[i] = acc[i];
  v[MAXIT] = asum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NPART; ++j) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) v[j] += __shfl_xor_sync(FULL, v[j], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NPART; ++j) red[warp * NPART + j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < NPART) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * NPART + threadIdx.x];
    part[threadIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    product_kernel(const T* __restrict__ B, long long s_bk, float* C,
                   long long s_cb, long long s_cm, int* meta,
                   float* __restrict__ t, float* __restrict__ cpart, int Gb,
                   int Gr, int iters, int nk, int kt_tiles, int row_tiles,
                   int splits, int split_cols) {
  __shared__ float ssg[MAXIT * CHUNK];
  __shared__ float sr[MAXIT * MR];
  __shared__ float red[WARPS * NPART];
  const Meta M = unpack(meta, Gb, Gr, iters);
  const long long x = blockIdx.x, nt = (long long)kt_tiles * Gr;
  if (x < nt) {
    // the rectangles' blocks of one row tile of B side by side: the bands'
    // repeated reads of B come from L2
    t_block<T>(B, s_bk, nk, M, iters, int(x % Gr), int(x / Gr), t, ssg);
    return;
  }
  const long long y = x - nt;
  const int per = row_tiles * splits;
  const int g = int(y / per), rem = int(y % per);
  c_block(C, s_cb, s_cm, M, iters, g, rem / splits, rem % splits, split_cols,
          cpart + ((long long)g * per + rem) * NPART, sr, ssg, red);
}

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS)
    operand_kernel(const T* __restrict__ A, long long s_ag, long long s_am,
                   const float* __restrict__ t, int* meta,
                   const float* __restrict__ cpart, float* apart,
                   float* __restrict__ res, int Gb, int Gr, int iters,
                   int nk, int tx_n, int k_tiles, int row_tiles, int groups,
                   int c_parts) {
  __shared__ float sr[MR * NP];
  __shared__ float red[WARPS * NP];
  __shared__ int last;
  const Meta M = unpack(meta, Gb, Gr, iters);
  const int kt = blockIdx.x, rt = blockIdx.y;
  const int b = blockIdx.z / groups, pg = blockIdx.z % groups;
  const int h = M.h[b], first = M.first[b];
  const int P = (M.first[b + 1] - first) * iters;  // the band's pairs
  const int m0 = rt * MR;
  // pair p = slot iters + probe: rectangle first + slot, key first iters + p
  for (int e = threadIdx.x; e < MR * NP; e += THREADS) {
    const int p = pg * NP + e % NP, m = m0 + e / NP;
    sr[e] = (p < P && m < h) ? probe_sign(M.key_r[first * iters + p], uint32_t(m))
                             : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int ty_n = THREADS / tx_n;
  const int k = 2 * (kt * tx_n + tx);
  const bool live = k < nk && m0 < h && pg * NP < P;
  float u0[NP], u1[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) u0[p] = u1[p] = 0.0f;
  if (live) {
    const T* col = A + (long long)b * s_ag + (long long)m0 * s_am + k;
    const int rows = min(MR, h - m0);
#pragma unroll 2
    for (int mm = ty; mm < rows; mm += ty_n) {
      const float2 a = ld2(col + (long long)mm * s_am);
      const float* sg = sr + mm * NP;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float s = sg[p];
        u0[p] = fmaf(s, a.x, u0[p]);
        u1[p] = fmaf(s, a.y, u1[p]);
      }
    }
  }
  float v[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int pp = pg * NP + p;
    if (live && pp < P) {
      const float* tp = t + ((long long)first * iters + pp) * nk + k;
      v[p] = fmaf(u0[p], __ldg(tp), u1[p] * __ldg(tp + 1));
    } else {
      v[p] = 0.0f;
    }
  }
  const float w = warp_transpose_sum<NP>(v, lane);
  if (lane < NP) red[warp * NP + lane] = w;
  __syncthreads();
  const int n_ap = row_tiles * k_tiles;
  if (threadIdx.x < NP) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) s += red[j * NP + threadIdx.x];
    apart[(((long long)b * groups + pg) * n_ap + (long long)rt * k_tiles + kt) * NP +
          threadIdx.x] = s;
  }
  // the last block to finish sums every partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(M.counter, 1u) == gridDim.x * gridDim.y * gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) *M.counter = 0u;  // a relaunch on the same buffer
  const int width = 2 * iters + 1;
  for (int o = warp; o < Gr * width; o += WARPS) {
    const int g = o / width, c = o % width;
    float s = 0.0f;
    if (c < iters) {
      const int p = M.slot[g] * iters + c;
      const float* src =
          apart + ((long long)M.bidx[g] * groups + p / NP) * n_ap * NP + p % NP;
      for (int j = lane; j < n_ap; j += 32) s += __ldcg(src + (long long)j * NP);
    } else {
      const float* src =
          cpart + (long long)g * c_parts * NPART + (c < 2 * iters ? c - iters : MAXIT);
      for (int j = lane; j < c_parts; j += 32) s += src[(long long)j * NPART];
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) res[(long long)g * width + c] = s;
  }
}

template <typename T>
int launch_product(const void* b, long long s_bk, void* c, long long s_cb,
                   long long s_cm, void* meta, void* t, void* cpart, int Gb,
                   int Gr, int iters, int nk, int kt_tiles, int row_tiles,
                   int splits, int split_cols, void* stream) {
  if (iters < 1 || iters > MAXIT || split_cols <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)kt_tiles * Gr + (long long)Gr * row_tiles * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks <= 0) return (int)cudaGetLastError();
  product_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(b), s_bk, static_cast<float*>(c), s_cb, s_cm,
      static_cast<int*>(meta), static_cast<float*>(t),
      static_cast<float*>(cpart), Gb, Gr, iters, nk, kt_tiles, row_tiles,
      splits, split_cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_operands(const void* a, long long s_ag, long long s_am,
                    const void* t, void* meta, const void* cpart, void* apart,
                    void* res, int Gb, int Gr, int iters, int nk, int np,
                    int tx_n, int k_tiles, int row_tiles, int groups,
                    int c_parts, void* stream) {
  if (iters < 1 || iters > MAXIT || tx_n < 32 || tx_n > THREADS ||
      THREADS % tx_n || k_tiles <= 0 || row_tiles <= 0 || row_tiles > 65535 ||
      groups <= 0 || Gb <= 0 || (long long)Gb * groups > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(k_tiles, row_tiles, Gb * groups);
  cudaStream_t st = (cudaStream_t)stream;
  const T* A = static_cast<const T*>(a);
  const float* tf = static_cast<const float*>(t);
  const float* cp = static_cast<const float*>(cpart);
  float* ap = static_cast<float*>(apart);
  float* r = static_cast<float*>(res);
  int* m = static_cast<int*>(meta);
#define FV_OPERANDS(N)                                                      \
  operand_kernel<T, N><<<grid, THREADS, 0, st>>>(A, s_ag, s_am, tf, m, cp,  \
                                                 ap, r, Gb, Gr, iters, nk,  \
                                                 tx_n, k_tiles, row_tiles,  \
                                                 groups, c_parts)
  switch (np) {
    case 4: FV_OPERANDS(4); break;
    case 8: FV_OPERANDS(8); break;
    case 16: FV_OPERANDS(16); break;
    case 32: FV_OPERANDS(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FV_OPERANDS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int freivalds_product_f32(const void* b, long long s_bk, void* c,
                                     long long s_cb, long long s_cm,
                                     void* meta, void* t, void* cpart,
                                     int Gb, int Gr, int iters, int nk,
                                     int kt_tiles, int row_tiles, int splits,
                                     int split_cols, void* stream) {
  return launch_product<float>(b, s_bk, c, s_cb, s_cm, meta, t, cpart, Gb,
                               Gr, iters, nk, kt_tiles, row_tiles, splits,
                               split_cols, stream);
}

extern "C" int freivalds_product_bf16(const void* b, long long s_bk, void* c,
                                      long long s_cb, long long s_cm,
                                      void* meta, void* t, void* cpart,
                                      int Gb, int Gr, int iters, int nk,
                                      int kt_tiles, int row_tiles,
                                      int splits, int split_cols,
                                      void* stream) {
  return launch_product<uint16_t>(b, s_bk, c, s_cb, s_cm, meta, t, cpart, Gb,
                                  Gr, iters, nk, kt_tiles, row_tiles, splits,
                                  split_cols, stream);
}

extern "C" int freivalds_operands_f32(const void* a, long long s_ag,
                                      long long s_am, const void* t,
                                      void* meta, const void* cpart,
                                      void* apart, void* res, int Gb, int Gr,
                                      int iters, int nk, int np, int tx_n,
                                      int k_tiles, int row_tiles, int groups,
                                      int c_parts, void* stream) {
  return launch_operands<float>(a, s_ag, s_am, t, meta, cpart, apart, res, Gb,
                                Gr, iters, nk, np, tx_n, k_tiles, row_tiles,
                                groups, c_parts, stream);
}

extern "C" int freivalds_operands_bf16(const void* a, long long s_ag,
                                       long long s_am, const void* t,
                                       void* meta, const void* cpart,
                                       void* apart, void* res, int Gb,
                                       int Gr, int iters, int nk, int np,
                                       int tx_n, int k_tiles, int row_tiles,
                                       int groups, int c_parts,
                                       void* stream) {
  return launch_operands<uint16_t>(a, s_ag, s_am, t, meta, cpart, apart, res,
                                   Gb, Gr, iters, nk, np, tx_n, k_tiles,
                                   row_tiles, groups, c_parts, stream);
}
