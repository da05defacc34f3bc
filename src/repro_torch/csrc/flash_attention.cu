// Flash attention (forward) for Hopper: causal and sliding-window masks,
// GQA by index, safe for fully masked rows.
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:64, body `_flash_kernel`): per
// (batch, head) and tile of query rows, s = (q·scale)·kᵀ in f32, masked
// (kpos <= qpos when causal, kpos > qpos - window when a window is set;
// the first `prefix` keys, Hymba's meta tokens, are always visible),
// then an online max, denominator and accumulator over key tiles, with
// p = exp(s - m)·mask cast to v's type before the p·v product, and
// out = acc / max(l, 1e-30) in q's type. It runs the attention forward of
// every training step and every serving prefill of the port
// (`models.attention.chunked_attention` -> `kernels.ops.mha_flash`).
//
// What bounds it on an H100: at the training shape (256 query heads of
// 128 x 128, 64 kv heads, causal, f32) the work is ~1.1 GFLOP of useful
// products against ~42 MB of operands and output, so the f32 CUDA-core
// rate (67 TFLOP/s) and the memory rate give bounds of the same order
// (~0.016 ms vs ~0.013 ms). The kernel computes in IEEE f32 FMA on the
// CUDA cores (no TF32: the model path passes f32 operands and the port is
// held to IEEE f32). On the CUDA cores the pace is set by shared-memory
// loads per FMA, by how often a K/V tile is staged, and by how many
// blocks fit on an SM.
//
// Design: one block of 128 threads per (tile of BQ = 64 query rows, batch,
// kv head). The rows are (position, head) pairs, position-major, over the
// G = H / Hk query heads that share the kv head, so each K/V tile is
// staged once for all G heads; the row tiles that see the most keys under
// a causal mask start first. The TPU's sequential key axis is a loop
// inside the block over key tiles of BK = 64 (the plain version's
// BLOCK_K), staged as f32 in shared memory, K and V row-major ([key][d]).
// Each thread owns 4 rows x 8 keys of the score tile (keys 8 apart) and 4
// rows x D/8 columns of the accumulator: per float4 of d, QKᵀ issues 12
// shared loads for 128 FMAs, and per key P·V issues 1 + D/32 for 4 x D/8;
// a warp's P·V stops at the last key any of its 16 rows can see. The
// float4 columns of Q (by row group) and of K (by key) are XOR-swizzled so
// that a warp's reads fall on distinct banks; P is written transposed, 4
// rows in one float4, swizzled alike. Row max and sum reduce over the 8
// lanes of a row group by warp shuffles. For f32 operands Q, K and V
// arrive by cp.async (16 bytes, 4 at a ragged edge, zeros past the
// sequence or the head dim; Q is scaled where it landed), K and V in
// alternation: the next K tile loads under this tile's softmax and P·V,
// the next V tile under the next QKᵀ; bf16 operands are widened and
// scaled as they are staged. Shared memory (112 KB at D = 128) and 222
// registers a thread leave room for two blocks an SM. Rows a block of 32
// or 128 exist for f32 at D = 128 to measure the choice (chip_smoke.py's
// split phase). Key
// tiles that the causal or window mask hides from every row of the block
// are skipped: they add nothing to the online softmax, so no value
// changes. Ragged Sq, Sk and D are masked, not padded. Operands are
// addressed through strides, so the (B, S, H, D) layout of the model is
// read in place.
//
// A prefix of P always-visible keys (Hymba's meta tokens, put before the
// sequence's keys by the caller, with q_offset raised by P) passes every
// mask: keys j < P are visible to every row, and keys j >= P keep the
// causal and window tests, whose positions are shifted alike. Under a
// window the key loop visits the tiles that hold the prefix, then jumps
// to the window's first tile; the tiles between are skipped as before.
//
// q and k may be wider than v (MLA: Dk = 192 of nope and rope columns, Dv
// = 128): the kernel is templated on the two padded widths, Q and K tiles
// of DPK columns, V tiles and the accumulator of DPV, with the scale
// 1/sqrt(Dk). At (192, 128) a block of BQ = 64 rows would take 144 KB of
// shared memory, so one block of 128 threads fits an SM; BQ = 32 112 KB
// and two, BQ = 128 208 KB and one of 256 threads. MLA's training shape
// (B 8, S 128, 128 heads over 128 kv heads, causal, f32) has G = 1, so a
// K/V tile serves BQ positions of one head only; its 335 MB of operands
// and output against 5.4 GFLOP of useful products make it bound by bytes
// (0.100 ms against 0.081 ms). There BQ = 128, one block of 8 warps an
// SM, ran 0.370 ms on an H100 against 0.458 (BQ 64) and 0.510 (BQ 32) in
// f32, 0.559 against 0.933 and 1.310 in bf16, whose operands are widened
// by plain loads, not cp.async, and so wait in line with the arithmetic;
// only BQ = 128 is built at (192, 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 64;         // key tile: flash_attention.BLOCK_K
constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a (B, heads, S, D) view; D is unit
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four values at src[0..3] as f32, zeros where !ok or past d = D; `vec`:
// the launch's bases and strides allow one 4-element load.
template <typename T>
__device__ __forceinline__ float4 load4(const T* src, bool ok, int d, int D,
                                        int vec) {
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (ok && vec && d + 4 <= D) {
    if constexpr (sizeof(T) == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      return t;
    } else {
      const uint2 t = *reinterpret_cast<const uint2*>(src);
      x[0] = __uint_as_float(t.x << 16);
      x[1] = __uint_as_float(t.x & 0xFFFF0000u);
      x[2] = __uint_as_float(t.y << 16);
      x[3] = __uint_as_float(t.y & 0xFFFF0000u);
    }
  } else if (ok) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) x[e] = to_f32(src[e]);
  }
  return make_float4(x[0], x[1], x[2], x[3]);
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float* x, int d, int D,
                                       int vec) {
  if (vec && d + 4 <= D) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d + e < D) dst[e] = from_f32<T>(x[e]);
}

// One K or V tile, keys [k0, k0 + BK) of the sequence, into `dst`
// ([BK][DP] f32; float4 column c of key j at c ^ (j % 8) when `swz`).
template <typename T, int DP, int NT>
__device__ __forceinline__ void stage_kv(float* dst, const T* src,
                                         long long s_s, int k0, int Sk,
                                         int D, int vec, bool swz) {
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < BK * C4; i += NT) {
    const int j = i / C4, c = i % C4, d = 4 * c;
    const bool ok = k0 + j < Sk;
    float* to = dst + j * DP + 4 * (swz ? c ^ (j & 7) : c);
    const T* from = src + (long long)(k0 + j) * s_s + d;
    if constexpr (sizeof(T) == 4) {
      if (vec && (!ok || d + 4 <= D)) {
        cp_async16(to, from, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(to + e, from + e, ok && d + e < D);
      }
    } else {
      *reinterpret_cast<float4*>(to) = load4(from, ok, d, D, vec);
    }
  }
}

// The block's queries, row r = (position, head) pair R0 + r, into Qs
// ([BQ][DP] f32, float4 column c of row r at c ^ (r / 4 % 8)), scaled by
// `scale`: f32 by cp.async, scaled after the copies land by the thread
// that issued them (`scale_q`); bf16 widened and scaled as staged.
template <typename T, int DP, int BQ, int NT>
__device__ __forceinline__ void stage_q(float* Qs, const T* qb, Strides qs,
                                        int R0, int G, int Sq, int D,
                                        int vec, float scale) {
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < BQ * C4; i += NT) {
    const int r = i / C4, c = i % C4, d = 4 * c;
    const int R = R0 + r, pos = R / G;
    const bool ok = pos < Sq;
    float* to = Qs + r * DP + 4 * (c ^ ((r >> 2) & 7));
    const T* from =
        qb + (long long)(R % G) * qs.h + (long long)pos * qs.s + d;
    if constexpr (sizeof(T) == 4) {
      if (vec && (!ok || d + 4 <= D)) {
        cp_async16(to, from, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(to + e, from + e, ok && d + e < D);
      }
    } else {
      float4 x = load4(from, ok, d, D, vec);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      *reinterpret_cast<float4*>(to) = x;
    }
  }
}

template <int DP, int BQ, int NT>
__device__ __forceinline__ void scale_q(float* Qs, float scale) {
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < BQ * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    float4* x =
        reinterpret_cast<float4*>(Qs + r * DP + 4 * (c ^ ((r >> 2) & 7)));
    float4 y = *x;
    y.x *= scale;
    y.y *= scale;
    y.z *= scale;
    y.w *= scale;
    *x = y;
  }
}

template <int DPK, int DPV, int BQ>
constexpr int smem_bytes() {
  return 4 * (BQ * DPK + BK * DPK + BK * DPV + BK * BQ);
}

// DPK, DPV: the q/k and the v head dims rounded up to 32; BQ: query rows
// of a block, 2 BQ threads (BQ / 4 row groups of 8 key lanes)
template <typename T, int DPK, int DPV, int BQ>
__global__ void __launch_bounds__(2 * BQ, BQ <= 64 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int G, int Hk,
                 int Sq, int Sk, int Dk, int Dv, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, int window,
                 int q_offset, int prefix, float scale, int vec) {
  constexpr int NT = 2 * BQ;       // threads
  constexpr int C4 = DPK / 4;      // float4 columns of a q or k row
  constexpr int CV4 = DPV / 4;     // float4 columns of a v row
  constexpr int DJ = DPV / 32;     // accumulator float4s a thread, per row
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                  // [BQ][DPK] scaled queries
  float* Ks = Qs + BQ * DPK;       // [BK][DPK] keys, swizzled
  float* Vs = Ks + BK * DPK;       // [BK][DPV] values
  float* Pt = Vs + BK * DPV;       // [BK][BQ] rounded p, swizzled
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
  const float4* K4 = reinterpret_cast<const float4*>(Ks);
  const float4* V4 = reinterpret_cast<const float4*>(Vs);
  float4* P4 = reinterpret_cast<float4*>(Pt);

  // block rows R0 .. R0 + BQ - 1; row R is position R / G of query head
  // kh * G + R % G. The last row tiles, which see the most keys under a
  // causal mask, start first.
  const int R0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / Hk, kh = blockIdx.x % Hk;
  const T* qb = q + b * qs.b + (long long)kh * G * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + (long long)kh * G * os.h;

  const int tid = threadIdx.x;
  const int kl = tid % 8;    // key lane: keys kl + 8 j, columns 4 (kl + 8 jj)
  const int rg = tid / 8;    // row group: block rows 4 rg .. 4 rg + 3

  // key tiles some row of the block can see; the rest are wholly masked
  const int pos_lo = R0 / G, pos_hi = min(Sq - 1, (R0 + BQ - 1) / G);
  const int qlo = q_offset + pos_lo, qhi = q_offset + pos_hi;
  int kend = Sk;
  if (causal) kend = max(0, min(Sk, qhi + 1));
  // under a window: the prefix's tiles [0, pend), then the window's from
  // wbeg; with no prefix the loop starts at wbeg
  int kbeg = 0, pend = 0, wbeg = 0;
  if (window > 0) {
    wbeg = max(0, qlo - window + 1) / BK * BK;
    pend = (min(prefix, Sk) + BK - 1) / BK * BK;
    kbeg = pend > 0 ? 0 : wbeg;
  }
  // the key tile after k0
  auto next_tile = [&](int k0) {
    const int n = k0 + BK;
    return (n >= pend && n < wbeg) ? wbeg : n;
  };
  if (kbeg < kend) {
    stage_q<T, DPK, BQ, NT>(Qs, qb, qs, R0, G, Sq, Dk, vec, scale);
    cp_async_commit();
    stage_kv<T, DPK, NT>(Ks, kb, ks.s, kbeg, Sk, Dk, vec, true);
    cp_async_commit();
    stage_kv<T, DPV, NT>(Vs, vb, vs.s, kbeg, Sk, Dv, vec, false);
    cp_async_commit();
    if constexpr (sizeof(T) == 4) {
      cp_async_wait<2>();    // this thread's query copies have landed
      scale_q<DPK, BQ, NT>(Qs, scale);
    }
  }

  float m[4], l[4], acc[4][4 * DJ];
  int qpos[4];
  // the last query position of the warp's 16 rows
  const int qlast =
      q_offset + min(Sq - 1, (R0 + 16 * (tid / 32) + 15) / G);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = q_offset + (R0 + 4 * rg + i) / G;
#pragma unroll
    for (int j = 0; j < 4 * DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 = next_tile(k0)) {
    const int kn = next_tile(k0);
    const bool more = kn < kend;
    cp_async_wait<1>();   // this K tile (and the queries) have landed
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C4; ++c) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = Q4[(4 * rg + i) * C4 + (c ^ (rg & 7))];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = K4[(kl + 8 * j) * C4 + (c ^ kl)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();    // every QKᵀ read of Ks is done: load the next tile
    if (more) stage_kv<T, DPK, NT>(Ks, kb, ks.s, kn, Sk, Dk, vec, true);
    cp_async_commit();

    float corr[4], pr[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[8];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + kl + 8 * j;
        ok[j] = kpos < Sk &&
                (kpos < prefix || ((!causal || kpos <= qpos[i]) &&
                                   (window <= 0 || kpos > qpos[i] - window)));
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int x = 4; x > 0; x >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float mnew = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mnew) : 0.f;
        psum += p;
        // the p·v product takes p in v's type, as the TPU kernel does
        pr[i][j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int x = 4; x > 0; x >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, x);
      corr[i] = expf(m[i] - mnew);
      l[i] = l[i] * corr[i] + psum;
      m[i] = mnew;
    }
    // key kl + 8 j: the thread's 4 rows in one float4 (index rg ^ kl)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      P4[(kl + 8 * j) * (BQ / 4) + (rg ^ kl)] =
          make_float4(pr[0][j], pr[1][j], pr[2][j], pr[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4 * DJ; ++j) acc[i][j] *= corr[i];

    cp_async_wait<1>();   // this V tile has landed
    __syncthreads();    // and every p is written
    // the keys of this tile that some row of the warp can see: the rest
    // have p = 0 for the whole warp, whose P·V skips them
    int nk = min(BK, Sk - k0);
    if (causal) nk = min(nk, qlast + 1 - k0);
#pragma unroll 4
    for (int c = 0; c < nk; ++c) {
      const float4 pv = P4[c * (BQ / 4) + (rg ^ (c & 7))];
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float4 vv = V4[c * CV4 + kl + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj] = fmaf(p4[i], vv.x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(p4[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p4[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p4[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
    __syncthreads();    // every read of Vs and Pt is done
    if (more) stage_kv<T, DPV, NT>(Vs, vb, vs.s, kn, Sk, Dv, vec, false);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int R = R0 + 4 * rg + i, pos = R / G;
    if (pos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)(R % G) * os.h + pos * os.s;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = 4 * (kl + 8 * jj);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * jj + e] / den;
      store4(orow + d, x, d, Dv, vec);
    }
  }
}

template <typename T, int DPK, int DPV, int BQ>
int launch_dp(const T* q, const T* k, const T* v, T* o, int B, int H,
              int Hk, int Sq, int Sk, int Dk, int Dv, Strides qs,
              Strides ks, Strides vs, Strides os, int causal, int window,
              int q_offset, int prefix, float scale, int vec,
              cudaStream_t stream) {
  constexpr int smem = smem_bytes<DPK, DPV, BQ>();
  static bool ready[64] = {};   // the attributes, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !ready[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DPK, DPV, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_kernel<T, DPK, DPV, BQ>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  const int G = H / Hk;
  const long long tiles = ((long long)G * Sq + BQ - 1) / BQ;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(B * Hk, (unsigned)tiles);
  flash_fwd_kernel<T, DPK, DPV, BQ><<<grid, 2 * BQ, smem, stream>>>(
      q, k, v, o, G, Hk, Sq, Sk, Dk, Dv, qs, ks, vs, os, causal, window,
      q_offset, prefix, scale, vec);
  return (int)cudaGetLastError();
}

// The instantiated (DPK, DPV, BQ) triples: the wrapper's plan
// (flash_attention.plan: equal widths up to 128 and MLA's reduced (64, 32)
// at 64 rows, (192, 128) at 128), and for f32 (128, 128) at 32 and 128
// rows, to measure the block shape (chip_smoke.py's split phase). The
// caller names the triple; columns past Dk or Dv are zeros.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Sq, int Sk, int Dk, int Dv,
           const long long* st, int causal, int window, int q_offset,
           int prefix, float scale, int dpk, int dpv, int bq,
           void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hk <= 0 || H % Hk != 0 || Dk <= 0 || Dv <= 0 || Dk > dpk || Dv > dpv)
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  // 4-element loads and stores need aligned bases and strides
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  int vec = bases % (4 * sizeof(T)) == 0;
  for (int i = 0; i < 12; ++i) vec &= st[i] % 4 == 0;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(DPK, DPV, BQ)                                          \
  if (dpk == DPK && dpv == DPV && bq == BQ)                               \
    return launch_dp<T, DPK, DPV, BQ>(qp, kp, vp, op, B, H, Hk, Sq, Sk, Dk, \
                                      Dv, qs, ks, vs, os, causal, window,   \
                                      q_offset, prefix, scale, vec, s);
  FLASH_CASE(32, 32, 64)
  FLASH_CASE(64, 64, 64)
  FLASH_CASE(96, 96, 64)
  FLASH_CASE(128, 128, 64)
  FLASH_CASE(64, 32, 64)
  FLASH_CASE(192, 128, 128)
  if constexpr (sizeof(T) == 4) {
    FLASH_CASE(128, 128, 32)
    FLASH_CASE(128, 128, 128)
  }
  return (int)cudaErrorInvalidValue;
#undef FLASH_CASE
}

}  // namespace

// strides: 12 element strides (batch, head, seq) of q, k, v and o, each
// viewed as (B, heads, S, D) with unit stride along D; q and k have Dk
// columns, v and o have Dv
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hk, int Sq, int Sk, int Dk, int Dv,
                                   const long long* strides, int causal,
                                   int window, int q_offset, int prefix,
                                   float scale, int dpk, int dpv, int bq,
                                   void* stream) {
  return launch<float>(q, k, v, o, B, H, Hk, Sq, Sk, Dk, Dv, strides,
                       causal, window, q_offset, prefix, scale, dpk, dpv,
                       bq, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hk, int Sq, int Sk, int Dk, int Dv,
                                    const long long* strides, int causal,
                                    int window, int q_offset, int prefix,
                                    float scale, int dpk, int dpv, int bq,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Sk, Dk, Dv,
                               strides, causal, window, q_offset, prefix,
                               scale, dpk, dpv, bq, stream);
}
