// Flash attention (forward) for Hopper: causal and sliding-window masks,
// GQA by index, safe for fully masked rows.
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention.py:64, body `_flash_kernel`): per
// (batch, head) and tile of query rows, s = (q·scale)·kᵀ in f32, masked
// (kpos <= qpos when causal, kpos > qpos - window when a window is set),
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
// (~0.016 ms vs ~0.013 ms). This first version computes in f32 FMA on the
// CUDA cores (no TF32: the model path passes f32 operands and the port is
// held to IEEE f32); the tensor cores are later work.
//
// Design: one block per (tile of BQ = 32 query rows, batch x head). The
// TPU's sequential key axis is a loop inside the block over key tiles of
// BK = 64, which stages K (transposed) and V in shared memory as f32.
// Each of the 256 threads owns 2 query rows x 4 keys of the score tile and
// 2 rows x D/16 columns of the accumulator, in registers; the row max and
// sum reduce over the 16 threads of a row group with warp shuffles, and
// the rounded probabilities go through shared memory to the p·v product.
// Key tiles that the causal or window mask hides entirely are skipped:
// they add nothing to the online softmax, so no value changes. Query
// head h reads kv head h / (H / Hk). Ragged Sq and Sk are masked, not
// padded. Operands are addressed through strides, so the (B, S, H, D)
// layout of the model is read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 row groups of 2 rows x 16 threads
constexpr int RT = 2;         // query rows per thread
constexpr int CT = BK / 16;   // keys per thread in a score tile
constexpr float NEG_INF = -1e30f;

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

struct Strides {  // element strides of a (B, heads, S, D) view; D is unit
  long long b, h, s;
};

template <typename T, int DJ>  // DJ = accumulator columns per thread
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hk,
                 int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, int q_offset,
                 float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                      // (BQ, D + 1) scaled queries
  float* Kt = Qs + BQ * (D + 1);       // (D, BK + 1) keys, transposed
  float* Vs = Kt + D * (BK + 1);       // (BK, D) values
  float* Ps = Vs + BK * D;             // (BQ, BK + 1) rounded p

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / Hk);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // key / column lane within a row group
  const int ty = tid / 16;   // row group: rows ty*RT .. ty*RT + RT - 1

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[r * (D + 1) + d] =
        (q0 + r < Sq) ? to_f32(qb[(q0 + r) * qs.s + d]) * scale : 0.f;
  }

  float m[RT], l[RT], acc[RT][DJ];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // key tiles the tile's rows can see; the rest are wholly masked
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + BQ, Sq) - 1;
  int kend = Sk;
  if (causal) kend = max(0, min(Sk, qhi + 1));
  int kbeg = 0;
  if (window > 0) kbeg = max(0, qlo - window + 1) / BK * BK;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < Sk;
      Kt[d * (BK + 1) + c] = in ? to_f32(kb[(k0 + c) * ks.s + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32(vb[(k0 + c) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RT], kv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = Qs[(ty * RT + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CT; ++j) kv[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float corr[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty * RT + i;
      const int qpos = q_offset + q0 + r;
      bool ok[CT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Sk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mnew = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mnew) : 0.f;
        psum += p;
        // the p·v product takes p in v's type, as the TPU kernel does
        Ps[r * (BK + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o2);
      corr[i] = expf(m[i] - mnew);
      l[i] = l[i] * corr[i] + psum;
      m[i] = mnew;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < BK; ++c) {
      float pr[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pr[i] = Ps[(ty * RT + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty * RT + i;
    if (row >= Sq) continue;
    const float inv_den = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[row * os.s + d] = from_f32<T>(acc[i][j] * inv_den);
    }
  }
}

template <typename T, int DJ>
int launch_dj(const T* q, const T* k, const T* v, T* o, int B, int H,
              int Hk, int Sq, int Sk, int D, Strides qs, Strides ks,
              Strides vs, Strides os, int causal, int window, int q_offset,
              float scale, cudaStream_t stream) {
  const int smem =
      4 * (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, DJ><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, H, Hk, Sq, Sk, D, qs, ks, vs, os, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hk, int Sq, int Sk, int D, const long long* st,
           int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hk <= 0 || H % Hk != 0 || D <= 0 || D > 128 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return launch_dj<T, 2>(qp, kp, vp, op, B, H, Hk, Sq, Sk, D, qs, ks, vs,
                           os, causal, window, q_offset, scale, s);
  if (D <= 64)
    return launch_dj<T, 4>(qp, kp, vp, op, B, H, Hk, Sq, Sk, D, qs, ks, vs,
                           os, causal, window, q_offset, scale, s);
  return launch_dj<T, 8>(qp, kp, vp, op, B, H, Hk, Sq, Sk, D, qs, ks, vs,
                         os, causal, window, q_offset, scale, s);
}

}  // namespace

// strides: 12 element strides (batch, head, seq) of q, k, v and o, each
// viewed as (B, heads, S, D) with unit stride along D
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hk, int Sq, int Sk, int D,
                                   const long long* strides, int causal,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, o, B, H, Hk, Sq, Sk, D, strides, causal,
                       window, q_offset, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hk, int Sq, int Sk, int D,
                                    const long long* strides, int causal,
                                    int window, int q_offset, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hk, Sq, Sk, D, strides,
                               causal, window, q_offset, scale, stream);
}
