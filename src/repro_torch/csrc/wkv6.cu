// RWKV-6 ("Finch") WKV recurrence for Hopper, chunked, with a carried state.
//
// Replaces the Pallas kernel `wkv6` (src/repro/kernels/wkv6.py:66, body
// `_wkv_kernel`). Per (batch, head), with an hd x hd f32 state S:
//   y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
//   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
// evaluated in the chunked form of `repro.models.rwkv.wkv_chunked` (the
// jnp twin of the Pallas kernel): inside a chunk of c steps, with W the
// inclusive cumulative sum of log w over the chunk and W_{t-1} the
// exclusive one,
//   y_t = (r_t ⊙ exp(W_{t-1})) S_in + Σ_{j<t} A[t,j] v_j + (r_t·(u ⊙ k_t)) v_t,
//   A[t,j] = Σ_d r_t[d] k_j[d] exp(W_{t-1}[d] - W_j[d]),
//   S_out = diag(exp(W_{c-1})) S_in + Σ_j (k_j ⊙ exp(W_{c-1} - W_j)) v_jᵀ.
// It runs the time mix of every RWKV forward, prefill and decode step of
// the port (`models.rwkv.wkv_chunked` -> `kernels.ops.wkv6`).
//
// What bounds it on an H100: at the training shape (B 8, S 128, 64 heads
// of 64, chunks of 32) the chunked form is ~1.6 GFLOP against ~59 MB of
// r, k, v (bf16), w and y (f32), so the f32 CUDA-core rate (67 TFLOP/s,
// ~0.024 ms) bounds it just above the memory rate (~0.018 ms). This first
// version computes in f32 FMA on the CUDA cores; the tensor cores are
// later work.
//
// Design: one block per (head, batch) row, 256 threads. The TPU kernel's
// sequential chunk axis (state carried in VMEM) becomes a loop inside the
// block, with the 64 x 64 f32 state in shared memory (16 KB) and each
// chunk's r, k, v and log w staged there as f32 (rows padded to 65 floats
// so that threads on different rows hit different banks). Every pairwise
// decay is exp of the masked difference W_{t-1} - W_j, which is <= 0 for
// j < t (the factored exp(W_{t-1})·exp(-W_j) overflows); w is clamped at
// 1e-12 before the log. Operands are addressed through the strides of the
// (B, S, H, hd) layout, so no transpose precedes the launch, and u[h] is
// indexed in place. Chunks are at most 32 steps: any S runs, the last chunk
// ragged (S = 1 for decode); shared memory never grows with S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXT = 32;          // steps per chunk
constexpr int MAXHD = 64;         // head dims the kernel is built for
constexpr int HP = MAXHD + 1;     // padded row of a staged chunk
constexpr int OUT_PER_THREAD = MAXT * MAXHD / THREADS;     // 8
constexpr int STATE_PER_THREAD = MAXHD * MAXHD / THREADS;  // 16
constexpr int SMEM_FLOATS = MAXHD * MAXHD + 5 * MAXT * HP + MAXT * (MAXT + 1)
                            + MAXHD;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {  // element strides of a (B, S, H, hd) view; hd is unit
  long long b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int H, int S,
            int hd, int tile, Strides rs, Strides ks, Strides vs, Strides ws,
            Strides ys) {
  extern __shared__ __align__(16) float sm[];
  float* St = sm;                    // (hd, hd) state, St[d * hd + e]
  float* rr = St + MAXHD * MAXHD;    // (MAXT, HP) r
  float* kk = rr + MAXT * HP;        // k, then k ⊙ exp(W_{c-1} - W_j)
  float* vv = kk + MAXT * HP;        // v
  float* cw = vv + MAXT * HP;        // log w, then W (inclusive cumsum)
  float* rw = cw + MAXT * HP;        // r ⊙ exp(W_{t-1})
  float* A = rw + MAXT * HP;         // (MAXT, MAXT + 1) intra-chunk scores
  float* uu = A + MAXT * (MAXT + 1); // (hd,) bonus

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long bh = (long long)b * H + h;
  const int nst = hd * hd;

  for (int i = tid; i < nst; i += THREADS)
    St[i] = s0 ? s0[bh * nst + i] : 0.f;
  for (int d = tid; d < hd; d += THREADS) uu[d] = u[(long long)h * hd + d];

  for (int c0 = 0; c0 < S; c0 += tile) {
    const int c = min(tile, S - c0);
    __syncthreads();   // the previous chunk's state update is done
    for (int i = tid; i < c * hd; i += THREADS) {
      const int t = i / hd, d = i % hd;
      const long long p = c0 + t;
      rr[t * HP + d] = to_f32(r[b * rs.b + p * rs.s + h * rs.h + d]);
      kk[t * HP + d] = to_f32(k[b * ks.b + p * ks.s + h * ks.h + d]);
      vv[t * HP + d] = to_f32(v[b * vs.b + p * vs.s + h * vs.h + d]);
      cw[t * HP + d] = logf(fmaxf(w[b * ws.b + p * ws.s + h * ws.h + d],
                                  1e-12f));
    }
    __syncthreads();
    for (int d = tid; d < hd; d += THREADS) {   // W_t, inclusive
      float run = 0.f;
      for (int t = 0; t < c; ++t) {
        run += cw[t * HP + d];
        cw[t * HP + d] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < c * hd; i += THREADS) {
      const int t = i / hd, d = i % hd;
      const float wprev = t ? cw[(t - 1) * HP + d] : 0.f;
      rw[t * HP + d] = rr[t * HP + d] * expf(wprev);
    }
    for (int i = tid; i < c * c; i += THREADS) {
      const int t = i / c, j = i % c;
      float a = 0.f;
      if (j < t) {
        for (int d = 0; d < hd; ++d)
          a = fmaf(rr[t * HP + d] * kk[j * HP + d],
                   expf(cw[(t - 1) * HP + d] - cw[j * HP + d]), a);
      } else if (j == t) {
        for (int d = 0; d < hd; ++d)
          a = fmaf(rr[t * HP + d], uu[d] * kk[t * HP + d], a);
      }
      A[t * (MAXT + 1) + j] = a;
    }
    __syncthreads();
    // outputs: inter-chunk term against the incoming state, then the
    // intra-chunk scores (diagonal bonus included) against v
#pragma unroll
    for (int n = 0; n < OUT_PER_THREAD; ++n) {
      const int i = tid + n * THREADS;
      if (i < c * hd) {
        const int t = i / hd, e = i % hd;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d)
          acc = fmaf(rw[t * HP + d], St[d * hd + e], acc);
        float intra = 0.f;
        for (int j = 0; j <= t; ++j)
          intra = fmaf(A[t * (MAXT + 1) + j], vv[j * HP + e], intra);
        const long long p = c0 + t;
        y[b * ys.b + p * ys.s + h * ys.h + e] = acc + intra;
      }
    }
    // carry: k_j ⊙ exp(W_{c-1} - W_j), in place (A is formed already)
    for (int i = tid; i < c * hd; i += THREADS) {
      const int j = i / hd, d = i % hd;
      kk[j * HP + d] *= expf(cw[(c - 1) * HP + d] - cw[j * HP + d]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < STATE_PER_THREAD; ++n) {
      const int i = tid + n * THREADS;
      if (i < nst) {
        const int d = i / hd, e = i % hd;
        float acc = 0.f;
        for (int j = 0; j < c; ++j)
          acc = fmaf(kk[j * HP + d], vv[j * HP + e], acc);
        St[i] = fmaf(St[i], expf(cw[(c - 1) * HP + d]), acc);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nst; i += THREADS) s_out[bh * nst + i] = St[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int H,
           int S, int hd, int tile, const long long* st, void* stream) {
  if (hd < 1 || hd > MAXHD || tile < 1 || tile > MAXT)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  // above 48 KB of dynamic shared memory only after this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  dim3 grid(H, B);
  wkv6_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), H, S, hd, tile, rs,
      ks, vs, ws, ys);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v in float32 or bfloat16; w, u, s0 (may be null: zero state), y
// and s_out in float32. st holds the (b, s, h) element strides of r, k,
// v, w and y, in that order.
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* y,
                        void* s_out, int B, int H, int S, int hd, int tile,
                        const long long* st, void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, s_out, B, H, S, hd, tile, st,
                       stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* s_out, int B, int H, int S, int hd,
                         int tile, const long long* st, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, S, hd,
                               tile, st, stream);
}
