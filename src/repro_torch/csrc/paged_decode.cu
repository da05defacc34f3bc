// Paged single-token GQA decode for Hopper.
//
// Replaces the Pallas kernel `flash_decode_paged`
// (src/repro/kernels/decode_attention.py:97, body `_paged_kernel`): one
// decode token's attention reads the K/V page pools in place, steered by a
// per-request page table, with an online softmax in f32.
//
// What bounds it on an H100: the K/V bytes of the pages a request holds
// (each read once) over the memory rate; the arithmetic is 4·G·D per token
// and head, far below the card's rate. At the serving path's sizes (a few
// requests of a few dozen tokens) one launch is a few microseconds of
// work, so the launch itself dominates.
//
// Design: one block per (kv-head, request). The block loads its own page
// ids and walks its pages in order (the TPU's sequential grid axis becomes
// a loop). Each page's K and V land in shared memory as f32; one warp per
// (query row, token) pair takes the q·k dot with a shuffle reduction; G
// threads then update the running max and denominator, and every thread
// folds the page into the accumulator for its (row, dim) entries. Only the
// pages that hold tokens are read: positions at or past lengths[b] are
// masked, a page past the length contributes exactly nothing to the online
// softmax, so stopping there changes no value. A request of length 0 reads
// no page and writes zeros (acc / max(l, 1e-30)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ lens, T* __restrict__ out,
                    int Kh, int G, int D, int page, int maxp, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // (G, D) scaled queries
  float* ks = qs + G * D;          // (page, D)
  float* vs = ks + page * D;       // (page, D)
  float* sc = vs + page * D;       // (G, page) scores, then probabilities
  float* acc = sc + G * page;      // (G, D)
  float* mrun = acc + G * D;       // (G,)
  float* lrun = mrun + G;          // (G,)
  float* corr = lrun + G;          // (G,)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int len = lens[b];
  const float* qb = q + ((long long)b * Kh + kh) * G * D;

  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = qb[i] * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < G; i += THREADS) {
    mrun[i] = NEG_INF;
    lrun[i] = 0.f;
  }
  __syncthreads();

  const int npages = len > 0 ? min(maxp, (len + page - 1) / page) : 0;
  for (int j = 0; j < npages; ++j) {
    const long long pid = pt[(long long)b * maxp + j];
    for (int i = tid; i < page * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const long long off = ((pid * page + t) * Kh + kh) * D + d;
      ks[i] = to_f32(kp[off]);
      vs[i] = to_f32(vp[off]);
    }
    __syncthreads();
    for (int pr = warp; pr < G * page; pr += THREADS / 32) {
      const int gq = pr / page, t = pr % page;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(qs[gq * D + d], ks[t * D + d], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc[pr] = (j * page + t < len) ? s : NEG_INF;
    }
    __syncthreads();
    for (int gq = tid; gq < G; gq += THREADS) {
      const float mprev = mrun[gq];
      float mnew = mprev;
      for (int t = 0; t < page; ++t) mnew = fmaxf(mnew, sc[gq * page + t]);
      float psum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float p = (j * page + t < len) ? expf(sc[gq * page + t] - mnew)
                                             : 0.f;
        psum += p;
        // the p·V product takes p in the pool's type, as the TPU kernel does
        sc[gq * page + t] = to_f32(from_f32<T>(p));
      }
      const float c = expf(mprev - mnew);
      lrun[gq] = lrun[gq] * c + psum;
      mrun[gq] = mnew;
      corr[gq] = c;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {
      const int gq = i / D, d = i % D;
      float pv = 0.f;
      for (int t = 0; t < page; ++t) pv = fmaf(sc[gq * page + t], vs[t * D + d], pv);
      acc[i] = acc[i] * corr[gq] + pv;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * Kh + kh) * G * D;
  for (int i = tid; i < G * D; i += THREADS)
    ob[i] = from_f32<T>(acc[i] / fmaxf(lrun[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* lens, void* out, int B, int Kh, int G, int D, int page,
           int maxp, float scale, int smem_bytes, void* stream) {
  if (B <= 0 || Kh <= 0) return (int)cudaGetLastError();
  dim3 grid(Kh, B);
  paged_decode_kernel<T><<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<T*>(out), Kh, G, D, page,
      maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_f32(const void* q, const void* kp, const void* vp,
                                const void* pt, const void* lens, void* out,
                                int B, int Kh, int G, int D, int page,
                                int maxp, float scale, int smem_bytes,
                                void* stream) {
  return launch<float>(q, kp, vp, pt, lens, out, B, Kh, G, D, page, maxp,
                       scale, smem_bytes, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* pt,
                                 const void* lens, void* out, int B, int Kh,
                                 int G, int D, int page, int maxp, float scale,
                                 int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, pt, lens, out, B, Kh, G, D, page,
                               maxp, scale, smem_bytes, stream);
}
