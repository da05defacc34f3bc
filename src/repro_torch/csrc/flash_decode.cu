// Single-token GQA decode attention over a contiguous KV cache with a
// validity mask, for Hopper.
//
// Replaces the Pallas kernel `flash_decode`
// (src/repro/kernels/decode_attention.py:144, body `_decode_kernel`):
// one query token per request attends over a (B, Smax, K, D) cache whose
// occupied slots a (Smax,) or per-request (B, Smax) mask marks. It runs
// the attention of every layer of every decode step of the port
// (`models.attention.decode_attention` -> `kernels.ops.gqa_flash_decode`),
// the fleet serving session's included.
//
// Roundings: those of the TPU kernel. The query is scaled in f32, scores
// and sums are f32, the un-normalised probabilities p = exp(s - m) are
// rounded to the cache's type before the p·V product, and the output is
// acc / max(l, 1e-30) in the cache's type; a request with no valid slot
// gives zeros (the model never forms one).
//
// What bounds it on an H100: the K and V bytes (each read once) over the
// memory rate; the arithmetic, 4·G·D per token and kv head, is far below
// the card's rate. At the serving path's size (a few requests of a few
// dozen tokens) a launch is a few microseconds of work and launch latency
// dominates; at a 32k-token cache the bytes do.
//
// Design: the key axis of each (kv head, request) is cut into splits of at
// most 1024 slots (more splits when there are few requests and heads, so
// that the grid fills the 132 SMs); one block of 8 warps per (kv head,
// request, split). The G query rows of the group sit in shared memory,
// scaled. Each warp takes one key at a time: the lanes read the key's D
// values (neighbouring lanes on neighbouring addresses), form the G dot
// products and reduce them with shuffles; the split's scores stay in
// shared memory. One warp per query row then takes the split's max m, the
// probabilities and their sum l. The p·V product has each thread own one
// of the D columns over a share of the keys, with the G rows' sums in
// registers, and the shares are added through shared memory. With one
// split the block writes the output; with several it writes (m, l, acc)
// and a second kernel combines the splits with weights exp(m_i - max m).
// Query head h reads kv head h / G by index, and the cache is read through
// its strides: nothing is copied before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;          // query rows per kv head
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

struct Strides {  // element strides of a (B, Smax, K, D) cache; D is unit
  long long b, s, k;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const unsigned char* __restrict__ valid,
                    long long valid_b, T* __restrict__ out,
                    float* __restrict__ part, int Kh, int G, int D, int S,
                    int split, int nsplit, float scale, Strides ks,
                    Strides vs) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                  // (G, D) scaled queries
  float* sc = qs + G * D;          // (G, split) scores, then rounded p
  float* red = sc + G * split;     // (THREADS / D, G, D) partial p·V sums
  float* mrow = red + G * THREADS; // (G,)
  float* lrow = mrow + G;          // (G,)

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = sp * split;
  const int n = min(split, S - j0);
  const unsigned char* ok = valid + b * valid_b + j0;
  const T* kb = kc + b * ks.b + kh * ks.k + j0 * ks.s;
  const T* vb = vc + b * vs.b + kh * vs.k + j0 * vs.s;
  const float* qb = q + ((long long)b * Kh + kh) * G * D;

  for (int i = tid; i < G * D; i += THREADS) qs[i] = qb[i] * scale;
  __syncthreads();

  // scores: one key per warp at a time, the lanes across D
  for (int jj = warp; jj < n; jj += WARPS) {
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kv = to_f32(kb[jj * ks.s + d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) s[g] = fmaf(qs[g * D + d], kv, s[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
    }
    if (lane == 0) {
      const bool v_ok = ok[jj] != 0;
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) sc[g * split + jj] = v_ok ? s[g] : NEG_INF;
    }
  }
  __syncthreads();

  // the split's max, probabilities (rounded to the cache type for p·V)
  // and their sum, one warp per query row
  for (int g = warp; g < G; g += WARPS) {
    float m = NEG_INF;
    for (int jj = lane; jj < n; jj += 32) m = fmaxf(m, sc[g * split + jj]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float p = ok[jj] ? expf(sc[g * split + jj] - m) : 0.f;
      l += p;
      sc[g * split + jj] = to_f32(from_f32<T>(p));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      mrow[g] = m;
      lrow[g] = l;
    }
  }
  __syncthreads();

  // p·V: thread (key share kg, column d), the G rows in registers
  const int kgs = THREADS / D;
  const int kg = tid / D, d = tid % D;
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  for (int jj = kg; jj < n; jj += kgs) {
    const float vv = to_f32(vb[jj * vs.s + d]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) acc[g] = fmaf(sc[g * split + jj], vv, acc[g]);
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) red[(kg * G + g) * D + d] = acc[g];
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float a = 0.f;
    for (int r = 0; r < kgs; ++r) a += red[r * G * D + i];
    if (nsplit == 1) {
      out[((long long)b * Kh + kh) * G * D + i] =
          from_f32<T>(a / fmaxf(lrow[g], 1e-30f));
    } else {
      float* pb = part + (((long long)b * Kh + kh) * nsplit + sp)
                             * (G * D + 2 * G);
      pb[i] = a;
      if (i % D == 0) {
        pb[G * D + g] = mrow[g];
        pb[G * D + G + g] = lrow[g];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      int Kh, int G, int D, int nsplit) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const long long row = (long long)b * Kh + kh;
  const int w = G * D + 2 * G;
  const float* pb = part + row * nsplit * w;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D;
    float mmax = NEG_INF;
    for (int s = 0; s < nsplit; ++s) mmax = fmaxf(mmax, pb[s * w + G * D + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float c = expf(pb[s * w + G * D + g] - mmax);
      l = fmaf(pb[s * w + G * D + G + g], c, l);
      a = fmaf(pb[s * w + i], c, a);
    }
    out[row * G * D + i] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* valid,
           long long valid_b, void* out, void* part, int B, int Kh, int G,
           int D, int S, int split, int nsplit, float scale,
           const long long* st, int smem_bytes, void* stream) {
  if (G < 1 || G > GMAX || D < 1 || D > THREADS || THREADS % D != 0
      || split < 1 || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Kh <= 0 || S <= 0) return (int)cudaGetLastError();
  // above 48 KB of dynamic shared memory only after this opt-in
  const cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const Strides ks{st[0], st[1], st[2]}, vs{st[3], st[4], st[5]};
  dim3 grid(Kh, B, nsplit);
  decode_split_kernel<T><<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const unsigned char*>(valid),
      valid_b, static_cast<T*>(out), static_cast<float*>(part), Kh, G, D, S,
      split, nsplit, scale, ks, vs);
  int err = (int)cudaGetLastError();
  if (err || nsplit == 1) return err;
  dim3 grid2(Kh, B);
  decode_combine_kernel<T><<<grid2, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), Kh, G, D,
      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Kh, G, D) float32, contiguous; k/v caches float32 or bfloat16 with
// (b, s, k) element strides st[0:3] and st[3:6]; valid: bytes, row b at
// valid + b * valid_b (valid_b = 0 shares one row); out: (B, Kh, G, D) in
// the cache type; part: nsplit > 1 scratch of B·Kh·nsplit·(G·D + 2G)
// floats.
extern "C" int flash_decode_f32(const void* q, const void* kc, const void* vc,
                                const void* valid, long long valid_b,
                                void* out, void* part, int B, int Kh, int G,
                                int D, int S, int split, int nsplit,
                                float scale, const long long* st,
                                int smem_bytes, void* stream) {
  return launch<float>(q, kc, vc, valid, valid_b, out, part, B, Kh, G, D, S,
                       split, nsplit, scale, st, smem_bytes, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* kc,
                                 const void* vc, const void* valid,
                                 long long valid_b, void* out, void* part,
                                 int B, int Kh, int G, int D, int S,
                                 int split, int nsplit, float scale,
                                 const long long* st, int smem_bytes,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, kc, vc, valid, valid_b, out, part, B, Kh,
                               G, D, S, split, nsplit, scale, st, smem_bytes,
                               stream);
}
