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
// Roundings: per split of the key axis, those of the TPU kernel's block.
// The query is scaled in f32, scores and sums are f32 on the CUDA cores,
// the split's un-normalised probabilities p = exp(s - m_split) are rounded
// to the cache's type before the p·V product, and the splits combine in
// split order with weights exp(m_i - max m); the output is
// acc / max(l, 1e-30) in the cache's type. A request with no valid slot
// gives zeros (the model never forms one).
//
// What bounds it on an H100: the bytes of the occupied K and V slots (each
// read once) over the memory rate; the arithmetic, 4·G·D per slot and kv
// head, is far below the card's rate. The rate needs tens of KB of loads
// in flight on every SM, so the design is a copy pipeline first.
//
// Design: one block of 256 threads per (kv head, request, split); the
// splits (`decode_splits` in kernels/decode_attention.py) give the grid
// its blocks. The block stages the split's mask in shared memory, finds
// its last valid slot, and streams the split's K tiles and then its V
// tiles through a ring of STAGES 16 KB stages, filled by 16-byte cp.async
// copies (three stages in flight, 48 KB a block, two blocks an SM). A
// masked slot's row is zero-filled without reading memory. Each key row
// lands once and serves all G query rows: a key's QT threads each take
// CPT 16-byte slices of it (an XOR swizzle keeps the lanes of a phase on
// distinct banks), form G partial dot products against the scaled
// queries in shared memory, and add them across the QT lanes with
// log2(QT) shuffles per row, over the key's whole slice set at once. The
// split's scores wait in shared memory for its max; p is formed and
// rounded once, then each thread accumulates 4 columns of p·V for all G
// rows over a share of the V tile's keys, and the shares are added
// through shared memory (the ring's space) at the end. With one split the
// block writes the output; with several it writes (acc, m, l) and a second
// kernel combines them in split order. Query head h reads kv head h / G by
// index, and q and the caches are read through their strides: nothing is
// copied before the launch. Caches whose bases, strides or rows are not
// 16-byte multiples take the element route: the same pipeline, filled by
// ordinary loads (the wrapper picks the route by that rule and counts
// launches by route).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS_MAX = 16;       // query rows per kv head
constexpr int STAGES = 4;            // ring depth: three tiles in flight
constexpr int STAGE_CHUNKS = 4;      // 16-byte slices a thread copies a tile
constexpr int SMEM_MAX = 232448;     // an H100 block's dynamic shared memory
constexpr float NEG_INF = -1e30f;

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

// the 16 bytes at p as f32: 4 floats, or 8 bf16 (bits in the high half)
__device__ __forceinline__ void unpack16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// 4 consecutive elements at p as f32
__device__ __forceinline__ void unpack4(const float* p, float (&x)[4]) {
  unpack16(p, x);
}
__device__ __forceinline__ void unpack4(const __nv_bfloat16* p,
                                        float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

struct Strides {  // element strides of a (B, Smax, K, D) cache; D is unit
  long long b, s, k;
};

// The tile geometry, from the padded head dim DP (a power of two whose
// rows are at least 16 bytes) and the element size.
struct Geo {
  int cpr;     // 16-byte chunks per row
  int lcpr;    // log2(cpr)
  int cpt;     // chunks a thread copies (and scores) per tile
  int qt;      // threads per key in the score phase
  int tk;      // keys per tile
  int swz;     // rows the XOR swizzle spreads over
  int ns4;     // 4-column slices per row (p·V phase)
  int ks;      // key shares of the p·V phase
  int stage;   // bytes per stage
  __device__ Geo(int DP, int esz) {
    cpr = DP * esz / 16;
    lcpr = 31 - __clz(cpr);
    cpt = cpr < STAGE_CHUNKS ? cpr : STAGE_CHUNKS;
    qt = cpr / cpt;
    tk = THREADS / qt;
    swz = (cpr >= 8 && qt < 8) ? 8 / qt : 1;
    ns4 = DP / 4;
    ks = THREADS / ns4;
    stage = THREADS * cpt * 16;
  }
  // byte offset of (row j, logical chunk ch) in a stage
  __device__ __forceinline__ int at(int j, int ch) const {
    return (j * cpr + (ch ^ ((j & (swz - 1)) * qt))) * 16;
  }
};

template <typename T, typename Q, int GB>
__global__ void __launch_bounds__(THREADS, GB <= 8 ? 2 : 1)
decode_split_kernel(const Q* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const unsigned char* __restrict__ valid,
                    long long valid_b, T* __restrict__ out,
                    float* __restrict__ part, int Kh, int G, int D, int DP,
                    int S, int split, int nsplit, float scale,
                    long long q_b, long long q_h, Strides ks, Strides vs,
                    int async16) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Geo geo(DP, (int)sizeof(T));
  const int region = max(STAGES * geo.stage, THREADS * 16 * G);
  unsigned char* ring = smem;                       // STAGES tiles
  float* red = reinterpret_cast<float*>(smem);      // (ks, G, DP), at the end
  float* sc = reinterpret_cast<float*>(smem + region);  // (split, GB)
  float* qs = sc + split * GB;                      // (GB, DP) scaled q
  float* wred = qs + GB * DP;                       // (2, WARPS, GB)
  int* wlast = reinterpret_cast<int*>(wred + 2 * WARPS * GB);  // (WARPS,)
  unsigned char* ok = reinterpret_cast<unsigned char*>(wlast + WARPS);

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = sp * split;
  const int n = min(split, S - j0);
  const T* kb = kc + b * ks.b + kh * ks.k + (long long)j0 * ks.s;
  const T* vb = vc + b * vs.b + kh * vs.k + (long long)j0 * vs.s;

  for (int i = tid; i < GB * DP; i += THREADS) {
    const int g = i / DP, d = i % DP;
    qs[i] = (g < G && d < D)
                ? to_f32(q[b * q_b + (long long)(kh * G + g) * q_h + d]) * scale
                : 0.f;
  }
  // the split's mask, and its last valid slot: tiles past it are skipped
  const unsigned char* vrow = valid + b * valid_b + j0;
  int last = -1;
  for (int i = tid; i < n; i += THREADS) {
    const unsigned char o = vrow[i] != 0;
    ok[i] = o;
    if (o) last = i;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) wlast[warp] = last;
  __syncthreads();
  int neff = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) neff = max(neff, wlast[w] + 1);
  const int nt = (neff + geo.tk - 1) / geo.tk;      // key tiles

  // tile `it` of the stream: K tiles 0..nt-1, then V tiles
  auto fill = [&](int it) {
    if (it >= 2 * nt) return;
    const bool isv = it >= nt;
    const int base = (isv ? it - nt : it) * geo.tk;
    const T* src = isv ? vb : kb;
    const long long ss = isv ? vs.s : ks.s;
    unsigned char* st = ring + (it % STAGES) * geo.stage;
#pragma unroll
    for (int i = 0; i < STAGE_CHUNKS; ++i) {
      if (i < geo.cpt) {
        const int L = tid + THREADS * i;
        const int j = L >> geo.lcpr, ch = L & (geo.cpr - 1);
        const int jj = base + j;
        const bool live = jj < neff && ok[jj];
        const T* g = src + (long long)jj * ss + ch * VEC;
        unsigned char* dst = st + geo.at(j, ch);
        if (async16) {
          cp_async16(dst, live ? g : src, live);
        } else {
          union { uint4 u; T e[VEC]; } x;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            x.e[e] = (live && ch * VEC + e < D) ? g[e] : from_f32<T>(0.f);
          *reinterpret_cast<uint4*>(dst) = x.u;
        }
      }
    }
  };

  const int sj = tid / geo.qt, sc_part = tid % geo.qt;   // score phase
  const int cs = tid % geo.ns4, ksh = tid / geo.ns4;     // p·V phase
  float acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    fill(s);
    cp_async_commit();
  }
  for (int it = 0; it < 2 * nt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile `it` is in; tile it-1's stage is free
    fill(it + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (it % STAGES) * geo.stage;
    if (it < nt) {
      // scores of the tile's keys: this thread's slices of key sj
      float s[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll
      for (int i = 0; i < STAGE_CHUNKS; ++i) {
        if (i < geo.cpt) {
          const int ch = sc_part + geo.qt * i;
          float kf[VEC];
          unpack16(reinterpret_cast<const T*>(st + geo.at(sj, ch)), kf);
          const float* qrow = qs + ch * VEC;
#pragma unroll
          for (int g = 0; g < GB; ++g) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qrow + g * DP + e);
              s[g] = fmaf(qv.x, kf[e], s[g]);
              s[g] = fmaf(qv.y, kf[e + 1], s[g]);
              s[g] = fmaf(qv.z, kf[e + 2], s[g]);
              s[g] = fmaf(qv.w, kf[e + 3], s[g]);
            }
          }
        }
      }
      for (int o = 1; o < geo.qt; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GB; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      const int jj = it * geo.tk + sj;
      if (jj < neff) {
        const bool v_ok = ok[jj];
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if ((g & (geo.qt - 1)) == sc_part) sc[jj * GB + g] = v_ok ? s[g] : NEG_INF;
      }
    } else {
      if (it == nt) {
        // the split's max m per row, then p = exp(s - m) rounded to the
        // cache type, and the partial sums of p; thread (row g, share r)
        const int g = tid % GB, r = tid / GB;
        float m = NEG_INF;
        for (int j = r; j < neff; j += THREADS / GB)
          m = fmaxf(m, sc[j * GB + g]);
#pragma unroll
        for (int o = 16; o >= GB; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane < GB) wred[warp * GB + lane] = m;
        __syncthreads();
        m = NEG_INF;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) m = fmaxf(m, wred[w * GB + g]);
        float l = 0.f;
        for (int j = r; j < neff; j += THREADS / GB) {
          const float p = ok[j] ? expf(sc[j * GB + g] - m) : 0.f;
          l += p;
          sc[j * GB + g] = to_f32(from_f32<T>(p));
        }
#pragma unroll
        for (int o = 16; o >= GB; o >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane < GB) wred[(WARPS + warp) * GB + lane] = l;
        __syncthreads();
      }
      // p·V over this thread's share of the tile's keys, 4 columns
      const int base = (it - nt) * geo.tk;
      const int per = geo.tk / geo.ks;
      const int ch = cs * 4 / VEC, off = (cs * 4 % VEC) * (int)sizeof(T);
      for (int i = 0; i < per; ++i) {
        const int j = ksh + geo.ks * i;
        if (base + j < neff) {
          float vv[4];
          unpack4(reinterpret_cast<const T*>(st + geo.at(j, ch) + off), vv);
          const float* pr = sc + (base + j) * GB;
          float p[GB];
#pragma unroll
          for (int g = 0; g < GB; g += 2) {
            const float2 x = *reinterpret_cast<const float2*>(pr + g);
            p[g] = x.x;
            p[g + 1] = x.y;
          }
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p[g], vv[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: the shares meet there
#pragma unroll
  for (int g = 0; g < GB; ++g)
    if (g < G)
      *reinterpret_cast<float4*>(red + (ksh * G + g) * DP + cs * 4) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  __syncthreads();

  const long long row = (long long)b * Kh + kh;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int r = 0; r < geo.ks; ++r) a += red[(r * G + g) * DP + d];
    float m = NEG_INF, l = 0.f;
    if (nt > 0) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        m = fmaxf(m, wred[w * GB + g]);
        l += wred[(WARPS + w) * GB + g];
      }
    }
    if (nsplit == 1) {
      out[row * G * D + i] = from_f32<T>(a / fmaxf(l, 1e-30f));
    } else {
      float* pb = part + (row * nsplit + sp) * (G * D + 2 * G);
      pb[i] = a;
      if (d == 0) {
        pb[G * D + g] = m;
        pb[G * D + G + g] = l;
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

template <typename T, typename Q, int GB>
int launch_gb(const void* q, const void* kc, const void* vc,
              const void* valid, long long valid_b, void* out, void* part,
              int B, int Kh, int G, int D, int DP, int S, int split,
              int nsplit, float scale, long long q_b, long long q_h,
              const Strides& ks, const Strides& vs, int async16,
              int smem_bytes, cudaStream_t stream) {
  static bool ready[64] = {};   // the shared-memory opt-in, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, Q, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready[dev] = true;
  }
  dim3 grid(Kh, B, nsplit);
  decode_split_kernel<T, Q, GB><<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const unsigned char*>(valid),
      valid_b, static_cast<T*>(out), static_cast<float*>(part), Kh, G, D, DP,
      S, split, nsplit, scale, q_b, q_h, ks, vs, async16);
  int err = (int)cudaGetLastError();
  if (err || nsplit == 1) return err;
  dim3 grid2(Kh, B);
  decode_combine_kernel<T><<<grid2, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), Kh, G, D,
      nsplit);
  return (int)cudaGetLastError();
}

template <typename T, typename Q>
int launch(const void* q, const void* kc, const void* vc, const void* valid,
           long long valid_b, void* out, void* part, int B, int Kh, int G,
           int D, int DP, int S, int split, int nsplit, float scale,
           long long q_b, long long q_h, const long long* st, int async16,
           int smem_bytes, void* stream) {
  // DP: D padded to a power of two of at least 16 bytes, at most 256
  if (G < 1 || G > GROUPS_MAX || D < 1 || DP < D || DP > 256
      || (DP & (DP - 1)) || DP * (int)sizeof(T) < 16 || split < 1
      || nsplit < 1 || smem_bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Kh <= 0 || S <= 0) return (int)cudaGetLastError();
  const Strides ks{st[0], st[1], st[2]}, vs{st[3], st[4], st[5]};
  cudaStream_t s = (cudaStream_t)stream;
#define DECODE_LAUNCH(GB)                                                   \
  launch_gb<T, Q, GB>(q, kc, vc, valid, valid_b, out, part, B, Kh, G, D,   \
                      DP, S, split, nsplit, scale, q_b, q_h, ks, vs,       \
                      async16, smem_bytes, s)
  if (G <= 2) return DECODE_LAUNCH(2);
  if (G <= 4) return DECODE_LAUNCH(4);
  if (G <= 8) return DECODE_LAUNCH(8);
  return DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

}  // namespace

// q: (B, 1, H, D) float32 (or, for bf16 caches with q_bf16 set, bfloat16)
// with element strides q_b, q_h and unit stride along D; k/v caches
// float32 or bfloat16 with (b, s, k) element strides st[0:3] and st[3:6];
// valid: bytes, row b at valid + b * valid_b (valid_b = 0 shares one row),
// unit stride along Smax; out: (B, Kh, G, D) contiguous in the cache type;
// part: nsplit > 1 scratch of B·Kh·nsplit·(G·D + 2G) floats; DP: D padded
// as the wrapper pads it; async16: the cp.async route (else the element
// route); smem_bytes: the wrapper's `decode_smem`.
extern "C" int flash_decode_f32(const void* q, const void* kc, const void* vc,
                                const void* valid, long long valid_b,
                                void* out, void* part, int B, int Kh, int G,
                                int D, int DP, int S, int split, int nsplit,
                                float scale, long long q_b, long long q_h,
                                const long long* st, int async16,
                                int smem_bytes, void* stream) {
  return launch<float, float>(q, kc, vc, valid, valid_b, out, part, B, Kh, G,
                              D, DP, S, split, nsplit, scale, q_b, q_h, st,
                              async16, smem_bytes, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* kc,
                                 const void* vc, const void* valid,
                                 long long valid_b, void* out, void* part,
                                 int B, int Kh, int G, int D, int DP, int S,
                                 int split, int nsplit, float scale,
                                 long long q_b, long long q_h,
                                 const long long* st, int async16,
                                 int smem_bytes, int q_bf16, void* stream) {
  if (q_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, kc, vc, valid, valid_b, out, part, B, Kh, G, D, DP, S, split,
        nsplit, scale, q_b, q_h, st, async16, smem_bytes, stream);
  return launch<__nv_bfloat16, float>(q, kc, vc, valid, valid_b, out, part,
                                      B, Kh, G, D, DP, S, split, nsplit,
                                      scale, q_b, q_h, st, async16,
                                      smem_bytes, stream);
}
