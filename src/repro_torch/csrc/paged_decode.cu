// Paged single-token GQA decode for Hopper.
//
// Replaces the Pallas kernel `flash_decode_paged`
// (src/repro/kernels/decode_attention.py:97, body `_paged_kernel`): one
// decode token's attention reads the K/V page pools in place, steered by a
// per-request page table, with an online softmax in f32. It runs the
// serving path's paged-read check (`ServeSession._check_paged_read`), once
// a decode step on layer 0's pools.
//
// Roundings: per split of the token axis, those of the TPU kernel's page
// step. The query is scaled in f32, scores and sums are f32 on the CUDA
// cores, the split's un-normalised probabilities p = exp(s - m_split) are
// rounded to the pool's type before the p·V product, and the splits combine
// in split order with weights exp(m_i - max m); the output is
// acc / max(l, 1e-30) in the pool's type. A request of length 0 gives zeros.
//
// What bounds it on an H100: the K/V bytes of the tokens a request holds
// (each read once) over the memory rate; the arithmetic, 4·G·D per token
// and kv head, is far below the card's rate. The rate needs tens of KB of
// loads in flight on every SM, and the arithmetic has to hide under them.
//
// Design: the grid is (split, kv head, request); the splits
// (`paged_splits` in kernels/decode_attention.py) cut the token axis into
// multiples of 64 tokens, whatever the page size, about two blocks an SM.
// A block whose split starts at or past the request's length writes an
// empty partial and exits. A live block reads its split's slice of the page
// table into shared memory once: token t of the split is pool row
// pt[t / page]·page + t % page at kv head kh, D·esz contiguous bytes. One
// producer warp streams the split's K tiles and then its V tiles into a
// ring of STAGES 16 KB stages, with "full" and "empty" mbarriers: each
// page chunk of a tile is one TMA box of a 3-D tensor map over the pool
// (P·page rows, K heads, D), so a tile may span several pages or part of
// one (one `cp.async.bulk` copy a row instead ran 1.65x slower at the
// paged 32k cell, PERF.md). Eight consumer warps wait on
// "full", read the stage and release it through "empty": no block-wide
// barrier per tile. Each key row is scored once for all G query rows: QT
// lanes (at most 8) share a key, each taking 16-byte chunks of it, so the
// 8 lanes of a shared-memory phase read 128 contiguous bytes; the queries
// sit in shared memory laid out so that those lanes read consecutive
// words; the G partial dot products meet in log2(QT) shuffles. The split's
// scores wait in shared memory for its max (the warps' maxima meet at one
// consumer barrier); p is formed and rounded once, spread over all
// consumer threads, which also sum l; then each thread accumulates 4
// columns of p·V for all G rows over a share of the V tile's keys, and the
// shares are added through the ring's space at the end. With one split the
// block writes the output; with several it writes (acc, m, l) and a second
// kernel combines them in split order. Pools whose rows are not 16-byte
// multiples, are not 16-byte aligned, whose G or D exceed the fast route's,
// or whose boxes would not start on 128 bytes of shared memory take the
// element route: the same splits and roundings, from ordinary loads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CWARPS = 8;                  // consumer warps
constexpr int CTHREADS = 32 * CWARPS;      // consumer threads
constexpr int THREADS = CTHREADS + 32;     // and one producer warp
constexpr int GROUPS_MAX = 16;             // query rows per kv head (fast)
constexpr int D_MAX = 256;                 // head dim (fast)
constexpr int STAGES = 3;                  // the K/V ring's depth
constexpr int STAGE_BYTES = 16384;         // bytes a stage holds
constexpr int TILE_MAX = 128;              // rows a stage holds at most
constexpr int ELEM_THREADS = 256;          // threads of the element route
constexpr int SMEM_MAX = 232448;           // an H100 block's shared memory
constexpr float NEG_INF = -1e30f;
constexpr int ERR_TMAP = 10000;            // + the CUresult of the encode
constexpr int ERR_NO_ENCODE = 20000;       // no encoder in the CUDA driver

enum Route { ELEMENT = 0, TMA = 1 };

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

// the consumer warps' own barrier; the producer warp never joins it
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CTHREADS) : "memory");
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

// tokens [t0, t0 + n) of request b that split sp holds, n <= 0 for none
__device__ __forceinline__ int split_tokens(const int* lens, int b, int sp,
                                            int split, int maxp, int page) {
  const int len = min(lens[b], maxp * page);
  return min(split, len - sp * split);
}

// a split with no token: an empty partial, or zeros with one split
template <typename T>
__device__ void write_empty(T* out, float* part, long long row, int sp,
                            int nsplit, int G, int D) {
  if (nsplit == 1) {
    for (int i = threadIdx.x; i < G * D; i += blockDim.x)
      out[row * G * D + i] = from_f32<T>(0.f);
  } else {
    float* pb = part + (row * nsplit + sp) * (G * D + 2 * G);
    for (int i = threadIdx.x; i < G * D + 2 * G; i += blockDim.x)
      pb[i] = (i >= G * D && i < G * D + G) ? NEG_INF : 0.f;
  }
}

// the split's result for (row g, column d): the output, or a partial
template <typename T>
__device__ __forceinline__ void write_result(T* out, float* part,
                                             long long row, int sp,
                                             int nsplit, int G, int D,
                                             int i, float a, float m,
                                             float l) {
  if (nsplit == 1) {
    out[row * G * D + i] = from_f32<T>(a / fmaxf(l, 1e-30f));
  } else {
    const int g = i / D;
    float* pb = part + (row * nsplit + sp) * (G * D + 2 * G);
    pb[i] = a;
    if (i % D == 0) {
      pb[G * D + g] = m;
      pb[G * D + G + g] = l;
    }
  }
}

// The fast route's tile geometry, from the head dim and the element size.
struct Geo {
  int rowb;   // bytes of a K or V row (a multiple of 16)
  int cpr;    // 16-byte chunks per row
  int qt;     // lanes per key in the score phase (a power of two, <= 8)
  int cpt;    // chunks a lane scores per key
  int kpw;    // keys a warp scores at once
  int tk;     // rows a stage holds (a power of two)
  int nq;     // 4-column slices per row (p·V phase)
  int nks;    // key shares of the p·V phase
  __host__ __device__ Geo(int D, int esz) {
    rowb = D * esz;
    cpr = rowb / 16;
    qt = cpr & -cpr;
    if (qt > 8) qt = 8;
    cpt = cpr / qt;
    kpw = 32 / qt;
    int t = STAGE_BYTES / rowb;
    if (t > TILE_MAX) t = TILE_MAX;
    tk = 1;
    while (2 * tk <= t) tk *= 2;
    nq = D / 4;
    nks = CTHREADS / nq;
  }
};

template <typename T, int GB>
__global__ void __launch_bounds__(THREADS, GB <= 8 ? 2 : 1)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ pt,
                   const int* __restrict__ lens, T* __restrict__ out,
                   float* __restrict__ part, int Kh, int G, int D, int page,
                   int maxp, int split, int nsplit, float scale, int box,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV) {
  constexpr int VEC = 16 / sizeof(T);       // elements in 16 bytes
  constexpr int V4 = VEC / 4;               // float4s of q per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo geo(D, (int)sizeof(T));
  const int region = max(STAGES * STAGE_BYTES, CTHREADS * 16 * G);
  unsigned char* ring = smem;                        // STAGES stages
  float* red = reinterpret_cast<float*>(smem);       // (G, CTHREADS, 4), last
  float* sc = reinterpret_cast<float*>(smem + region);   // (split, GB)
  float4* qs4 = reinterpret_cast<float4*>(sc + split * GB);  // (GB, V4, cpr)
  float* wred = reinterpret_cast<float*>(qs4) + GB * D;  // (CWARPS, GB) max
  float* lred = wred + CWARPS * GB;                  // (CWARPS, GB) sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(lred + CWARPS * GB);
  int* pids = reinterpret_cast<int*>(bars + 2 * STAGES);   // split's pages

  const int sp = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const long long row = (long long)b * Kh + kh;
  const int n = split_tokens(lens, b, sp, split, maxp, page);
  if (n <= 0) {
    write_empty(out, part, row, sp, nsplit, G, D);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = sp * split;
  const int p0 = t0 / page;
  const int np = (t0 + n - 1) / page - p0 + 1;
  for (int i = tid; i < np; i += THREADS) pids[i] = pt[b * maxp + p0 + i];
  // the scaled queries, chunk-major so that a chunk's lanes read
  // consecutive words
  const float* qb = q + row * G * D;
  for (int i = tid; i < GB * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const int ch = d / VEC, w = d % VEC;
    reinterpret_cast<float*>(qs4)[(((g * V4 + w / 4) * geo.cpr) + ch) * 4 +
                                  w % 4] = g < G ? qb[g * D + d] * scale : 0.f;
  }
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * STAGES;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the only block-wide barrier

  const int nt = (n + geo.tk - 1) / geo.tk;   // tiles of K, then of V
  if (warp == CWARPS) {
    // producer: tile `it` of the stream, K tiles 0..nt-1, then V tiles
    const uint32_t ring0 = smem_u32(ring);
    for (int it = 0; it < 2 * nt; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
      const bool isv = it >= nt;
      const int base = (isv ? it - nt : it) * geo.tk;
      const int rows = min(geo.tk, n - base);
      const uint32_t dst = ring0 + s * STAGE_BYTES;
      const uint32_t bar = full0 + 8 * s;
      // boxes of `box` rows never cross a page: box divides the page and
      // the offset of every tile
      const int nb = (rows + box - 1) / box;
      if (lane == 0) mbar_expect_tx(bar, nb * box * geo.rowb);
      __syncwarp();
      for (int x = lane; x < nb; x += 32) {
        const int t = t0 + base + x * box;
        const int r = pids[t / page - p0] * page + t % page;
        tma_load_3d(dst + x * box * geo.rowb, isv ? &tmV : &tmK, bar, 0, kh,
                    r);
      }
    }
    return;
  }

  // consumers: the K tiles' scores, each key once for all GB rows
  const int c = lane & (geo.qt - 1), jw = lane / geo.qt;
  float wm[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) wm[g] = NEG_INF;
  for (int it = 0; it < nt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const unsigned char* st = ring + s * STAGE_BYTES;
    const int base = it * geo.tk;
    const int rows = min(geo.tk, n - base);
    for (int kg = warp; kg * geo.kpw < rows; kg += CWARPS) {
      const int j = kg * geo.kpw + jw;
      const bool live = j < rows;
      float sv[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) sv[g] = 0.f;
      if (live) {
        for (int i = 0; i < geo.cpt; ++i) {
          const int ch = c + geo.qt * i;
          float kf[VEC];
          unpack16(reinterpret_cast<const T*>(st + j * geo.rowb + ch * 16),
                   kf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
#pragma unroll
            for (int e = 0; e < V4; ++e) {
              const float4 qv = qs4[(g * V4 + e) * geo.cpr + ch];
              sv[g] = fmaf(qv.x, kf[4 * e], sv[g]);
              sv[g] = fmaf(qv.y, kf[4 * e + 1], sv[g]);
              sv[g] = fmaf(qv.z, kf[4 * e + 2], sv[g]);
              sv[g] = fmaf(qv.w, kf[4 * e + 3], sv[g]);
            }
          }
        }
      }
      for (int o = 1; o < geo.qt; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GB; ++g)
          sv[g] += __shfl_xor_sync(0xffffffffu, sv[g], o);
      }
      if (live) {
        float* srow = sc + (base + j) * GB;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          wm[g] = fmaxf(wm[g], sv[g]);
          if ((g & (geo.qt - 1)) == c) srow[g] = sv[g];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  // the split's max per row: the warps' maxima meet at one barrier
  for (int o = geo.qt; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      wm[g] = fmaxf(wm[g], __shfl_xor_sync(0xffffffffu, wm[g], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) wred[warp * GB + g] = wm[g];
  }
  consumer_sync();
  // p = exp(s - m) rounded to the pool's type, and the sums l of the
  // unrounded p: thread t takes row t % GB
  {
    const int gp = tid % GB;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) m = fmaxf(m, wred[w * GB + gp]);
    float l = 0.f;
    for (int e = tid; e < n * GB; e += CTHREADS) {
      const float p = gp < G ? expf(sc[e] - m) : 0.f;
      l += p;
      sc[e] = to_f32(from_f32<T>(p));
    }
    for (int o = GB; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane < GB) lred[warp * GB + lane] = l;
  }
  consumer_sync();

  // p·V over this thread's share of each V tile's keys, 4 columns
  const int qd = tid % geo.nq, ks = tid / geo.nq;
  float acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  for (int it = nt; it < 2 * nt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const unsigned char* st = ring + s * STAGE_BYTES;
    const int base = (it - nt) * geo.tk;
    const int rows = min(geo.tk, n - base);
    if (ks < geo.nks) {
      for (int j = ks; j < rows; j += geo.nks) {
        float vv[4];
        unpack4(reinterpret_cast<const T*>(st + j * geo.rowb) + qd * 4, vv);
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
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  consumer_sync();   // every tile is read: the shares meet in the ring
  if (ks < geo.nks) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(red + (g * CTHREADS + tid) * 4) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  consumer_sync();
  for (int i = tid; i < G * D; i += CTHREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int r = 0; r < geo.nks; ++r)
      a += red[(g * CTHREADS + r * geo.nq + d / 4) * 4 + d % 4];
    float m = NEG_INF, l = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      m = fmaxf(m, wred[w * GB + g]);
      l += lred[w * GB + g];
    }
    write_result(out, part, row, sp, nsplit, G, D, i, a, m, l);
  }
}

// The element route: the same splits and roundings for any G and D and any
// alignment, from ordinary loads. One warp scores a token for all G rows,
// one warp takes a row's max and sums, one thread a (row, column) of p·V.
template <typename T>
__global__ void __launch_bounds__(ELEM_THREADS)
paged_element_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ pt,
                     const int* __restrict__ lens, T* __restrict__ out,
                     float* __restrict__ part, int Kh, int G, int D,
                     int page, int maxp, int split, int nsplit,
                     float scale) {
  constexpr int W = ELEM_THREADS / 32;
  extern __shared__ __align__(16) float esm[];
  float* qs = esm;                  // (G, D) scaled queries
  float* sc = qs + G * D;           // (split, G) scores, then p
  float* mg = sc + split * G;       // (G,) the split's max
  float* lg = mg + G;               // (G,) the split's sums
  int* pids = reinterpret_cast<int*>(lg + G);

  const int sp = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const long long row = (long long)b * Kh + kh;
  const int n = split_tokens(lens, b, sp, split, maxp, page);
  if (n <= 0) {
    write_empty(out, part, row, sp, nsplit, G, D);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = sp * split;
  const int p0 = t0 / page;
  const int np = (t0 + n - 1) / page - p0 + 1;
  for (int i = tid; i < np; i += ELEM_THREADS)
    pids[i] = pt[b * maxp + p0 + i];
  for (int i = tid; i < G * D; i += ELEM_THREADS)
    qs[i] = q[row * G * D + i] * scale;
  __syncthreads();
  auto at = [&](int t) {   // element offset of token t's row at head kh
    const int tok = t0 + t;
    const long long r = (long long)pids[tok / page - p0] * page + tok % page;
    return (r * Kh + kh) * D;
  };
  for (int t = warp; t < n; t += W) {
    const T* kr = kp + at(t);
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(qs[g * D + d], to_f32(kr[d]), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc[t * G + g] = s;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += W) {
    float m = NEG_INF;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sc[t * G + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sc[t * G + g] - m);
      l += p;
      sc[t * G + g] = to_f32(from_f32<T>(p));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      mg[g] = m;
      lg[g] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += ELEM_THREADS) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int t = 0; t < n; ++t) a = fmaf(sc[t * G + g], to_f32(vp[at(t) + d]), a);
    write_result(out, part, row, sp, nsplit, G, D, i, a, mg[g], lg[g]);
  }
}

// the splits' partials combined in split order
template <typename T>
__global__ void __launch_bounds__(256)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int Kh, int G, int D, int nsplit) {
  const long long row = (long long)blockIdx.y * Kh + blockIdx.x;
  const int w = G * D + 2 * G;
  const float* pb = part + row * nsplit * w;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, through the runtime, so that
// the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qr);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &qr);
#endif
    if (e == cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A pool as a 3-d map (D, Kh, P·page rows), boxes of (D, 1, box) rows.
template <typename T>
int encode_pool(EncodeTiled enc, CUtensorMap* map, const void* pool, int D,
                int Kh, long long rows, int box) {
  const int esz = (int)sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Kh,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * esz,
                                 (cuuint64_t)Kh * D * esz};
  const cuuint32_t boxd[3] = {(cuuint32_t)D, 1, (cuuint32_t)box};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(pool), dims, strides, boxd, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP + (int)r;
}

int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// the opt-in above 48 KB of shared memory, once per device and kernel
template <typename K>
int allow_smem(K kernel, bool* ready) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && ready[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) ready[dev] = true;
  return 0;
}

template <typename T, int GB>
int launch_fast(dim3 grid, int smem, cudaStream_t stream, const float* q,
                const T* kp, const T* vp, const int* pt, const int* lens,
                T* out, float* part, int Kh, int G, int D, int page,
                int maxp, int split, int nsplit, float scale, int box,
                const CUtensorMap& tk, const CUtensorMap& tv) {
  static bool ready[64] = {};
  const int err = allow_smem(paged_split_kernel<T, GB>, ready);
  if (err) return err;
  paged_split_kernel<T, GB><<<grid, THREADS, smem, stream>>>(
      q, kp, vp, pt, lens, out, part, Kh, G, D, page, maxp, split, nsplit,
      scale, box, tk, tv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q_, const void* kp_, const void* vp_, const void* pt_,
           const void* lens_, void* out_, void* part_, int B, int Kh, int G,
           int D, int page, int maxp, int P, int split, int nsplit,
           float scale, int route, int smem, void* stream) {
  if (G < 1 || D < 1 || page < 1 || maxp < 0 || split < 1 || nsplit < 1
      || smem > SMEM_MAX || route < ELEMENT || route > TMA)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Kh <= 0) return (int)cudaGetLastError();
  const float* q = static_cast<const float*>(q_);
  const T* kp = static_cast<const T*>(kp_);
  const T* vp = static_cast<const T*>(vp_);
  const int* pt = static_cast<const int*>(pt_);
  const int* lens = static_cast<const int*>(lens_);
  T* out = static_cast<T*>(out_);
  float* part = static_cast<float*>(part_);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nsplit, Kh, B);
  int err = 0;
  if (route == ELEMENT) {
    static bool ready[64] = {};
    err = allow_smem(paged_element_kernel<T>, ready);
    if (err) return err;
    paged_element_kernel<T><<<grid, ELEM_THREADS, smem, st>>>(
        q, kp, vp, pt, lens, out, part, Kh, G, D, page, maxp, split, nsplit,
        scale);
    err = (int)cudaGetLastError();
  } else {
    const Geo geo(D, (int)sizeof(T));
    // boxes of `box` rows: a divisor of the page and of every tile's
    // offset, so that no box crosses a page; each starts on 128 bytes
    const int box = gcd_int(page, geo.tk < 64 ? geo.tk : 64);
    if (G > GROUPS_MAX || D > D_MAX || geo.rowb % 16
        || (box * geo.rowb) % 128)
      return (int)cudaErrorInvalidValue;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return ERR_NO_ENCODE;
    CUtensorMap tk, tv;
    const long long rows = (long long)P * page;
    err = encode_pool<T>(enc, &tk, kp, D, Kh, rows, box);
    if (err == 0) err = encode_pool<T>(enc, &tv, vp, D, Kh, rows, box);
    if (err) return err;
#define PAGED_LAUNCH(GB)                                                     \
  launch_fast<T, GB>(grid, smem, st, q, kp, vp, pt, lens, out, part, Kh, G, \
                     D, page, maxp, split, nsplit, scale, box, tk, tv)
    if (G <= 2) err = PAGED_LAUNCH(2);
    else if (G <= 4) err = PAGED_LAUNCH(4);
    else if (G <= 8) err = PAGED_LAUNCH(8);
    else err = PAGED_LAUNCH(16);
#undef PAGED_LAUNCH
  }
  if (err || nsplit == 1) return err;
  paged_combine_kernel<T><<<dim3(Kh, B), 256, 0, st>>>(part, out, Kh, G, D,
                                                       nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Kh, G, D) float32, contiguous; k/v pools: (P, page, Kh, D) float32
// or bfloat16, contiguous; pt: (B, maxp) int32 page ids; lens: (B,) int32;
// out: (B, Kh, G, D) in the pool type; part: nsplit > 1 scratch of
// B·Kh·nsplit·(G·D + 2G) floats; split, nsplit: the wrapper's
// `paged_splits`; route: 0 the element route, 1 the fast route (TMA);
// P: the pool's pages; smem: the wrapper's
// `paged_smem` (fast) or `paged_element_smem` (element).
extern "C" int paged_decode_f32(const void* q, const void* kp, const void* vp,
                                const void* pt, const void* lens, void* out,
                                void* part, int B, int Kh, int G, int D,
                                int page, int maxp, int P, int split,
                                int nsplit, float scale, int route, int smem,
                                void* stream) {
  return launch<float>(q, kp, vp, pt, lens, out, part, B, Kh, G, D, page,
                       maxp, P, split, nsplit, scale, route, smem, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const void* pt,
                                 const void* lens, void* out, void* part,
                                 int B, int Kh, int G, int D, int page,
                                 int maxp, int P, int split, int nsplit,
                                 float scale, int route, int smem,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, pt, lens, out, part, B, Kh, G, D,
                               page, maxp, P, split, nsplit, scale, route,
                               smem, stream);
}
