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
// Every pairwise decay is exp of the masked difference W_{t-1} - W_j <= 0
// (the factored exp(W_{t-1})·exp(-W_j) overflows for w near the 1e-12
// clamp), taken with logf and expf: on the hardware's coarser exp2 and lg2
// the f32-policy parity cell (a fleet step against the monolithic one,
// both through this kernel) drifts past its moment bar.
// It runs the time mix of every RWKV forward, prefill and decode step of
// the port (`models.rwkv.wkv_chunked` -> `kernels.ops.wkv6`).
//
// What bounds it on an H100: at the training shape (B 8, S 128, 64 heads
// of 64, chunks of 32) ~1.5 GFLOP of IEEE f32 on the CUDA cores (67
// TFLOP/s: ~0.023 ms) against ~59 MB of r, k, v (bf16), w and y (f32)
// (~0.018 ms). Over a third of the instructions are the c(c-1)/2·hd
// pairwise exp of A, which no factoring may remove; the rest are the y product and
// the carry, whose operands come from shared memory.
//
// Design: one block of 256 threads per (head, batch); a bf16 block holds
// 49 KB of shared memory and 80 registers a thread, three blocks an SM.
// (Blocks owning 1/2 or 1/4 of a row's value columns compute A again
// each and lost at every shape timed: PERF.md.) The state stays in
// registers for the whole sequence: thread (d-block db, e-block eb) holds
// the 4 x 4 tile S[4 db .. 4 db + 4, 4 eb .. 4 eb + 4]. Per chunk:
//  - r, k, v and w arrive by 16-byte cp.async, issued under the previous
//    chunk's products; rows past the chunk and columns past hd are
//    zero-filled. v is turned to f32 once, freeing its staging buffer.
//  - W: a warp scan per 8 columns (a lane per step).
//  - A: thread (row pair p, 4 dims) takes rows p and 31 - p, 31 pairs
//    j < t in all (a triangular map with no idle lane); the 16 lanes of a
//    row pair add their partial sums with a transposing butterfly whose
//    slots are permuted by lane, so that no select is needed (one shuffle
//    per pair and stage, halving). The diagonal bonus r_t·(u ⊙ k_t) rides
//    along. rw = r ⊙ exp(W_{t-1}) and the carry's k ⊙ exp(W_{c-1} - W_j)
//    are formed once. Warps whose rows all lie past a short chunk skip
//    the pairs (S = 1 needs the diagonal only).
//  - y, four steps at a time: each thread's 4 x 4 tile of rw_t·S and its
//    two keys of A[t, :]·v (every rw and A word feeds 4 FMAs; the upper
//    key only where the step can see it), the 16 d-blocks meeting in a
//    transposing butterfly.
//  - the carry: S = S ⊙ exp(W_{c-1}) + Σ_j kdec_j v_jᵀ on the tile (every
//    kdec and v word feeds 4 FMAs).
// Three barriers a chunk. Operands are addressed through the strides of
// the (B, S, H, hd) layout (no transpose precedes the launch); operands
// whose bases or strides are not 16-byte multiples take the element route
// (the same pipeline, filled by ordinary loads). Chunks are at most 32
// steps: any S runs, the last chunk ragged (S = 1 for decode); shared
// memory never grows with S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // threads of a block
constexpr int MAXT = 32;          // steps per chunk
constexpr int MAXHD = 64;         // head dims the kernel is built for
constexpr int WP = MAXHD + 4;     // padded row of log w / W (bank spread)
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// 4 consecutive elements at p (8- or 16-byte aligned) as f32
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

// One stage of a transposing butterfly over lanes `o` apart, each holding
// N values: every lane sends its upper half and adds the partner's to its
// lower half. A lane whose slot x holds value x ^ (its lane bits) ends,
// after the stages o = N/2 .. 1, with value (its lane bits) summed over
// the lanes: no select is needed.
template <int N>
__device__ __forceinline__ void fold(float* a, int o) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x)
    a[x] += __shfl_xor_sync(FULL, a[x + N / 2], o);
}

// As fold, for values in slot order: the lane with `up` keeps the upper
// half (two selects per value).
template <int N>
__device__ __forceinline__ void halve(float* a, bool up, int o) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const float send = up ? a[x] : a[x + N / 2];
    const float keep = up ? a[x + N / 2] : a[x];
    a[x] = keep + __shfl_xor_sync(FULL, send, o);
  }
}

struct Strides {  // element strides of a (B, S, H, hd) view; hd is unit
  long long b, s, h;
};

template <typename T>
struct Smem {
  T r[MAXT * MAXHD];
  T k[MAXT * MAXHD];
  T v[MAXT * MAXHD];              // as staged
  float w[MAXT * WP];             // log w, then W (inclusive)
  float vf[MAXT * MAXHD];         // v in f32
  float rw[MAXT * MAXHD];         // r ⊙ exp(W_{t-1})
  float kd[MAXT * MAXHD];         // k ⊙ exp(W_{c-1} - W_j)
  float A[MAXT * MAXT];           // intra-chunk scores, zero above
  float dec[MAXHD];               // exp(W_{c-1})
  float u[MAXHD];
};

// rows x (RC 16-byte chunks) of a (rows, cols) tile: row t of src at
// src + t * src_ld, of dst at dst + t * dst_ld; rows from live_rows and
// columns from live_cols on are zero-filled
template <typename T, int RC>
__device__ __forceinline__ void copy_tile(T* dst, int dst_ld, const T* src,
                                          long long src_ld, int live_rows,
                                          int live_cols, int tid, int nt,
                                          bool async16) {
  constexpr int V = 16 / sizeof(T);
  for (int i = tid; i < MAXT * RC; i += nt) {
    const int t = i / RC, col = (i % RC) * V;
    T* d = dst + t * dst_ld + col;
    const T* s = src + t * src_ld + col;
    if (async16) {
      const bool live = t < live_rows && col < live_cols;
      cp_async16(d, live ? s : src, live);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = (t < live_rows && col + e < live_cols) ? s[e] : T(0.f);
    }
  }
}

// blocks of 256 threads an SM holds: three in bf16 (80 registers; four,
// at 64, spilled and measured slower), two in f32 (whose 61 KB of shared
// memory would allow three, but 80 registers spill there)
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 2 ? 3 : 2; }

template <typename T>
__global__ void __launch_bounds__(THREADS, min_blocks<T>())
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int H, int S,
            int hd, int tile, Strides rs, Strides ks, Strides vs, Strides ws,
            Strides ys, int async16) {
  constexpr int NT = THREADS;
  constexpr int RC = MAXHD * sizeof(T) / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the state tile of this thread: rows 4 db .. 4 db + 4, columns
  // 4 eb .. 4 eb + 4 (ec onward)
  const int db = lane & 15;
  const int eb = warp * 2 + (lane >> 4);
  const int ec = 4 * eb;
  const long long bh = (long long)b * H + h;
  const long long nst = (long long)hd * hd;

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = w + b * ws.b + h * ws.h;
  auto load_rkw = [&](int c0, int c) {
    copy_tile<T, RC>(sm.r, MAXHD, rb + c0 * rs.s, rs.s, c, hd, tid, NT,
                     async16);
    copy_tile<T, RC>(sm.k, MAXHD, kb + c0 * ks.s, ks.s, c, hd, tid, NT,
                     async16);
    copy_tile<float, MAXHD / 4>(sm.w, WP, wb + c0 * ws.s, ws.s, c, hd, tid,
                                NT, async16);
  };
  auto load_v = [&](int c0, int c) {
    copy_tile<T, RC>(sm.v, MAXHD, vb + c0 * vs.s, vs.s, c, hd, tid, NT,
                     async16);
  };

  if (S > 0) {
    load_rkw(0, min(tile, S));
    load_v(0, min(tile, S));
  }
  cp_async_commit();
  for (int i = tid; i < MAXHD; i += NT)
    sm.u[i] = i < hd ? u[(long long)h * hd + i] : 0.f;
  for (int i = tid; i < MAXT * MAXT; i += NT) sm.A[i] = 0.f;
  // rows of four state columns move as float4 where hd allows
  const bool vec4 = hd % 4 == 0
                    && ((reinterpret_cast<uintptr_t>(s0)
                         | reinterpret_cast<uintptr_t>(s_out)) & 15) == 0;
  float St[16];                             // St[4 i + x] = S[4 db + i][ec + x]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = 4 * db + i;
    const float* src = s0 + bh * nst + d * hd + ec;
    if (s0 && vec4 && d < hd && ec < hd) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      St[4 * i] = x.x; St[4 * i + 1] = x.y;
      St[4 * i + 2] = x.z; St[4 * i + 3] = x.w;
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        St[4 * i + x] = (s0 && d < hd && ec + x < hd) ? src[x] : 0.f;
    }
  }

  for (int c0 = 0; c0 < S; c0 += tile) {
    const int c = min(tile, S - c0);
    cp_async_wait_all();
    __syncthreads();   // this chunk is in; the last chunk's products done

    // v in f32 (its staging buffer is then free for the next chunk's)
    for (int i = tid; i < MAXT * MAXHD / 4; i += NT) {
      float x[4];
      load4(sm.v + 4 * i, x);
      *reinterpret_cast<float4*>(sm.vf + 4 * i) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    // W: inclusive sum over the steps of log w, a warp per 8 columns
    for (int cg = warp; cg < MAXHD / 8; cg += NT / 32) {
      float* row = sm.w + lane * WP + cg * 8;
      const float4 x0 = *reinterpret_cast<const float4*>(row);
      const float4 x1 = *reinterpret_cast<const float4*>(row + 4);
      float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = (lane < c && cg * 8 + i < hd) ? logf(fmaxf(x[i], 1e-12f))
                                             : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float up = __shfl_up_sync(FULL, x[i], o);
          if (lane >= o) x[i] += up;
        }
      }
      *reinterpret_cast<float4*>(row) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    // A below the diagonal and on it: thread (row pair p, dims 4g..4g+3)
    for (int it = tid; it < 16 * 16; it += NT) {
      const int p = it >> 4, g = it & 15, d0 = 4 * g;
      const int ta = p, tb = MAXT - 1 - p;
      float ra[4], rbv[4], wa[4], wbv[4], ka[4], kbv[4], uu[4];
      load4(sm.r + ta * MAXHD + d0, ra);
      load4(sm.r + tb * MAXHD + d0, rbv);
      load4(sm.k + ta * MAXHD + d0, ka);
      load4(sm.k + tb * MAXHD + d0, kbv);
      load4(sm.u + d0, uu);
      load4(sm.w + (tb - 1) * WP + d0, wbv);
      if (ta > 0) {
        load4(sm.w + (ta - 1) * WP + d0, wa);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) wa[x] = 0.f;
      }
      float diag_a = 0.f, diag_b = 0.f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        diag_a = fmaf(ra[x], uu[x] * ka[x], diag_a);
        diag_b = fmaf(rbv[x], uu[x] * kbv[x], diag_b);
      }
      // pair m: (ta, m) for m < ta, else (tb, m - ta); 31 in all. Slot x
      // of lane g holds pair 16 half + (x ^ g), so that the butterfly
      // leaves lane g pair 16 half + g. Rows past the chunk are skipped
      // where a whole warp has none before it.
      if (c > 1 && __any_sync(FULL, ta < c || tb < c)) {
        // four rounds of 8 pairs: slot x of lane g holds pair
        // 8 round + (x ^ g / 2); after three folds and a final sum lanes
        // g and g ^ 1 both hold pair 8 round + g / 2
#pragma unroll
        for (int round = 0; round < 4; ++round) {
          float a[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int m = round * 8 + (x ^ (g >> 1));
            float acc = 0.f;
            if (m < MAXT - 1) {
              const bool in_a = m < ta;
              const int j = in_a ? m : m - ta;
              float kj[4], wj[4];
              load4(sm.k + j * MAXHD + d0, kj);
              load4(sm.w + j * WP + d0, wj);
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc = fmaf((in_a ? ra[q] : rbv[q]) * kj[q],
                           expf((in_a ? wa[q] : wbv[q]) - wj[q]), acc);
            }
            a[x] = acc;
          }
          fold<8>(a, 8);
          fold<4>(a, 4);
          fold<2>(a, 2);
          a[0] += __shfl_xor_sync(FULL, a[0], 1);
          const int m = round * 8 + (g >> 1);
          if (m < MAXT - 1 && (g & 1) == 0) {
            const bool in_a = m < ta;
            sm.A[(in_a ? ta : tb) * MAXT + (in_a ? m : m - ta)] = a[0];
          }
        }
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1) {
        diag_a += __shfl_xor_sync(FULL, diag_a, o);
        diag_b += __shfl_xor_sync(FULL, diag_b, o);
      }
      if (g == 0) {
        sm.A[ta * MAXT + ta] = diag_a;
        sm.A[tb * MAXT + tb] = diag_b;
      }
    }
    // rw, the carry's decayed keys and the state's decay
    const float* wl = sm.w + (c - 1) * WP;
    for (int i = tid; i < c * (MAXHD / 4); i += NT) {
      const int t = i >> 4, d0 = (i & 15) * 4;
      float r4[4], k4[4], wt[4], wp[4], wc[4];
      load4(sm.r + t * MAXHD + d0, r4);
      load4(sm.k + t * MAXHD + d0, k4);
      load4(sm.w + t * WP + d0, wt);
      load4(wl + d0, wc);
      if (t > 0) {
        load4(sm.w + (t - 1) * WP + d0, wp);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) wp[x] = 0.f;
      }
      float4 o1, o2;
      o1.x = r4[0] * expf(wp[0]); o1.y = r4[1] * expf(wp[1]);
      o1.z = r4[2] * expf(wp[2]); o1.w = r4[3] * expf(wp[3]);
      o2.x = k4[0] * expf(wc[0] - wt[0]); o2.y = k4[1] * expf(wc[1] - wt[1]);
      o2.z = k4[2] * expf(wc[2] - wt[2]); o2.w = k4[3] * expf(wc[3] - wt[3]);
      *reinterpret_cast<float4*>(sm.rw + t * MAXHD + d0) = o1;
      *reinterpret_cast<float4*>(sm.kd + t * MAXHD + d0) = o2;
    }
    for (int i = tid; i < MAXHD; i += NT) sm.dec[i] = expf(wl[i]);
    __syncthreads();

    // the next chunk's copies, under this chunk's products
    const int cn = c0 + tile;
    if (cn < S) {
      load_rkw(cn, min(tile, S - cn));
      load_v(cn, min(tile, S - cn));
    }
    cp_async_commit();

    // y, four steps at a time: this thread's 4 x 4 tile of rw_t·S (each
    // rw word feeds 4 FMAs) and keys db, db + 16 of A[t, :]·v (each A word
    // feeds 4; key db + 16 only from step 16 on, A being zero above the
    // diagonal), then the 16 d-blocks meet in a transposing butterfly that
    // leaves lane db the step 4 tg + db / 4, column ec + db % 4. Slot
    // (tt, x) of lane db holds step 4 tg + (tt ^ db / 4), so the two step
    // stages need no select.
    const float* vt = sm.vf;
    float v0[4], v1[4];                     // v[db][ec ..], v[db + 16][ec ..]
    load4(vt + db * MAXHD + ec, v0);
    load4(vt + (db + 16) * MAXHD + ec, v1);
    const int ty = db >> 2, ey = ec + (db & 3);
#pragma unroll 2
    for (int tg = 0; tg < (c + 3) / 4; ++tg) {
      float p[16];                          // p[4 tt + x]
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int t = 4 * tg + (tt ^ ty);
        const float4 rv =
            *reinterpret_cast<const float4*>(sm.rw + t * MAXHD + 4 * db);
        const float a0 = sm.A[t * MAXT + db];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float acc = rv.x * St[x];
          acc = fmaf(rv.y, St[4 + x], acc);
          acc = fmaf(rv.z, St[8 + x], acc);
          acc = fmaf(rv.w, St[12 + x], acc);
          p[4 * tt + x] = fmaf(a0, v0[x], acc);
        }
        if (tg >= 4) {
          const float a1 = sm.A[t * MAXT + db + 16];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            p[4 * tt + x] = fmaf(a1, v1[x], p[4 * tt + x]);
        }
      }
      fold<16>(p, 8);
      fold<8>(p, 4);
      halve<4>(p, db & 2, 2);
      halve<2>(p, db & 1, 1);
      const int t = 4 * tg + ty;
      if (t < c && ey < hd)
        y[b * ys.b + (c0 + t) * ys.s + h * ys.h + ey] = p[0];
    }
    // the carry: S = S ⊙ exp(W_{c-1}) + Σ_j kdec_j v_jᵀ on the tile (each
    // kdec and v word feeds 4 FMAs)
    {
      const float4 dv = *reinterpret_cast<const float4*>(sm.dec + 4 * db);
      const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) St[i] *= dd[i / 4];
    }
    for (int j = 0; j < c; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(sm.kd + j * MAXHD + 4 * db);
      float vv[4];
      load4(vt + j * MAXHD + ec, vv);
      const float kk[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        St[i] = fmaf(kk[i / 4], vv[i % 4], St[i]);
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = 4 * db + i;
    float* dst = s_out + bh * nst + d * hd + ec;
    if (vec4 && d < hd && ec < hd) {
      *reinterpret_cast<float4*>(dst) = make_float4(
          St[4 * i], St[4 * i + 1], St[4 * i + 2], St[4 * i + 3]);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (d < hd && ec + x < hd) dst[x] = St[4 * i + x];
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B, int H,
           int S, int hd, int tile, const long long* st, int async16,
           void* stream) {
  if (hd < 1 || hd > MAXHD || tile < 1 || tile > MAXT)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  constexpr int smem = (int)sizeof(Smem<T>);
  static bool ready[64] = {};   // the shared-memory opt-in, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !ready[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready[dev] = true;
  }
  const Strides ss[5] = {{st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                         {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
                         {st[12], st[13], st[14]}};
  dim3 grid(H, B);
  wkv6_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), H, S, hd, tile,
      ss[0], ss[1], ss[2], ss[3], ss[4], async16);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v in float32 or bfloat16; w, u (contiguous (H, hd)), s0 (may be
// null: zero state; contiguous (B, H, hd, hd)), y and s_out in float32.
// st holds the (b, s, h) element strides of r, k, v, w and y, in that
// order; async16: the cp.async route (bases and strides of r, k, v and w
// 16-byte multiples).
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* y,
                        void* s_out, int B, int H, int S, int hd, int tile,
                        const long long* st, int async16, void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, s_out, B, H, S, hd, tile, st,
                       async16, stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* s_out, int B, int H, int S, int hd,
                         int tile, const long long* st, int async16,
                         void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, S, hd,
                               tile, st, async16, stream);
}
