// Mamba-1 selective scan, backward: the gradient of `selective_scan`
// (selective_scan.cu) for training.
//
// Replaces: no TPU kernel.  The JAX package trains through a chunked
// `lax.associative_scan` (src/repro/models/mamba.py `mamba_forward`) and
// its Pallas scan (src/repro/kernels/selective_scan.py `_scan_kernel`) has
// no backward; the port's forward is this kernel's twin, and autograd
// cannot see through a ctypes launch, so the gradient is a kernel too.
//
// What it computes: for each batch row b and channel i, with A = -exp(a_log),
// e_t = exp(dt[t] * A) and the forward's states h_t (h_{-1} = h0 or 0), it
// walks back from g = dh_last (or 0); at each step t, in order:
//     g      += dy[t] * C[t]
//     dC[t]  += sum_i dy[t, i] h_t[i]
//     dB[t]  += sum_i g[i] dt[t, i] u[t, i]
//     du[t]   = dt[t] sum_s g B[t] + D dy[t]
//     ddt[t]  = sum_s g (A e_t h_{t-1} + u[t] B[t])
//     dA     += g dt[t] e_t h_{t-1}          dD += dy[t] u[t]
//     g       = e_t g
// and what is left in g is dh0; da_log = dA * A.  Everything in fp32
// whatever the type of u; du is written in u's type (bf16 rounded to
// nearest even from its fp32 sum), as autograd wants it.
//
// Bound on the H100: the bytes of u, dt, dy, du and ddt read or written
// once (B, C and their gradients are di times smaller), about level with
// one exponential a (b, t, i, s) on the special-function units (16 a clock
// per SM).  Scratch traffic (the stored states, the partials) is this
// design's cost and is not in the bound.
//
// Design.  Both recurrences are linear with the coefficient e_t, h_t = e_t
// h_{t-1} + x_t and g_{t-1} = e_t (g_t + dy_t C_t), so the sequence is cut
// into segments that run in parallel (`bwd_plan` in selective_scan.py: the
// length a function of (B, S, di, ds) alone, one segment where the batch
// rows and channel blocks fill the card):
//   * the sweep (grid: 64-channel blocks x segments x batch rows; two
//     lanes a channel, eight states a lane) runs each segment forward from
//     zero (the first from h0) and stores the state at the start of every
//     kChunk = 8 steps (`hck`), with, past the first segment, the product
//     of the e's since the segment's start (`qck`); at a segment's end its
//     transfer P (the product of its e's, the same ex2 products the walk
//     uses), its end state and its zero-start adjoint sum_t dy_t C_t
//     prod_{tau <= t} e_tau (`summ`);
//   * the carry (one thread a (b, i, s), segments in order) gives each
//     segment its true start state (forward) and incoming adjoint
//     (backward): h <- P h + h_end, g <- P g + g_zero;
//   * the walk (grid: 64-channel blocks x segments x batch rows, 256
//     threads; four lanes a channel, four states a lane) takes its
//     segment's chunks last to first: from the chunk's start state (hck,
//     plus qck times the carried start) it recomputes the chunk's e's and
//     states into shared memory (each thread its own rows: no barrier, no
//     registers held for the history), then walks them back.  So each
//     exponential is computed twice, once in the sweep and once in the
//     walk.  128 registers, 87 KB of shared memory: two blocks, 16 warps
//     an SM;
//   * inputs reach shared memory by cp.async: rings of three 16-step
//     stages in the sweep, two chunks in the walk, the next chunk's copies
//     in flight while this one is walked;
//   * sums over the states close among a channel's four lanes, du's and
//     ddt's (sum_s g (A e h_{t-1} + u B) = sum_s (g e h_{t-1}) A + u sum_s
//     g B) in one reduce-scatter of two shuffles.  Sums over the channels
//     (dB, dC) close in three steps: a reduce-scatter over the warp's 8
//     channels, the block's 8 warps added in order in shared memory, and
//     one partial a 64-channel block that the last kernel adds over the
//     blocks in order.  dA and dD are written a (batch row, segment) each
//     and added over them in order there.  No float atomics: the same
//     inputs give the same bits every run.
// Trials on the card: 16-step chunks (two blocks of 128 threads an SM),
// the chunk's history in registers, dB and dC summed from the history
// after the walk, two channels a thread (64 per 128 threads), 4-step
// chunks with more blocks, and recomputing e in the walk back in place of
// its history were each as fast or slower: the walk's instruction issue
// (its arithmetic and the shuffles of the sums), not the exponentials or
// the bytes, sets the time.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxState = 16;   // ds a channel at most
constexpr int kChunk = 8;       // steps a chunk of the walk (BWD_CHUNK)
constexpr float kLog2e = 1.4426950408889634f;
// the sweep: two lanes a channel, eight states a lane (as the forward)
constexpr int kSweepLanes = 2;
constexpr int kSweepStates = kMaxState / kSweepLanes;
constexpr int kSweepChannels = kThreads / kSweepLanes;   // 64
constexpr int kStage = 16;      // steps a stage of the sweep's ring
constexpr int kStages = 3;
// the walk: four lanes a channel, four states a lane, 256 threads
constexpr int kWalkThreads = 256;
constexpr int kLanes = 4;
constexpr int kStates = kMaxState / kLanes;
constexpr int kChannels = kWalkThreads / kLanes;   // 64 (BWD_CHANNELS)
constexpr int kWarps = kWalkThreads / 32;
constexpr int kCarryThreads = 256;
constexpr int kReduceThreads = 256;
static_assert(kStage % kChunk == 0, "a stage holds whole chunks");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// u as loaded (raw), its value in fp32, and an fp32 value rounded to it
template <typename U> struct Raw;
template <> struct Raw<float> {
  using T = float;
  static __device__ __forceinline__ float f(T x) { return x; }
  static __device__ __forceinline__ T to(float x) { return x; }
};
template <> struct Raw<__nv_bfloat16> {
  using T = unsigned short;
  static __device__ __forceinline__ float f(T x) {
    return __uint_as_float((uint32_t)x << 16);
  }
  static __device__ __forceinline__ T to(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// Rows [0, n) x columns [0, CH) of a [rows, stride] array at src into dst
// [.][CH]: 16-byte cp.async pieces when `vec` (width == CH, src and stride
// 16-byte aligned), else plain loads and stores with zeros past `width`
// (visible after the next barrier), so that channels past di add nothing.
template <int CH, int NT, typename E>
__device__ __forceinline__ void tile_async(E* dst, const E* src,
                                           long long stride, int n,
                                           int width, bool vec) {
  constexpr int kPer = 16 / sizeof(E);
  if (vec) {
    constexpr int kPieces = CH / kPer;
    for (int k = threadIdx.x; k < n * kPieces; k += NT) {
      const int r = k / kPieces, q = (k % kPieces) * kPer;
      cp_async16(dst + r * CH + q, src + r * stride + q);
    }
  } else {
    for (int k = threadIdx.x; k < n * CH; k += NT) {
      const int r = k / CH, q = k % CH;
      dst[r * CH + q] = q < width ? src[r * stride + q] : E(0);
    }
  }
}

// Rows [0, n) of B or C ([rows, ds]) into dst [.][kMaxState] by 4-byte
// cp.async; states past ds are left as they are (zeros).
template <int NT>
__device__ __forceinline__ void states_async(float* dst, const float* src,
                                             int n, int ds) {
  for (int k = threadIdx.x; k < n * kMaxState; k += NT) {
    const int r = k / kMaxState, s = k % kMaxState;
    if (s < ds) cp_async4(dst + r * kMaxState + s, src + r * ds + s);
  }
}

// [B, X, di, kMaxState] scratch: the kMaxState states of (b, x, i)
__device__ __forceinline__ long long states_at(int b, int x, int nx, int i,
                                               int di) {
  return (((long long)b * nx + x) * di + i) * kMaxState;
}

// ---- the sweep ------------------------------------------------------------

template <typename U>
__global__ void __launch_bounds__(kThreads, 4)
ssb_sweep_kernel(const typename Raw<U>::T* __restrict__ u,
                 const float* __restrict__ dt, const float* __restrict__ bm,
                 const float* __restrict__ cm,
                 const float* __restrict__ a_log,
                 const float* __restrict__ h0, const float* __restrict__ dy,
                 float* __restrict__ hck, float* __restrict__ qck,
                 float* __restrict__ summ, int seq, int di, int ds,
                 int seg_len, int n_seg, int n_chunks, int u_vec, int f_vec) {
  using R = typename Raw<U>::T;
  constexpr int P = kSweepLanes, NS = kSweepStates, CH = kSweepChannels;
  __shared__ __align__(16) R s_u[kStages][kStage][CH];
  __shared__ __align__(16) float s_dt[kStages][kStage][CH];
  __shared__ __align__(16) float s_dy[kStages][kStage][CH];
  __shared__ __align__(16) float s_b[kStages][kStage][kMaxState];
  __shared__ __align__(16) float s_c[kStages][kStage][kMaxState];
  const int seg = blockIdx.y, b = blockIdx.z;
  // segments after the first start from zero and carry their transfer and
  // zero-start adjoint, for which they also read dy and C
  const bool track = seg > 0;
  const int p = threadIdx.x % P;
  const int ci = threadIdx.x / P;
  const int c0 = blockIdx.x * CH;
  const int i = c0 + ci;
  const bool live = i < di;
  const int s0 = p * NS;
  const int t_begin = seg * seg_len;
  const int steps = max(0, min(seg_len, seq - t_begin));
  const long long row0 = (long long)b * seq + t_begin;
  const int width = min(CH, di - c0);

  if (ds < kMaxState) {
    for (int k = threadIdx.x; k < kStages * kStage * kMaxState;
         k += kThreads) {
      (&s_b[0][0][0])[k] = 0.f;
      (&s_c[0][0][0])[k] = 0.f;
    }
  }
  // stage k of the segment (steps k * kStage ...) into ring slot k % 3;
  // one commit group a stage (empty past the end)
  auto issue = [&](int k) {
    const int t0 = k * kStage;
    if (t0 < steps) {
      const int n = min(kStage, steps - t0), st = k % kStages;
      const long long off = (row0 + t0) * di + c0;
      tile_async<CH, kThreads>(&s_u[st][0][0], u + off, di, n, width,
                               u_vec && width == CH);
      tile_async<CH, kThreads>(&s_dt[st][0][0], dt + off, di, n, width,
                               f_vec && width == CH);
      states_async<kThreads>(&s_b[st][0][0], bm + (row0 + t0) * ds, n, ds);
      if (track) {
        tile_async<CH, kThreads>(&s_dy[st][0][0], dy + off, di, n, width,
                                 f_vec && width == CH);
        states_async<kThreads>(&s_c[st][0][0], cm + (row0 + t0) * ds, n,
                               ds);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float a2[NS], h[NS], q[NS], gz[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int s = s0 + k;
    const bool on = live && s < ds;
    a2[k] = on ? -expf(a_log[(long long)i * ds + s]) * kLog2e : 0.f;
    h[k] = on && !track && h0 != nullptr
               ? h0[((long long)b * di + i) * ds + s] : 0.f;
    q[k] = 1.f;
    gz[k] = 0.f;
  }
  auto store = [&](float* base, int x, const float (&v)[NS]) {
    float4* dst = reinterpret_cast<float4*>(
        base + states_at(b, x, n_chunks, i, di) + s0);
#pragma unroll
    for (int k = 0; k < NS / 4; ++k)
      dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                           v[4 * k + 3]);
  };

  const int n_stages = (steps + kStage - 1) / kStage;
  for (int k = 0; k < n_stages; ++k) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage k
    __syncthreads();                // everyone's; stage k - 1 is consumed
    issue(k + kStages - 1);
    const int st = k % kStages, t0 = k * kStage;
    const int n = min(kStage, steps - t0);   // the same for the block
    // `full` and `trk` are compile-time flags: a full stage is one basic
    // block, and the first segment carries nothing
    auto walk = [&](auto full_stage, auto tracking) {
      constexpr bool full = decltype(full_stage)::value;
      constexpr bool trk = decltype(tracking)::value;
#pragma unroll
      for (int t = 0; t < kStage; ++t) {
        if (full || t < n) {
          if (t % kChunk == 0 && live) {
            const int x = (t_begin + t0 + t) / kChunk;
            store(hck, x, h);
            if (trk) store(qck, x, q);
          }
          const float dd = s_dt[st][t][ci];
          const float x = dd * Raw<U>::f(s_u[st][t][ci]);
          const float yy = trk ? s_dy[st][t][ci] : 0.f;
#pragma unroll
          for (int m = 0; m < NS; m += 4) {
            const float4 bv =
                *reinterpret_cast<const float4*>(&s_b[st][t][s0 + m]);
            const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
            float cc[4] = {0.f, 0.f, 0.f, 0.f};
            if (trk) {
              const float4 cv =
                  *reinterpret_cast<const float4*>(&s_c[st][t][s0 + m]);
              cc[0] = cv.x; cc[1] = cv.y; cc[2] = cv.z; cc[3] = cv.w;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float e = ex2(dd * a2[m + r]);
              h[m + r] = fmaf(e, h[m + r], x * bb[r]);
              if (trk) {
                q[m + r] *= e;
                gz[m + r] = fmaf(yy * cc[r], q[m + r], gz[m + r]);
              }
            }
          }
        }
      }
    };
    if (track) {
      if (n == kStage)
        walk(std::true_type{}, std::true_type{});
      else
        walk(std::false_type{}, std::true_type{});
    } else {
      if (n == kStage)
        walk(std::true_type{}, std::false_type{});
      else
        walk(std::false_type{}, std::false_type{});
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (n_seg > 1 && live) {
    // summ [B, n_seg, 3, di, 16]: transfer, end state, zero-start adjoint
    auto put = [&](int w, const float (&v)[NS]) {
      float4* dst = reinterpret_cast<float4*>(
          summ + states_at(b, seg * 3 + w, n_seg * 3, i, di) + s0);
#pragma unroll
      for (int k = 0; k < NS / 4; ++k)
        dst[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                             v[4 * k + 3]);
    };
    put(0, q);
    put(1, h);
    put(2, gz);
  }
}

// ---- the carry ------------------------------------------------------------

// One thread a (b, i, s), the segments in order: carry [B, n_seg, 2, di,
// 16] gets each segment's true start state (w = 0; segment 0's is h0 and
// is not read) and incoming adjoint (w = 1; the last's is dh_last or 0).
__global__ void __launch_bounds__(kCarryThreads)
ssb_carry_kernel(const float* __restrict__ summ,
                 const float* __restrict__ dh_last,
                 float* __restrict__ carry, int bsz, int n_seg, int di,
                 int ds) {
  const long long idx = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (idx >= (long long)bsz * di * ds) return;
  const int s = (int)(idx % ds);
  const int i = (int)((idx / ds) % di);
  const int b = (int)(idx / ((long long)ds * di));
  auto sm = [&](int seg, int w) {
    return summ[((((long long)b * n_seg + seg) * 3 + w) * di + i) *
                    kMaxState + s];
  };
  auto cr = [&](int seg, int w) -> float& {
    return carry[((((long long)b * n_seg + seg) * 2 + w) * di + i) *
                     kMaxState + s];
  };
  float h = sm(0, 1);   // segment 0 ran from h0: its end state is true
  cr(1, 0) = h;
  for (int k = 1; k + 1 < n_seg; ++k) {
    h = fmaf(sm(k, 0), h, sm(k, 1));
    cr(k + 1, 0) = h;
  }
  float g = dh_last != nullptr ? dh_last[idx] : 0.f;
  cr(n_seg - 1, 1) = g;
  for (int k = n_seg - 1; k >= 1; --k) {
    g = fmaf(sm(k, 0), g, sm(k, 2));
    cr(k - 1, 1) = g;
  }
}

// ---- the walk -------------------------------------------------------------

template <typename U>
struct WalkSmem {
  using R = typename Raw<U>::T;
  float4 he[kChunk][kWalkThreads];   // e_t, each thread's own four states
  float4 hh[kChunk][kWalkThreads];   // h_t
  R u[2][kChunk][kChannels];
  float dt[2][kChunk][kChannels];
  float dy[2][kChunk][kChannels];
  float b[2][kChunk][kMaxState];
  float c[2][kChunk][kMaxState];
  float red[kWarps][kChunk][32];   // a warp's dB and dC partials a step
  float ddt[kChunk][kChannels];
  R du[kChunk][kChannels];
};

template <typename U>
__global__ void __launch_bounds__(kWalkThreads, 2)
ssb_walk_kernel(const typename Raw<U>::T* __restrict__ u,
                const float* __restrict__ dt, const float* __restrict__ bm,
                const float* __restrict__ cm,
                const float* __restrict__ a_log,
                const float* __restrict__ d_skip,
                const float* __restrict__ dy,
                const float* __restrict__ dh_last,
                const float* __restrict__ hck, const float* __restrict__ qck,
                const float* __restrict__ carry,
                typename Raw<U>::T* __restrict__ du,
                float* __restrict__ ddt, float* __restrict__ part,
                float* __restrict__ da_part, float* __restrict__ dd_part,
                float* __restrict__ dh0, int seq, int di, int ds,
                int seg_len, int n_seg, int n_chunks, int u_vec,
                int f_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkSmem<U>& s = *reinterpret_cast<WalkSmem<U>*>(smem_raw);
  constexpr int NT = kWalkThreads;
  const int seg = blockIdx.y, b = blockIdx.z, bsz = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = tid % kLanes;
  const int ci = tid / kLanes;
  const int c0 = blockIdx.x * kChannels;
  const int i = c0 + ci;
  const bool live = i < di;
  const int s0 = p * kStates;
  const int t_begin = seg * seg_len;
  const int t_end = min(seq, t_begin + seg_len);
  const int ch_first = t_begin / kChunk;
  const int ch_last = (t_end + kChunk - 1) / kChunk - 1;   // < first: none
  const long long row0 = (long long)b * seq;
  const long long state = ((long long)b * di + i) * ds;
  const int width = min(kChannels, di - c0);

  if (ds < kMaxState) {
    for (int k = tid; k < 2 * kChunk * kMaxState; k += NT) {
      (&s.b[0][0][0])[k] = 0.f;
      (&s.c[0][0][0])[k] = 0.f;
    }
  }
  // chunk ch into stage st; one commit group a call (empty for ch < first)
  auto issue = [&](int ch, int st) {
    if (ch >= ch_first) {
      const int t0 = ch * kChunk, n = min(kChunk, t_end - t0);
      const long long off = (row0 + t0) * di + c0;
      tile_async<kChannels, NT>(&s.u[st][0][0], u + off, di, n, width,
                                u_vec && width == kChannels);
      tile_async<kChannels, NT>(&s.dt[st][0][0], dt + off, di, n, width,
                                f_vec && width == kChannels);
      tile_async<kChannels, NT>(&s.dy[st][0][0], dy + off, di, n, width,
                                f_vec && width == kChannels);
      states_async<NT>(&s.b[st][0][0], bm + (row0 + t0) * ds, n, ds);
      states_async<NT>(&s.c[st][0][0], cm + (row0 + t0) * ds, n, ds);
    }
    cp_async_commit();
  };

  float a[kStates], a2[kStates], g[kStates], hseg[kStates], dA[kStates];
  const long long own = states_at(b, seg * 2, n_seg * 2, i, di);
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int st = s0 + k;
    const bool on = live && st < ds;
    a[k] = on ? -expf(a_log[(long long)i * ds + st]) : 0.f;
    a2[k] = a[k] * kLog2e;
    // carry [B, n_seg, 2, di, 16]: (b, seg, 0) at own, (b, seg, 1) one
    // di * 16 further
    if (n_seg == 1)
      g[k] = on && dh_last != nullptr ? dh_last[state + st] : 0.f;
    else
      g[k] = on ? carry[own + (long long)di * kMaxState + st] : 0.f;
    hseg[k] = on && seg > 0 ? carry[own + st] : 0.f;
    dA[k] = 0.f;
  }
  const float dskip = live ? d_skip[i] : 0.f;
  float dD = 0.f;
  // the true state at chunk ch's start: the sweep's, plus its transfer
  // times the carried start past the first segment
  auto chunk_start = [&](int ch, float (&hs)[kStates]) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) hs[k] = 0.f;
    if (live && ch >= ch_first) {
      const long long at = states_at(b, ch, n_chunks, i, di) + s0;
      const float4 hv = *reinterpret_cast<const float4*>(hck + at);
      hs[0] = hv.x; hs[1] = hv.y; hs[2] = hv.z; hs[3] = hv.w;
      if (seg > 0) {
        const float4 qv = *reinterpret_cast<const float4*>(qck + at);
        hs[0] = fmaf(qv.x, hseg[0], hs[0]);
        hs[1] = fmaf(qv.y, hseg[1], hs[1]);
        hs[2] = fmaf(qv.z, hseg[2], hs[2]);
        hs[3] = fmaf(qv.w, hseg[3], hs[3]);
      }
    }
  };

  issue(ch_last, 0);
  float hs_next[kStates];
  chunk_start(ch_last, hs_next);
  for (int ch = ch_last, st = 0; ch >= ch_first; --ch, st ^= 1) {
    issue(ch - 1, st ^ 1);   // the previous chunk's copies in flight
    float hs[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) hs[k] = hs_next[k];
    chunk_start(ch - 1, hs_next);
    cp_async_wait<1>();   // this thread's copies of chunk ch landed
    __syncthreads();      // everyone's; the last chunk's output is out
    const int t0 = ch * kChunk;
    const int n = min(kChunk, t_end - t0);   // the same for the block
    auto walk = [&](auto full_chunk) {
      constexpr bool full = decltype(full_chunk)::value;
      // the chunk's e's and states into this thread's rows of he, hh
      float h[kStates];
#pragma unroll
      for (int k = 0; k < kStates; ++k) h[k] = hs[k];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        if (full || t < n) {
          const float dd = s.dt[st][t][ci];
          const float x = dd * Raw<U>::f(s.u[st][t][ci]);
          const float4 bv = *reinterpret_cast<const float4*>(&s.b[st][t][s0]);
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
          float e[kStates];
#pragma unroll
          for (int k = 0; k < kStates; ++k) {
            e[k] = ex2(dd * a2[k]);
            h[k] = fmaf(e[k], h[k], x * bb[k]);
          }
          s.he[t][tid] = make_float4(e[0], e[1], e[2], e[3]);
          s.hh[t][tid] = make_float4(h[0], h[1], h[2], h[3]);
        }
      }
      // back over them: hc is h_t, hp h_{t-1}
      float hc[kStates];
#pragma unroll
      for (int k = 0; k < kStates; ++k) hc[k] = h[k];
#pragma unroll
      for (int t = kChunk - 1; t >= 0; --t) {
        if (full || t < n) {
          const float dd = s.dt[st][t][ci], yy = s.dy[st][t][ci];
          const float uu = Raw<U>::f(s.u[st][t][ci]);
          const float x = dd * uu;
          const float4 bv = *reinterpret_cast<const float4*>(&s.b[st][t][s0]);
          const float4 cv = *reinterpret_cast<const float4*>(&s.c[st][t][s0]);
          const float4 ev = s.he[t][tid];
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
          const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
          const float e[4] = {ev.x, ev.y, ev.z, ev.w};
          float hp[kStates];
          if (t > 0) {
            const float4 hv = s.hh[t - 1][tid];
            hp[0] = hv.x; hp[1] = hv.y; hp[2] = hv.z; hp[3] = hv.w;
          } else {
#pragma unroll
            for (int k = 0; k < kStates; ++k) hp[k] = hs[k];
          }
          // sum_s g (A e h_{t-1} + u B) = sum_s (g e h_{t-1}) A + u sum_s g B
          float sdu = 0.f, sa = 0.f, v[2 * kStates];
#pragma unroll
          for (int k = 0; k < kStates; ++k) {
            const float eh = e[k] * hp[k];
            g[k] = fmaf(yy, cc[k], g[k]);
            v[k] = g[k] * x;               // dB
            v[kStates + k] = yy * hc[k];   // dC
            sdu = fmaf(g[k], bb[k], sdu);
            const float ge = g[k] * eh;
            sa = fmaf(a[k], ge, sa);
            dA[k] = fmaf(dd, ge, dA[k]);
            g[k] *= e[k];
            hc[k] = hp[k];
          }
          // over the channel's four lanes, a reduce-scatter: the even
          // lanes end with sum_s g B, the odd ones with the ddt sum
          const bool odd = p & 1;
          const float sddt = fmaf(uu, sdu, sa);
          float mine = odd ? sddt : sdu;
          mine += __shfl_xor_sync(0xffffffffu, odd ? sdu : sddt, 1);
          mine += __shfl_xor_sync(0xffffffffu, mine, 2);
          if (p == 0) s.du[t][ci] = Raw<U>::to(fmaf(dd, mine, dskip * yy));
          if (p == 1) s.ddt[t][ci] = mine;
          dD = fmaf(yy, uu, dD);
          // over the warp's 8 channels (lane bits 2-4), a reduce-scatter:
          // each step keeps half of the values and adds the partner's
          // half, so lane L ends with value L >> 2 of its lane group L & 3
#pragma unroll
          for (int half = kStates, o = 16; half >= 1; half >>= 1, o >>= 1) {
            const bool upper = lane & o;
#pragma unroll
            for (int m = 0; m < half; ++m) {
              const float send = upper ? v[m] : v[m + half];
              const float keep = upper ? v[m + half] : v[m];
              v[m] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
          }
          s.red[warp][t][lane] = v[0];
        }
      }
    };
    if (n == kChunk)
      walk(std::true_type{});
    else
      walk(std::false_type{});
    __syncthreads();
    for (int k = tid; k < kChunk * kChannels; k += NT) {
      const int r = k / kChannels, q = k % kChannels;
      if (r < n && q < width) {
        const long long off = (row0 + t0 + r) * di + c0 + q;
        du[off] = s.du[r][q];
        ddt[off] = s.ddt[r][q];
      }
    }
    // the block's partial dB and dC: its warps added in order
    for (int k = tid; k < kChunk * 32; k += NT) {
      const int r = k / 32, l = k % 32;
      const int kind = l >> 4;                          // 0 dB, 1 dC
      const int sx = (l & 3) * kStates + ((l >> 2) & 3);
      if (r < n && sx < ds) {
        float acc = s.red[0][r][l];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += s.red[w][r][l];
        part[((((long long)blockIdx.x * bsz + b) * seq + t0 + r) * 2 +
              kind) * ds + sx] = acc;
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (live) {
    const long long row = ((long long)b * n_seg + seg) * di + i;
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      if (s0 + k < ds) {
        da_part[row * ds + s0 + k] = dA[k];
        if (seg == 0 && dh0 != nullptr) dh0[state + s0 + k] = g[k];
      }
    }
    if (p == 0) dd_part[row] = dD;
  }
}

// ---- the ordered sums -----------------------------------------------------

// dB and dC over the blocks' partials, dA (times A) and dD over the (batch
// row, segment) pairs, each in index order.
__global__ void __launch_bounds__(kReduceThreads)
ssb_reduce_kernel(const float* __restrict__ part, int blocks, long long rows,
                  float* __restrict__ db, float* __restrict__ dc,
                  const float* __restrict__ da_part,
                  const float* __restrict__ a_log,
                  float* __restrict__ da_log,
                  const float* __restrict__ dd_part,
                  float* __restrict__ dd_skip, int pairs, int di, int ds) {
  long long idx = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  const long long n_bc = rows * 2 * ds, n_a = (long long)di * ds;
  if (idx < n_bc) {
    float acc = 0.f;
    for (int x = 0; x < blocks; ++x) acc += part[(long long)x * n_bc + idx];
    const long long row = idx / (2 * ds);
    const int rem = (int)(idx % (2 * ds));
    (rem < ds ? db : dc)[row * ds + rem % ds] = acc;
    return;
  }
  idx -= n_bc;
  if (idx < n_a) {
    float acc = 0.f;
    for (int x = 0; x < pairs; ++x) acc += da_part[(long long)x * n_a + idx];
    da_log[idx] = acc * -expf(a_log[idx]);
    return;
  }
  idx -= n_a;
  if (idx < di) {
    float acc = 0.f;
    for (int x = 0; x < pairs; ++x) acc += dd_part[(long long)x * di + idx];
    dd_skip[idx] = acc;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename U>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a_log, const void* d_skip, const void* h0,
           const void* dy, const void* dh_last, void* du, void* ddt, void* db,
           void* dc, void* da_log, void* dd_skip, void* dh0, void* hck,
           void* qck, void* summ, void* carry, void* part, void* da_part,
           void* dd_part, int bsz, int seq, int di, int ds, int seg_len,
           cudaStream_t stream) {
  using R = typename Raw<U>::T;
  const int n_seg = seq > 0 ? (seq + seg_len - 1) / seg_len : 1;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  if (n_seg > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte pieces need 16-byte aligned rows: the base and di * size
  const int u_vec = aligned16(u) && (di * (int)sizeof(R)) % 16 == 0;
  const int f_vec = aligned16(dt) && aligned16(dy) && di % 4 == 0;
  const int walk_smem = (int)sizeof(WalkSmem<U>);
  static bool configured = false;   // per instantiation
  if (!configured) {
    cudaFuncSetAttribute(ssb_walk_kernel<U>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         walk_smem);
    cudaFuncSetAttribute(ssb_walk_kernel<U>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(ssb_sweep_kernel<U>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    configured = true;
  }
  ssb_sweep_kernel<U><<<dim3((unsigned)((di + kSweepChannels - 1) /
                                        kSweepChannels),
                             (unsigned)n_seg, (unsigned)bsz),
                        kThreads, 0, stream>>>(
      static_cast<const R*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a_log), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<float*>(hck),
      static_cast<float*>(qck), static_cast<float*>(summ), seq, di, ds,
      seg_len, n_seg, n_chunks, u_vec, f_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_seg > 1) {
    const long long n = (long long)bsz * di * ds;
    ssb_carry_kernel<<<(unsigned)((n + kCarryThreads - 1) / kCarryThreads),
                       kCarryThreads, 0, stream>>>(
        static_cast<const float*>(summ), static_cast<const float*>(dh_last),
        static_cast<float*>(carry), bsz, n_seg, di, ds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (di + kChannels - 1) / kChannels;
  ssb_walk_kernel<U><<<dim3((unsigned)blocks, (unsigned)n_seg,
                            (unsigned)bsz),
                       kWalkThreads, walk_smem, stream>>>(
      static_cast<const R*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<const float*>(hck), static_cast<const float*>(qck),
      static_cast<const float*>(carry), static_cast<R*>(du),
      static_cast<float*>(ddt), static_cast<float*>(part),
      static_cast<float*>(da_part), static_cast<float*>(dd_part),
      static_cast<float*>(dh0), seq, di, ds, seg_len, n_seg, n_chunks, u_vec,
      f_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)bsz * seq;
  const long long total = rows * 2 * ds + (long long)di * ds + di;
  ssb_reduce_kernel<<<(unsigned)((total + kReduceThreads - 1) /
                                 kReduceThreads),
                      kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), blocks, rows, static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<const float*>(da_part),
      static_cast<const float*>(a_log), static_cast<float*>(da_log),
      static_cast<const float*>(dd_part), static_cast<float*>(dd_skip),
      bsz * n_seg, di, ds);
  return (int)cudaGetLastError();
}

}  // namespace

// u: [B, S, di] bf16 (u_bf16 = 1) or fp32; dt, dy: fp32 [B, S, di]; b, c:
// fp32 [B, S, ds]; a_log: fp32 [di, ds]; d_skip: fp32 [di]; h0, dh_last:
// fp32 [B, di, ds] or null (zeros).  Outputs: du [B, S, di] in u's type;
// fp32 ddt [B, S, di], db, dc [B, S, ds], da_log [di, ds], dd_skip [di] and
// dh0 [B, di, ds] or null (not written).  seg_len: the segments' length, a
// multiple of 8 (`bwd_plan`).  Scratch, fp32, as `bwd_plan` sizes it:
// hck, qck [B, ceil(S / 8), di, 16] (qck read only past one segment);
// summ [B, n_seg, 3, di, 16] and carry [B, n_seg, 2, di, 16] (unused for
// one segment); part [ceil(di / 64), B, S, 2, ds]; da_part [B, n_seg, di,
// ds]; dd_part [B, n_seg, di].  Four kernels on `stream` (three for one
// segment): the sweep, the carry, the walk, the ordered sums.
REPRO_EXPORT int selective_scan_bwd(
    const void* u, int u_bf16, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d_skip, const void* h0, const void* dy,
    const void* dh_last, void* du, void* ddt, void* db, void* dc,
    void* da_log, void* dd_skip, void* dh0, void* hck, void* qck, void* summ,
    void* carry, void* part, void* da_part, void* dd_part, int bsz, int seq,
    int di, int ds, int seg_len, void* stream) {
  if (bsz <= 0 || di <= 0) return cudaSuccess;
  if (seq < 0 || ds <= 0 || ds > kMaxState || bsz > 65535 || seg_len <= 0 ||
      seg_len % kChunk != 0)
    return cudaErrorInvalidValue;
  if (u_bf16)
    return launch<__nv_bfloat16>(u, dt, b, c, a_log, d_skip, h0, dy, dh_last,
                                 du, ddt, db, dc, da_log, dd_skip, dh0, hck,
                                 qck, summ, carry, part, da_part, dd_part,
                                 bsz, seq, di, ds, seg_len,
                                 as_stream(stream));
  return launch<float>(u, dt, b, c, a_log, d_skip, h0, dy, dh_last, du, ddt,
                       db, dc, da_log, dd_skip, dh0, hck, qck, summ, carry,
                       part, da_part, dd_part, bsz, seq, di, ds, seg_len,
                       as_stream(stream));
}
