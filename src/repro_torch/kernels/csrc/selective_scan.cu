// Mamba-1 selective scan, forward: the prefill path of `mamba_forward`.
//
// Replaces: src/repro/kernels/selective_scan.py `_scan_kernel` (reached from
// `selective_scan`).
//
// What it computes: for each batch row b and channel i, with A = -exp(a_log)
// and a state h[ds] that starts at h0 (or 0), for t = 0 .. S-1
//     h    = exp(dt[t] * A) * h + dt[t] * u[t] * B[t]
//     y[t] = h . C[t] + D * u[t]
// in fp32 whatever the type of u (bf16 or fp32); it returns y [B, S, di] and
// the last state h_last [B, di, ds], both fp32.
//
// Bound on the H100: the B*S*di*ds exponentials on the special-function
// units (16 a clock per SM), about level with the bytes of u, dt and y read
// or written once (B and C are di times smaller).
//
// Design.  The first version gave one thread one (b, i) with all 16 states
// and loaded a chunk of u and dt ahead into registers: at B = 1 that is 256
// warps, two an SM, each waiting out its loads and the accurate `expf`'s
// range reduction (27 x its bound).  Here:
//   * P = 2 lanes, next to each other in a warp, share one channel, each
//     holding 8 states and their A * log2(e) in registers; exp(dt * A) is
//     one multiply and one `ex2.approx.ftz` (MUFU.EX2).  Trials on the
//     card: four or more lanes a channel (more warps at B = 1) cost more in
//     per-channel work than they gain; an exp2 polynomial on the FMA pipe
//     in place of MUFU.EX2 was slower, and leaving out the exponentials,
//     the y stores or the B and C loads each saved little: the kernel is
//     bound by instruction issue and its stalls (about 48 instructions a
//     warp and step), not by the special-function units or one memory
//     stream.  Where the grid has fewer than 8 warps an SM (B = 1) the
//     kernel may take 255 registers a thread, else 128 (four blocks an SM);
//   * u, dt, B and C reach shared memory through a ring of NSTG stages of
//     kChunk steps, filled by `cp.async` (16-byte pieces of the block's
//     channels, coalesced; 4-byte pieces of B and C), NSTG - 1 chunks ahead
//     of the chunk being scanned: up to 72 KB in flight an SM, no registers
//     spent on them, one barrier a chunk;
//   * y = sum_s h_s C_s: each lane sums its states, then log2(P) shuffles
//     finish the sum and the lane of state 0 stores y, a chunk at a time;
//     with D and u read again there, 128 registers a thread hold the walk
//     without spills (four blocks an SM).  (A transposed
//     reduction through shared memory pays off only with ds lanes a
//     channel, where a shuffle tree would cost four steps.)
// The state never leaves the SM and the wrapper does not chunk the
// sequence.  ex2.approx has a relative error of about 2^-22, far inside the
// 1e-4 tolerance against the plain version's exp.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxState = 16;   // ds a channel at most
constexpr int kLanes = 2;       // lanes a channel (P)
constexpr int kStates = kMaxState / kLanes;   // states a lane
constexpr int kChannels = kThreads / kLanes;  // channels a block
constexpr int kChunk = 16;      // steps a pipeline stage
constexpr int kStages = 4;      // pipeline stages (NSTG)
constexpr float kLog2e = 1.4426950408889634f;

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

// u as loaded (raw), and its value in fp32
template <typename U> struct Raw;
template <> struct Raw<float> {
  using T = float;
  static __device__ __forceinline__ float f(T x) { return x; }
};
template <> struct Raw<__nv_bfloat16> {
  using T = unsigned short;
  static __device__ __forceinline__ float f(T x) {
    return __uint_as_float((uint32_t)x << 16);
  }
};

// Copy rows [0, n) x columns [0, width) of a [rows, stride] array at src
// into dst [kChunk][CH]: 16-byte cp.async pieces when `vec` (width == CH,
// src and stride 16-byte aligned), else plain loads and stores (a ragged
// channel edge or an unaligned width; visible after the next barrier).
template <int CH, typename E>
__device__ __forceinline__ void tile_async(E* dst, const E* src,
                                           long long stride, int n,
                                           int width, bool vec) {
  constexpr int kPer = 16 / sizeof(E);
  if (vec) {
    constexpr int kPieces = CH / kPer;
    for (int k = threadIdx.x; k < n * kPieces; k += kThreads) {
      const int r = k / kPieces, q = (k % kPieces) * kPer;
      cp_async16(dst + r * CH + q, src + r * stride + q);
    }
  } else {
    for (int k = threadIdx.x; k < n * CH; k += kThreads) {
      const int r = k / CH, q = k % CH;
      if (q < width) dst[r * CH + q] = src[r * stride + q];
    }
  }
}

template <typename U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
selective_scan_kernel(const typename Raw<U>::T* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_log,
                      const float* __restrict__ d_skip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int seq, int di, int ds,
                      int u_vec, int dt_vec) {
  using R = typename Raw<U>::T;
  constexpr int P = kLanes, NS = kStates, CH = kChannels, NSTG = kStages;
  __shared__ __align__(16) R s_u[NSTG][kChunk][CH];
  __shared__ __align__(16) float s_dt[NSTG][kChunk][CH];
  __shared__ __align__(16) float s_b[NSTG][kChunk][kMaxState];
  __shared__ __align__(16) float s_c[NSTG][kChunk][kMaxState];
  const int b = blockIdx.y;
  const int p = threadIdx.x % P;
  const int ci = threadIdx.x / P;
  const int c0 = blockIdx.x * CH;
  const int i = c0 + ci;
  const bool live = i < di;
  const int s0 = p * NS;
  const long long state = ((long long)b * di + i) * ds;
  const long long row0 = (long long)b * seq;   // this batch row's first step
  const int width = min(CH, di - c0);

  // states past ds read B = C = 0 (and start at 0, with A = 0): they stay
  // 0; the copies below fill only s < ds
  if (ds < kMaxState) {
    for (int k = threadIdx.x; k < NSTG * kChunk * kMaxState; k += kThreads) {
      (&s_b[0][0][0])[k] = 0.f;
      (&s_c[0][0][0])[k] = 0.f;
    }
  }
  // chunk c of u, dt, B and C into stage c % NSTG; one commit group a
  // chunk (empty past the end), so the group count stays uniform
  auto issue = [&](int c) {
    const int t0 = c * kChunk;
    if (t0 < seq) {
      const int n = min(kChunk, seq - t0), st = c % NSTG;
      const long long off = (row0 + t0) * di + c0;
      tile_async<CH>(&s_u[st][0][0], u + off, di, n, width,
                     u_vec && width == CH);
      tile_async<CH>(&s_dt[st][0][0], dt + off, di, n, width,
                     dt_vec && width == CH);
      const long long boff = (row0 + t0) * ds;
      for (int k = threadIdx.x; k < n * kMaxState; k += kThreads) {
        const int r = k / kMaxState, s = k % kMaxState;
        if (s < ds) {
          cp_async4(&s_b[st][r][s], bm + boff + r * ds + s);
          cp_async4(&s_c[st][r][s], cm + boff + r * ds + s);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < NSTG - 1; ++c) issue(c);

  float a2[NS], h[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    a2[k] = 0.f;
    h[k] = 0.f;
    const int s = s0 + k;
    if (live && s < ds) {
      a2[k] = -expf(a_log[(long long)i * ds + s]) * kLog2e;
      if (h0 != nullptr) h[k] = h0[state + s];
    }
  }

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NSTG - 2>();   // this thread's copies of chunk c landed
    __syncthreads();             // everyone's did; chunk c - 1 is consumed
    issue(c + NSTG - 1);         // into the stage chunk c - 1 used
    const int st = c % NSTG, t0 = c * kChunk;
    const int n = min(kChunk, seq - t0);   // the same for the whole block
    // the chunk in three passes, so that nothing between the steps'
    // arithmetic stops the compiler from overlapping them: each step's
    // partial sum of h . C over this lane's states, then the shuffles
    // across the P lanes, then the stores.  Only h carries from step to
    // step.  `full` is a compile-time flag, so a full chunk is one basic
    // block and only the last chunk tests each step.
    auto walk = [&](auto full_chunk) {
      constexpr bool full = decltype(full_chunk)::value;
      float acc[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        acc[t] = 0.f;
        if (full || t < n) {
          const float dd = s_dt[st][t][ci];
          const float x = dd * Raw<U>::f(s_u[st][t][ci]);
#pragma unroll
          for (int q = 0; q < NS; q += 4) {
            const float4 bv =
                *reinterpret_cast<const float4*>(&s_b[st][t][s0 + q]);
            const float4 cv =
                *reinterpret_cast<const float4*>(&s_c[st][t][s0 + q]);
            const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
            const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              h[q + r] = fmaf(ex2(dd * a2[q + r]), h[q + r], x * bb[r]);
              acc[t] = fmaf(h[q + r], cc[r], acc[t]);
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t)
#pragma unroll
        for (int o = 1; o < P; o <<= 1)
          acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
      if (live && p == 0) {
        float* yt = y + (row0 + t0) * di + i;
#pragma unroll
        for (int t = 0; t < kChunk; ++t)
          if (full || t < n)
            yt[(long long)t * di] =   // D and u read again: no registers
                acc[t] +              // held for them across the chunk
                __ldg(d_skip + i) * Raw<U>::f(s_u[st][t][ci]);
      }
    };
    if (n == kChunk)
      walk(std::true_type{});
    else
      walk(std::false_type{});
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (live) {
#pragma unroll
    for (int k = 0; k < NS; ++k)
      if (s0 + k < ds) h_last[state + s0 + k] = h[k];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename U, int MINB>
void launch_m(const void* u, const void* dt, const void* b, const void* c,
              const void* a_log, const void* d_skip, const void* h0, void* y,
              void* h_last, int bsz, int seq, int di, int ds,
              cudaStream_t stream) {
  const dim3 grid((unsigned)((di + kChannels - 1) / kChannels),
                  (unsigned)bsz);
  // 16-byte pieces need 16-byte aligned rows: the base and di * size
  const int u_vec = aligned16(u) && (di * (int)sizeof(U)) % 16 == 0;
  const int dt_vec = aligned16(dt) && di % 4 == 0;
  static bool carveout = false;   // room for four blocks' rings an SM
  if (!carveout) {
    cudaFuncSetAttribute(selective_scan_kernel<U, MINB>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    carveout = true;
  }
  selective_scan_kernel<U, MINB><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename Raw<U>::T*>(u),
      static_cast<const float*>(dt), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a_log),
      static_cast<const float*>(d_skip), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_last), seq, di, ds,
      u_vec, dt_vec);
}

template <typename U>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a_log, const void* d_skip, const void* h0, void* y,
           void* h_last, int bsz, int seq, int di, int ds,
           cudaStream_t stream) {
  // fewer than 8 warps an SM: more registers a thread, two blocks an SM
  const long long warps = (long long)bsz * di * 2 / 32;
  if (warps < 8LL * sm_count())
    launch_m<U, 2>(u, dt, b, c, a_log, d_skip, h0, y, h_last, bsz, seq, di,
                   ds, stream);
  else
    launch_m<U, 4>(u, dt, b, c, a_log, d_skip, h0, y, h_last, bsz, seq, di,
                   ds, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// u: [B, S, di] bf16 (u_bf16 = 1) or fp32; dt: fp32 [B, S, di]; b, c: fp32
// [B, S, ds]; a_log: fp32 [di, ds]; d_skip: fp32 [di]; h0: fp32 [B, di, ds]
// or null (zeros); y: fp32 [B, S, di]; h_last: fp32 [B, di, ds].
REPRO_EXPORT int selective_scan(const void* u, int u_bf16, const void* dt,
                                const void* b, const void* c,
                                const void* a_log, const void* d_skip,
                                const void* h0, void* y, void* h_last,
                                int bsz, int seq, int di, int ds,
                                void* stream) {
  if (bsz <= 0 || di <= 0) return cudaSuccess;
  if (seq < 0 || ds <= 0 || ds > kMaxState || bsz > 65535)
    return cudaErrorInvalidValue;
  if (u_bf16)
    return launch<__nv_bfloat16>(u, dt, b, c, a_log, d_skip, h0, y, h_last,
                                 bsz, seq, di, ds, as_stream(stream));
  return launch<float>(u, dt, b, c, a_log, d_skip, h0, y, h_last, bsz, seq,
                       di, ds, as_stream(stream));
}
