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
// units (16 a clock per SM), about level with the bytes of u, dt and y
// read or written once (B and C are di times smaller).
//
// Design: the TPU kernel keeps a tile of states in VMEM and walks the
// sequence; here one thread owns one (b, i) channel and keeps its ds <= 16
// states and its row of A in registers for the whole walk, so the state
// never leaves the SM and the wrapper does not chunk the sequence.  The
// walk goes kChunk steps at a time: each thread first loads its channel's
// kChunk values of u and dt into registers (neighbouring threads,
// neighbouring channels: coalesced, and all kChunk loads in flight
// together), the block stages the kChunk rows of B and C it shares through
// shared memory, then the steps run out of registers and shared memory.
// y is written per step (coalesced); h_last once at the end.  `expf`, not
// `__expf`, keeps the kernel within a few ulp of the plain version.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 64;    // channels per block
constexpr int kMaxState = 16;   // ds, held in registers
constexpr int kChunk = 16;      // steps staged at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const U* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_log,
                      const float* __restrict__ d_skip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int seq, int di, int ds) {
  __shared__ float s_b[kChunk][kMaxState];
  __shared__ float s_c[kChunk][kMaxState];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < di;
  const long long state = ((long long)b * di + i) * ds;

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int s = 0; s < kMaxState; ++s) {
    a[s] = 0.f;
    h[s] = 0.f;
    if (live && s < ds) {
      a[s] = -expf(a_log[(long long)i * ds + s]);
      if (h0 != nullptr) h[s] = h0[state + s];
    }
  }
  const float d = live ? d_skip[i] : 0.f;
  const long long row0 = (long long)b * seq;   // this batch row's first step

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int n = min(kChunk, seq - t0);
    float uu[kChunk], dd[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      uu[t] = 0.f;
      dd[t] = 0.f;
      if (live && t < n) {
        const long long off = (row0 + t0 + t) * di + i;
        uu[t] = to_float(u[off]);
        dd[t] = dt[off];
      }
    }
    __syncthreads();   // the previous chunk's B and C are no longer read
    for (int k = threadIdx.x; k < n * ds; k += kThreads) {
      const int t = k / ds, s = k - t * ds;
      const long long off = (row0 + t0 + t) * ds + s;
      s_b[t][s] = bm[off];
      s_c[t][s] = cm[off];
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < n) {   // the same for every thread of the block
        const float dtu = dd[t] * uu[t];
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxState; ++s) {
          if (s < ds) {
            h[s] = expf(dd[t] * a[s]) * h[s] + dtu * s_b[t][s];
            acc += h[s] * s_c[t][s];
          }
        }
        if (live) y[(row0 + t0 + t) * di + i] = acc + d * uu[t];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kMaxState; ++s)
      if (s < ds) h_last[state + s] = h[s];
  }
}

template <typename U>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a_log, const void* d_skip, const void* h0, void* y,
           void* h_last, int bsz, int seq, int di, int ds,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((di + kThreads - 1) / kThreads), (unsigned)bsz);
  selective_scan_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), seq, di, ds);
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
