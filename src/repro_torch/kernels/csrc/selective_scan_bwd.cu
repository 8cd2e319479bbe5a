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
// Bound on the H100: the bytes of u, dt, dy, du and ddt (B, C and their
// gradients are di times smaller), about level with the B*S*di*ds
// exponentials on the special-function units.
//
// Design (a first version: right and deterministic before fast).
//   * Four lanes a channel, four states a lane; 32 channels a block of 128
//     threads, the batch row as grid y.
//   * Pass 1 runs the recurrence forward and stores the state at the start
//     of every chunk of kChunk steps (scratch [B, chunks, di, 16] fp32, each
//     lane's four states as one 16-byte store).  Pass 2 takes the chunks
//     last to first: from the chunk's stored state it recomputes the
//     chunk's kChunk states into registers (a fully unrolled loop, so the
//     history is indexed at compile time), then walks them back.  So each
//     state is computed three times and the exponential three times.
//   * A chunk of u, dt, dy, B and C is staged through shared memory by the
//     whole block (coalesced rows of 32 channels).
//   * Sums over the states (du, ddt) close with two butterfly shuffles
//     among a channel's four lanes.  Sums over the channels (dB, dC) close
//     in three steps: a reduce-scatter over the warp's 8 channels (7
//     shuffles for 8 values a lane), the block's 4 warps added in order in
//     shared memory, and one partial a block that a second kernel adds
//     over the blocks in order.  dA and dD are written a batch row each and
//     added over the rows in the same second kernel.  No float atomics: the
//     same inputs give the same bits every run.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxState = 16;                 // ds a channel at most
constexpr int kLanes = 4;                     // lanes a channel
constexpr int kStates = kMaxState / kLanes;   // states a lane
constexpr int kChannels = kThreads / kLanes;  // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                    // steps between stored states
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

struct Stage {
  float u[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk][kMaxState];
  float c[kChunk][kMaxState];
  float red[kWarps][kChunk][32];   // a warp's dB and dC partials a step
  float du[kChunk][kChannels];
  float ddt[kChunk][kChannels];
};

// Steps [t0, t0 + n) of the block's channels into the stage; zeros past n,
// past di and past ds, so that those lanes and states add nothing.
template <typename U>
__device__ __forceinline__ void load_chunk(
    Stage& s, const typename Raw<U>::T* u, const float* dt, const float* dy,
    const float* bm, const float* cm, long long row, int n, int c0, int di,
    int ds, bool backward) {
  for (int k = threadIdx.x; k < kChunk * kChannels; k += kThreads) {
    const int r = k / kChannels, q = k % kChannels;
    const bool live = r < n && c0 + q < di;
    const long long off = (row + r) * di + c0 + q;
    s.u[r][q] = live ? Raw<U>::f(u[off]) : 0.f;
    s.dt[r][q] = live ? dt[off] : 0.f;
    if (backward) s.dy[r][q] = live ? dy[off] : 0.f;
  }
  for (int k = threadIdx.x; k < kChunk * kMaxState; k += kThreads) {
    const int r = k / kMaxState, q = k % kMaxState;
    const bool live = r < n && q < ds;
    const long long off = (row + r) * ds + q;
    s.b[r][q] = live ? bm[off] : 0.f;
    if (backward) s.c[r][q] = live ? cm[off] : 0.f;
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(
    const typename Raw<U>::T* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a_log, const float* __restrict__ d_skip,
    const float* __restrict__ h0, const float* __restrict__ dy,
    const float* __restrict__ dh_last, typename Raw<U>::T* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ part,
    float* __restrict__ da_part, float* __restrict__ dd_part,
    float* __restrict__ dh0, float* hck, int seq, int di, int ds) {
  __shared__ __align__(16) Stage s;
  const int b = blockIdx.y, bsz = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = threadIdx.x % kLanes;
  const int ci = threadIdx.x / kLanes;
  const int c0 = blockIdx.x * kChannels;
  const int i = c0 + ci;
  const bool live = i < di;
  const int s0 = p * kStates;
  const long long row0 = (long long)b * seq;
  const long long state = ((long long)b * di + i) * ds;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  // this lane's four states of chunk c's stored state
  auto ck = [&](int c) {
    return reinterpret_cast<float4*>(
        hck + (((long long)b * n_chunks + c) * di + i) * kMaxState + s0);
  };

  float a[kStates], a2[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const int st = s0 + k;
    a[k] = 0.f;
    h[k] = 0.f;
    if (live && st < ds) {
      a[k] = -expf(a_log[(long long)i * ds + st]);
      if (h0 != nullptr) h[k] = h0[state + st];
    }
    a2[k] = a[k] * kLog2e;
  }
  const float dskip = live ? d_skip[i] : 0.f;

  // pass 1: forward, the state at each chunk's start stored
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, seq - t0);
    if (live) *ck(c) = make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();   // the previous chunk is consumed
    load_chunk<U>(s, u, dt, dy, bm, cm, row0 + t0, n, c0, di, ds, false);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (t < n) {
        const float dd = s.dt[t][ci], x = dd * s.u[t][ci];
#pragma unroll
        for (int k = 0; k < kStates; ++k)
          h[k] = fmaf(ex2(dd * a2[k]), h[k], x * s.b[t][s0 + k]);
      }
    }
  }

  // pass 2: the chunks last to first
  float g[kStates], dA[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    g[k] = (dh_last != nullptr && live && s0 + k < ds)
               ? dh_last[state + s0 + k] : 0.f;
    dA[k] = 0.f;
  }
  float dD = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, seq - t0);
    float start[kStates] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      const float4 v = *ck(c);
      start[0] = v.x; start[1] = v.y; start[2] = v.z; start[3] = v.w;
    }
    __syncthreads();   // the previous chunk's stage is written out
    load_chunk<U>(s, u, dt, dy, bm, cm, row0 + t0, n, c0, di, ds, true);
    __syncthreads();
    // the chunk's states h_t, t = t0 .. t0 + n - 1, from its start
    float hs[kChunk][kStates];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float prev = t > 0 ? hs[t - 1][k] : start[k];
        hs[t][k] = prev;
        if (t < n) {
          const float dd = s.dt[t][ci];
          hs[t][k] = fmaf(ex2(dd * a2[k]), prev,
                          dd * s.u[t][ci] * s.b[t][s0 + k]);
        }
      }
    }
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      if (t < n) {   // n is the same for the whole block
        const float dd = s.dt[t][ci], uu = s.u[t][ci], yy = s.dy[t][ci];
        const float x = dd * uu;
        float sdu = 0.f, sddt = 0.f, v[2 * kStates];
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          const float bb = s.b[t][s0 + k], cc = s.c[t][s0 + k];
          const float e = ex2(dd * a2[k]);
          const float eh = e * (t > 0 ? hs[t - 1][k] : start[k]);
          g[k] = fmaf(yy, cc, g[k]);
          v[k] = g[k] * x;                 // dB
          v[kStates + k] = yy * hs[t][k];  // dC
          sdu = fmaf(g[k], bb, sdu);
          sddt = fmaf(g[k], fmaf(a[k], eh, uu * bb), sddt);
          dA[k] = fmaf(g[k] * dd, eh, dA[k]);
          g[k] *= e;
        }
        // over the channel's four lanes: every lane gets the same sums
        sdu += __shfl_xor_sync(0xffffffffu, sdu, 1);
        sdu += __shfl_xor_sync(0xffffffffu, sdu, 2);
        sddt += __shfl_xor_sync(0xffffffffu, sddt, 1);
        sddt += __shfl_xor_sync(0xffffffffu, sddt, 2);
        if (p == 0) {
          s.du[t][ci] = fmaf(dd, sdu, dskip * yy);
          s.ddt[t][ci] = sddt;
        }
        dD = fmaf(yy, uu, dD);
        // over the warp's 8 channels (lane bits 2-4), a reduce-scatter:
        // each step keeps half of the values and adds the partner's half,
        // so lane L ends with value L >> 2 of its lane group L & 3
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
    __syncthreads();
    for (int k = threadIdx.x; k < kChunk * kChannels; k += kThreads) {
      const int r = k / kChannels, q = k % kChannels;
      if (r < n && c0 + q < di) {
        const long long off = (row0 + t0 + r) * di + c0 + q;
        du[off] = Raw<U>::to(s.du[r][q]);
        ddt[off] = s.ddt[r][q];
      }
    }
    // the block's partial dB and dC: its warps added in order
    for (int k = threadIdx.x; k < kChunk * 32; k += kThreads) {
      const int r = k / 32, l = k % 32;
      const int kind = l >> 4;                          // 0 dB, 1 dC
      const int st = (l & 3) * kStates + ((l >> 2) & 3);
      if (r < n && st < ds) {
        float acc = s.red[0][r][l];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += s.red[w][r][l];
        part[((((long long)blockIdx.x * bsz + b) * seq + t0 + r) * 2 + kind) *
                 ds + st] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < kStates; ++k) {
      if (s0 + k < ds) {
        da_part[state + s0 + k] = dA[k];
        if (dh0 != nullptr) dh0[state + s0 + k] = g[k];
      }
    }
    if (p == 0) dd_part[(long long)b * di + i] = dD;
  }
}

// The ordered sums: dB and dC over the blocks' partials, dA (times A) and
// dD over the batch rows, each in index order.
__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce(const float* __restrict__ part, int blocks,
                          long long rows, float* __restrict__ db,
                          float* __restrict__ dc,
                          const float* __restrict__ da_part,
                          const float* __restrict__ a_log,
                          float* __restrict__ da_log,
                          const float* __restrict__ dd_part,
                          float* __restrict__ dd_skip, int bsz, int di,
                          int ds) {
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
    for (int b = 0; b < bsz; ++b) acc += da_part[(long long)b * n_a + idx];
    da_log[idx] = acc * -expf(a_log[idx]);
    return;
  }
  idx -= n_a;
  if (idx < di) {
    float acc = 0.f;
    for (int b = 0; b < bsz; ++b) acc += dd_part[(long long)b * di + idx];
    dd_skip[idx] = acc;
  }
}

template <typename U>
int launch(const void* u, const void* dt, const void* b, const void* c,
           const void* a_log, const void* d_skip, const void* h0,
           const void* dy, const void* dh_last, void* du, void* ddt, void* db,
           void* dc, void* da_log, void* dd_skip, void* dh0, void* hck,
           void* part, void* da_part, void* dd_part, int bsz, int seq, int di,
           int ds, cudaStream_t stream) {
  const int blocks = (di + kChannels - 1) / kChannels;
  selective_scan_bwd_kernel<U><<<dim3((unsigned)blocks, (unsigned)bsz),
                                 kThreads, 0, stream>>>(
      static_cast<const typename Raw<U>::T*>(u),
      static_cast<const float*>(dt), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a_log),
      static_cast<const float*>(d_skip), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<typename Raw<U>::T*>(du), static_cast<float*>(ddt),
      static_cast<float*>(part), static_cast<float*>(da_part),
      static_cast<float*>(dd_part), static_cast<float*>(dh0),
      static_cast<float*>(hck), seq, di, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)bsz * seq;
  const long long total = rows * 2 * ds + (long long)di * ds + di;
  selective_scan_bwd_reduce<<<(unsigned)((total + kReduceThreads - 1) /
                                         kReduceThreads),
                              kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), blocks, rows, static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<const float*>(da_part),
      static_cast<const float*>(a_log), static_cast<float*>(da_log),
      static_cast<const float*>(dd_part), static_cast<float*>(dd_skip), bsz,
      di, ds);
  return (int)cudaGetLastError();
}

}  // namespace

// u: [B, S, di] bf16 (u_bf16 = 1) or fp32; dt, dy: fp32 [B, S, di]; b, c:
// fp32 [B, S, ds]; a_log: fp32 [di, ds]; d_skip: fp32 [di]; h0, dh_last:
// fp32 [B, di, ds] or null (zeros).  Outputs: du [B, S, di] in u's type;
// fp32 ddt [B, S, di], db, dc [B, S, ds], da_log [di, ds], dd_skip [di] and
// dh0 [B, di, ds] or null (not written).  Scratch, fp32: hck [B, ceil(S / 16), di, 16]; part
// [ceil(di / 32), B, S, 2, ds]; da_part [B, di, ds]; dd_part [B, di].  Two
// kernels on `stream`: the scan, then the ordered sums.
REPRO_EXPORT int selective_scan_bwd(
    const void* u, int u_bf16, const void* dt, const void* b, const void* c,
    const void* a_log, const void* d_skip, const void* h0, const void* dy,
    const void* dh_last, void* du, void* ddt, void* db, void* dc,
    void* da_log, void* dd_skip, void* dh0, void* hck, void* part,
    void* da_part, void* dd_part, int bsz, int seq, int di, int ds,
    void* stream) {
  if (bsz <= 0 || di <= 0) return cudaSuccess;
  if (seq < 0 || ds <= 0 || ds > kMaxState || bsz > 65535)
    return cudaErrorInvalidValue;
  if (u_bf16)
    return launch<__nv_bfloat16>(u, dt, b, c, a_log, d_skip, h0, dy, dh_last,
                                 du, ddt, db, dc, da_log, dd_skip, dh0, hck,
                                 part, da_part, dd_part, bsz, seq, di, ds,
                                 as_stream(stream));
  return launch<float>(u, dt, b, c, a_log, d_skip, h0, dy, dh_last, du, ddt,
                       db, dc, da_log, dd_skip, dh0, hck, part, da_part,
                       dd_part, bsz, seq, di, ds, as_stream(stream));
}
