// Shared-prefix lengths of sorted keys (phase 3 `shared_key`), and with them
// the pack's wire keys.
//
// Replaces: src/repro/kernels/prefix.py `_prefix_kernel` (reached from
// `prefix_encode`).
//
// What it computes: for each key row (uint32 lanes holding big-endian key
// bytes), the number of leading bytes equal to the previous row's, and 0
// at every `restart`-th row.  Within a lane, equal leading bytes are
// clz(a ^ b) / 8.  The wire route also takes the survivor count (a device
// scalar, so the pack never waits on the host): shared[i] = 0 for i >=
// count, and the wire key is the key with its first shared[i] bytes zeroed
// -- the pack's `torch.where(valid, shared, 0)` and
// `formats.zero_prefix_lanes`, which were 15 PyTorch launches, in this one.
// A batch of jobs (keys [J * job_rows, lanes], one survivor count a job)
// reads row i's count at count[i / job_rows], and shares nothing across a
// job's first row: job_rows is a whole number of restart intervals (the
// host checks it), so a job starts at a restart point.
//
// Bound on the H100: HBM bytes (each key read once, the int32 written
// once, and on the wire route each wire key written once).
//
// Design: one thread a row, rows of a warp consecutive.  A row's key comes
// to registers in one 16-byte load a 4 lanes (when aligned); its
// predecessor's lanes come from the neighbouring thread by
// `__shfl_up_sync`, so only lane 0 of a warp loads a second row, and only
// when its row is not a restart point (never when `restart` divides 32:
// the store's 16).  The restart test is a mask for a power-of-two interval
// and a 32-bit remainder otherwise.  Lane counts 1 to 8 are compile-time
// (keys in registers); more lanes take a run-time route that reads the
// predecessor from memory, as the first version did.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 8;   // keys held in registers up to this

// lane mask of the first nz (0..4) big-endian bytes; a 32-bit shift is
// undefined, so 4 bytes is its own case
__device__ __forceinline__ uint32_t prefix_mask(int nz) {
  return nz >= 4 ? ~0u : ~(~0u >> (8 * nz));
}

// lane l of a key with its first s bytes zeroed
__device__ __forceinline__ uint32_t zero_prefix(uint32_t lane, int s, int l) {
  return lane & ~prefix_mask(min(max(s - 4 * l, 0), 4));
}

struct Args {
  const uint32_t* keys;
  long long n;
  int lanes;     // run-time lanes (L == 0)
  int restart;
  bool pow2;     // restart is a power of two
  bool vec4;     // 16-byte loads and stores
  const long long* count;   // wire route: survivors a job, on the device
  uint32_t job_rows;        // rows a job (a multiple of restart)
  int32_t* shared;
  uint32_t* wire;           // nullptr: the shared-only route
};

template <int L>
__device__ __forceinline__ void load_row(const Args& a, long long i,
                                         uint32_t (&k)[kMaxLanes]) {
  const uint32_t* p = a.keys + i * L;
  if (L % 4 == 0 && a.vec4) {
#pragma unroll
    for (int l = 0; l < L; l += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + l));
      k[l] = v.x;
      k[l + 1] = v.y;
      k[l + 2] = v.z;
      k[l + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) k[l] = __ldg(p + l);
  }
}

// L: compile-time lanes (1..kMaxLanes), or 0 for run-time lanes.  Every
// thread of a warp reaches the shuffles, so no thread returns before them.
template <int L, bool kWire>
__global__ void __launch_bounds__(kThreads)
prefix_encode_kernel(Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < a.n;
  const uint32_t u = (uint32_t)i;   // n < 2^31 (checked by the host)
  const bool restart_row =
      (a.pow2 ? (u & (uint32_t)(a.restart - 1)) : u % (uint32_t)a.restart)
      == 0u;
  int s = 0;
  if constexpr (L > 0) {
    uint32_t k[kMaxLanes], p[kMaxLanes];
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) k[l] = 0u;
    if (in) load_row<L>(a, i, k);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int l = 0; l < L; ++l) p[l] = __shfl_up_sync(0xffffffffu, k[l], 1);
    if (lane == 0 && in && !restart_row) load_row<L>(a, i - 1, p);
    bool done = false;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t x = k[l] ^ p[l];
      if (!done) {
        s += x ? __clz(x) >> 3 : 4;
        done = x != 0u;
      }
    }
    if (!in) return;
    if (restart_row) s = 0;
    if constexpr (kWire) {
      const uint32_t j = u / a.job_rows;
      if ((long long)(u - j * a.job_rows) >= a.count[j]) s = 0;
#pragma unroll
      for (int l = 0; l < L; ++l) k[l] = zero_prefix(k[l], s, l);
      uint32_t* w = a.wire + i * L;
      if (L % 4 == 0 && a.vec4) {
#pragma unroll
        for (int l = 0; l < L; l += 4)
          *reinterpret_cast<uint4*>(w + l) =
              make_uint4(k[l], k[l + 1], k[l + 2], k[l + 3]);
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l) w[l] = k[l];
      }
    }
  } else {
    if (!in) return;
    const int lanes = a.lanes;
    const uint32_t* k = a.keys + i * lanes;
    if (!restart_row) {
      const uint32_t* p = k - lanes;
      for (int l = 0; l < lanes; ++l) {
        const uint32_t x = __ldg(k + l) ^ __ldg(p + l);
        if (x != 0u) {
          s += __clz(x) >> 3;
          break;
        }
        s += 4;
      }
    }
    if constexpr (kWire) {
      const uint32_t j = u / a.job_rows;
      if ((long long)(u - j * a.job_rows) >= a.count[j]) s = 0;
      uint32_t* w = a.wire + i * lanes;
      for (int l = 0; l < lanes; ++l)
        w[l] = zero_prefix(__ldg(k + l), s, l);
    }
  }
  a.shared[i] = s;
}

template <bool kWire>
cudaError_t launch(const Args& a, unsigned grid, cudaStream_t st) {
  switch (a.lanes) {
#define REPRO_PREFIX_CASE(L)                                          \
  case L:                                                             \
    prefix_encode_kernel<L, kWire><<<grid, kThreads, 0, st>>>(a);     \
    break;
    REPRO_PREFIX_CASE(1)
    REPRO_PREFIX_CASE(2)
    REPRO_PREFIX_CASE(3)
    REPRO_PREFIX_CASE(4)
    REPRO_PREFIX_CASE(5)
    REPRO_PREFIX_CASE(6)
    REPRO_PREFIX_CASE(7)
    REPRO_PREFIX_CASE(8)
#undef REPRO_PREFIX_CASE
    default:
      prefix_encode_kernel<0, kWire><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// keys: uint32 [n, lanes]; shared: int32 [n].  count and wire (uint32 [n,
// lanes]) both null: the shared-only route; both given: the wire route,
// count an int64 [n / job_rows] on the device, the survivors of each job
// of job_rows rows (n itself for one job).
REPRO_EXPORT int prefix_encode(const void* keys, long long n, int lanes,
                               int restart, const void* count,
                               long long job_rows, void* shared, void* wire,
                               void* stream) {
  if (n <= 0) return cudaSuccess;
  if (restart <= 0 || lanes <= 0 || n >= (1ll << 31) ||
      (count == nullptr) != (wire == nullptr) || job_rows <= 0 ||
      n % job_rows != 0 || job_rows % restart != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.keys = static_cast<const uint32_t*>(keys);
  a.n = n;
  a.lanes = lanes;
  a.restart = restart;
  a.pow2 = (restart & (restart - 1)) == 0;
  a.vec4 = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(wire) % 16 == 0;
  a.count = static_cast<const long long*>(count);
  a.job_rows = (uint32_t)job_rows;
  a.shared = static_cast<int32_t*>(shared);
  a.wire = static_cast<uint32_t*>(wire);
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = as_stream(stream);
  return (int)(wire ? launch<true>(a, grid, st) : launch<false>(a, grid, st));
}
