// Shared-prefix lengths of sorted keys (phase 3 `shared_key`).
//
// Replaces: src/repro/kernels/prefix.py `_prefix_kernel` (reached from
// `prefix_encode`).
//
// What it computes: for each key row (uint32 lanes holding big-endian key
// bytes), the number of leading bytes equal to the previous row's, and 0
// at every `restart`-th row.  Within a lane, equal leading bytes are
// clz(a ^ b) / 8.
//
// Bound on the H100: HBM bytes (each key is read once, twice counting the
// neighbour read that L1 serves, and one int32 written).
//
// Design: one thread per row.  A later job dimension is blockIdx.y.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
prefix_encode_kernel(const uint32_t* __restrict__ keys, long long n,
                     int lanes, int restart, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (i % restart == 0) {
    out[i] = 0;
    return;
  }
  const uint32_t* k = keys + i * lanes;
  const uint32_t* p = k - lanes;
  int shared = 0;
  for (int l = 0; l < lanes; ++l) {
    const uint32_t x = k[l] ^ p[l];
    if (x != 0) {
      shared += __clz(x) >> 3;
      break;
    }
    shared += 4;
  }
  out[i] = shared;
}

}  // namespace

// keys: uint32 [n, lanes]; out: int32 [n].
REPRO_EXPORT int prefix_encode(const void* keys, long long n, int lanes,
                               int restart, void* out, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (restart <= 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  prefix_encode_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(keys), n, lanes, restart,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
