// Shared pieces of the port's CUDA kernels.
//
// Every kernel file exposes plain C entry points (no PyTorch headers, so
// each file compiles in seconds).  An entry point takes device pointers
// and the CUDA stream as `void*`, launches on that stream, does not
// synchronise, and returns `cudaGetLastError()` right after the launch so
// the Python wrapper can raise on a refused launch.  Outputs and scratch
// are allocated by the wrapper.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

static inline cudaStream_t as_stream(void* s) {
  return reinterpret_cast<cudaStream_t>(s);
}

// Streaming multiprocessors of the current device (132 on an H100 SXM).
static inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Lexicographic a < b over `lanes` uint32 words.  Unsigned compare: the
// all-ones sentinel rows must sort after every real row.
__device__ __forceinline__ bool row_less(const uint32_t* a, const uint32_t* b,
                                         int lanes) {
  for (int l = 0; l < lanes; ++l) {
    uint32_t x = a[l], y = b[l];
    if (x != y) return x < y;
  }
  return false;
}
