// Bloom filter construction, one bitmap per group (phase 3 `filter`).
//
// Replaces: src/repro/kernels/bloom.py `_bloom_kernel` (reached from
// `bloom_build`).
//
// What it computes: for each group of `per_group` keys, a bitmap of
// `n_words` uint32 words (m = 32 * n_words bits).  Every valid key sets
// `n_probes` bits at (h1 + i * h2) mod m, with h1, h2 the FNV-1a-style lane
// hashes finished by murmur3 fmix32 (h2 forced odd), exactly as
// `repro.kernels.ref.bloom_hashes`, in uint32 wraparound arithmetic.  OR
// does not depend on order, so the result is bit-exact.
//
// Bound on the H100: HBM bytes (keys and the valid mask read once, the
// bitmaps written once).
//
// Design: one thread block per group with the bitmap in shared memory;
// threads hash keys and `atomicOr` each probe into shared memory, then
// the block writes the bitmap out.  Block granularity is 5 words a group,
// SST granularity 5,120 words (20 KB), both inside the 48 KB default.  A
// later job dimension is blockIdx.y.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void bloom_build_kernel(const uint32_t* __restrict__ keys,
                                   const uint8_t* __restrict__ valid,
                                   int per_group, int lanes, int n_words,
                                   int n_probes, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t bits[];
  const long long g = blockIdx.x;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) bits[w] = 0u;
  __syncthreads();
  const uint32_t m = (uint32_t)n_words * 32u;
  for (int j = threadIdx.x; j < per_group; j += blockDim.x) {
    const long long row = g * per_group + j;
    if (!valid[row]) continue;
    const uint32_t* k = keys + row * lanes;
    uint32_t h1 = 2166136261u, h2 = 2166136261u ^ 0xDEADBEEFu;
    for (int l = 0; l < lanes; ++l) {
      const uint32_t x = k[l];
      h1 = (h1 ^ x) * 16777619u;
      h2 = (h2 ^ 0x9E3779B9u ^ x) * 16777619u;
    }
    h1 = mix32(h1);
    h2 = mix32(h2) | 1u;
    for (int i = 0; i < n_probes; ++i) {
      const uint32_t pos = (h1 + (uint32_t)i * h2) % m;
      atomicOr(&bits[pos >> 5], 1u << (pos & 31u));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_words; w += blockDim.x)
    out[g * n_words + w] = bits[w];
}

}  // namespace

// keys: uint32 [groups, per_group, lanes]; valid: bool [groups, per_group];
// out: uint32 [groups, n_words].
REPRO_EXPORT int bloom_build(const void* keys, const void* valid,
                             long long groups, int per_group, int lanes,
                             int n_words, int n_probes, void* out,
                             void* stream) {
  if (groups <= 0) return cudaSuccess;
  if (n_words <= 0 || per_group <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)n_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bloom_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((per_group + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  bloom_build_kernel<<<(unsigned)groups, threads, smem, as_stream(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint8_t*>(valid),
      per_group, lanes, n_words, n_probes, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
