// Bloom filters: construction (phase 3 `filter`) and the two probes of the
// read path.  Build and probes share `bloom_hash` and `bloom_pos`, so the
// bits a probe tests are the bits the build set.
//
// Replaces: src/repro/kernels/bloom.py `_bloom_kernel` (reached from
// `bloom_build`), `_multi_probe_kernel` (from `multi_probe`) and
// `_bloom_query_kernel` (from `bloom_query`).
//
// What they compute: a filter is `n_words` uint32 words (m = 32 * n_words
// bits, m not a power of two in general: 5 words at the paper geometry).
// A key sets or tests `n_probes` bits at (h1 + i * h2) mod m, with h1, h2
// the FNV-1a-style lane hashes finished by murmur3 fmix32 (h2 forced odd),
// exactly as `repro.kernels.ref.bloom_hashes`, in uint32 wraparound
// arithmetic (the sum wraps at 2^32 before the modulo).
//
// * build: for each group of `per_group` keys, the bitmap of its valid
//   keys.  One thread block per group keeps the bitmap in shared memory;
//   threads hash keys and `atomicOr` each probe into it, then the block
//   writes it out.  OR does not depend on order, so the result is
//   bit-exact.  Block granularity is 5 words a group, SST granularity
//   5,120 words (20 KB), both inside the 48 KB default.
// * multi_probe: key i against filter i (the `multi_get` prune), one
//   thread per candidate.
// * query: each of Q keys of group g against filter g, one thread per
//   (group, query).
//   A probe loads only the probed words and stops at the first zero bit:
//   the same boolean as the TPU kernel's full AND over its one-hot
//   select / OR-reduce, which exists only because the VPU has no gather.
//
// Bound on the H100: HBM bytes (keys read once, the probed words or the
// bitmaps, the result written once).
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

__device__ __forceinline__ void bloom_hash(const uint32_t* k, int lanes,
                                           uint32_t& h1, uint32_t& h2) {
  h1 = 2166136261u;
  h2 = 2166136261u ^ 0xDEADBEEFu;
  for (int l = 0; l < lanes; ++l) {
    const uint32_t x = k[l];
    h1 = (h1 ^ x) * 16777619u;
    h2 = (h2 ^ 0x9E3779B9u ^ x) * 16777619u;
  }
  h1 = mix32(h1);
  h2 = mix32(h2) | 1u;
}

__device__ __forceinline__ uint32_t bloom_pos(uint32_t h1, uint32_t h2,
                                              int i, uint32_t m) {
  return (h1 + (uint32_t)i * h2) % m;
}

// True when every probed bit of `key` is set in `filter` (maybe present).
__device__ __forceinline__ bool bloom_probe(const uint32_t* filter,
                                            uint32_t m, const uint32_t* key,
                                            int lanes, int n_probes) {
  uint32_t h1, h2;
  bloom_hash(key, lanes, h1, h2);
  for (int i = 0; i < n_probes; ++i) {
    const uint32_t pos = bloom_pos(h1, h2, i, m);
    if (!((filter[pos >> 5] >> (pos & 31u)) & 1u)) return false;
  }
  return true;
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
    uint32_t h1, h2;
    bloom_hash(keys + row * lanes, lanes, h1, h2);
    for (int i = 0; i < n_probes; ++i) {
      const uint32_t pos = bloom_pos(h1, h2, i, m);
      atomicOr(&bits[pos >> 5], 1u << (pos & 31u));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_words; w += blockDim.x)
    out[g * n_words + w] = bits[w];
}

constexpr int kProbeThreads = 256;

// Row r of `keys` is probed against filter row r / per_filter.
__global__ void __launch_bounds__(kProbeThreads)
bloom_probe_kernel(const uint32_t* __restrict__ filters,
                   const uint32_t* __restrict__ keys, long long rows,
                   long long per_filter, int lanes, int n_words,
                   int n_probes, uint8_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kProbeThreads + threadIdx.x;
  if (r >= rows) return;
  const uint32_t* filter = filters + (r / per_filter) * n_words;
  out[r] = bloom_probe(filter, (uint32_t)n_words * 32u, keys + r * lanes,
                       lanes, n_probes) ? 1 : 0;
}

int launch_probe(const void* filters, const void* keys, long long rows,
                 long long per_filter, int lanes, int n_words, int n_probes,
                 void* out, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (n_words <= 0 || per_filter <= 0 || lanes <= 0)
    return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((rows + kProbeThreads - 1) / kProbeThreads);
  bloom_probe_kernel<<<grid, kProbeThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(filters),
      static_cast<const uint32_t*>(keys), rows, per_filter, lanes, n_words,
      n_probes, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
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

// filters: uint32 [c, n_words]; keys: uint32 [c, lanes]; out: bool [c].
REPRO_EXPORT int bloom_multi_probe(const void* filters, const void* keys,
                                   long long c, int lanes, int n_words,
                                   int n_probes, void* out, void* stream) {
  return launch_probe(filters, keys, c, 1, lanes, n_words, n_probes, out,
                      stream);
}

// filters: uint32 [groups, n_words]; keys: uint32 [groups, queries, lanes];
// out: bool [groups, queries].
REPRO_EXPORT int bloom_query(const void* filters, const void* keys,
                             long long groups, long long queries, int lanes,
                             int n_words, int n_probes, void* out,
                             void* stream) {
  return launch_probe(filters, keys, groups * queries, queries, lanes,
                      n_words, n_probes, out, stream);
}
