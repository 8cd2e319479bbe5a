// Bloom filters: construction (phase 3 `filter`) and the two probes of the
// read path.  Build and probes share `hash_lane`, `mix32` and the position
// (h1 + i * h2) mod m, so the bits a probe tests are the bits the build
// set.
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
//   keys.  OR does not depend on order, so the result is bit-exact by any
//   route.  The host chooses the route by shape (`bloom.build_lanes`).  A
//   short row (up to kShortWords words: block granularity, 16 keys and 5
//   words a group at the paper geometry) goes to a sub-warp of S lanes, S
//   the power of two >= min(per_group, 32), so two groups share a warp at
//   16 keys: each lane hashes its key (one 16-byte load at 4 lanes), sets
//   its probed bits in its own word registers, and the words are
//   OR-reduced across the sub-warp by shuffles -- no shared memory, atomic
//   or barrier, which the first version's one block a group (half its 32
//   threads idle at 16 keys) paid for.  A long row (SST granularity,
//   5,120 words) keeps one block a group with the bitmap in shared memory
//   and `atomicOr`.  Both take each position by `mod_magic` instead of a
//   `%` by the run-time m.
// * multi_probe: key i against filter i (the `multi_get` prune), one
//   thread per candidate.  A probe is the AND of the probed bits, as the
//   TPU kernel's full AND over its one-hot select / OR-reduce (which exists
//   only because the VPU has no gather).  A wave of the prune moves a few
//   KB, so what a launch takes is its chain of dependent memory trips, and
//   the probe keeps it to one: the filter row's address does not depend on
//   the key, so a short row (up to kRowWords words: the paper's 5) comes
//   whole into registers in the same trip as the key lanes, and the probed
//   words are picked from registers; a longer row (an SST's 5,120 words)
//   takes its probed words in one batch of loads after the hash, with no
//   branch between them.
// * query: each of Q keys of group g against filter g.  At the phase-2
//   shape (1,024 groups x 256 queries, 5 words) its 262,144 threads are
//   resident at once, one wave: every thread waits for its key (4 MB in
//   all, the bound), then hashes and probes, so the design cuts what a
//   thread does.  Block (g, y) takes queries y * blockDim.x + threadIdx.x
//   of group g, so no thread divides to find its group (x is the group: G
//   may pass grid.y's 65,535); the key is hashed from 16-byte loads
//   (`hash_key`); a probe's word is (x >> 5) mod W by one 32-bit
//   multiply-high and a correction (`word_mod`) and its bit x & 31, the
//   bit x mod 32W names, without `mod_magic`'s 64-bit multiplies; the loop
//   stops at the first zero bit and reads the probed word through L1,
//   where the group's row sits after the block's first miss.  Holding the
//   row in registers or shared memory and ANDing every probe without a
//   branch (multi_probe's design) measured slower here: an absent key
//   stops after about two probes.
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

__device__ __forceinline__ void hash_lane(uint32_t x, uint32_t& h1,
                                          uint32_t& h2) {
  h1 = (h1 ^ x) * 16777619u;
  h2 = (h2 ^ 0x9E3779B9u ^ x) * 16777619u;
}

constexpr uint32_t kH1 = 2166136261u, kH2 = 2166136261u ^ 0xDEADBEEFu;

// x mod m, exact for every 32-bit x and m > 1, by Lemire, Kaser and
// Kurz's direct remainder: magic = floor((2^64 - 1) / m) + 1.  Two 64-bit
// multiplies instead of the dozens of dependent instructions of `%` by a
// run-time divisor.
__device__ __forceinline__ uint32_t mod_magic(uint32_t x, uint64_t magic,
                                              uint32_t m) {
  return (uint32_t)__umul64hi(magic * x, m);
}

// h1, h2 of a key of `lanes` words; 16-byte loads when vec4 (lanes a
// multiple of 4 and the keys 16-byte aligned).
__device__ __forceinline__ void hash_key(const uint32_t* __restrict__ key,
                                         int lanes, bool vec4, uint32_t& h1,
                                         uint32_t& h2) {
  h1 = kH1;
  h2 = kH2;
  if (vec4) {
    for (int l = 0; l < lanes; l += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(key + l));
      hash_lane(v.x, h1, h2);
      hash_lane(v.y, h1, h2);
      hash_lane(v.z, h1, h2);
      hash_lane(v.w, h1, h2);
    }
  } else {
    for (int l = 0; l < lanes; ++l) hash_lane(__ldg(key + l), h1, h2);
  }
  h1 = mix32(h1);
  h2 = mix32(h2) | 1u;
}

constexpr int kBuildThreads = 256;
constexpr int kShortWords = 32;   // filter words a sub-warp holds
constexpr int kBlockThreads = 1024;

// Short rows: group g's filter built by a sub-warp of `1 << sub_log2`
// lanes (a power of two, at most 32) with no shared memory, atomic or
// barrier.  Each lane takes keys s, s + sub, ... of the group, sets the
// probed bits in its own NW word registers (a word picked by compares, so
// the words stay in registers), then each word is OR-reduced across the
// sub-warp by `__shfl_xor_sync` and lanes write the words.  NW >= n_words.
template <int NW>
__global__ void __launch_bounds__(kBuildThreads)
bloom_build_warp_kernel(const uint32_t* __restrict__ keys,
                        const uint8_t* __restrict__ valid, long long groups,
                        int per_group, int lanes, int n_words, int n_probes,
                        int sub_log2, bool vec4, uint64_t magic,
                        uint32_t* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * kBuildThreads + threadIdx.x;
  const int sub = 1 << sub_log2;
  const long long g = tid >> sub_log2;
  const int s = (int)(tid & (sub - 1));
  const uint32_t m = (uint32_t)n_words * 32u;
  uint32_t acc[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) acc[q] = 0u;
  if (g < groups) {
    for (int j = s; j < per_group; j += sub) {
      // the key and its valid byte in one trip: hash before the test
      const long long row = g * per_group + j;
      const bool live = valid[row];
      uint32_t h1, h2;
      hash_key(keys + row * lanes, lanes, vec4, h1, h2);
      if (!live) continue;
      for (int i = 0; i < n_probes; ++i) {
        const uint32_t pos = mod_magic(h1 + (uint32_t)i * h2, magic, m);
        const uint32_t word = pos >> 5, bit = 1u << (pos & 31u);
#pragma unroll
        for (int q = 0; q < NW; ++q) acc[q] |= word == (uint32_t)q ? bit : 0u;
      }
    }
  }
  // every lane of the warp takes part (n_words is the same for all)
  for (int off = sub >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < NW; ++q)
      if (q < n_words) acc[q] |= __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  if (g >= groups) return;
  for (int w = s; w < n_words; w += sub) {
    uint32_t v = 0u;
#pragma unroll
    for (int q = 0; q < NW; ++q) v = w == q ? acc[q] : v;
    out[g * n_words + w] = v;
  }
}

// Long rows (an SST's 5,120 words): one block a group, the bitmap in
// shared memory, each probe `atomicOr`ed into it; up to kBlockThreads
// threads, so that an SST's 16,384 keys are 16 a thread.
__global__ void __launch_bounds__(kBlockThreads)
bloom_build_block_kernel(const uint32_t* __restrict__ keys,
                         const uint8_t* __restrict__ valid, int per_group,
                         int lanes, int n_words, int n_probes, bool vec4,
                         uint64_t magic, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t bits[];
  const long long g = blockIdx.x;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) bits[w] = 0u;
  __syncthreads();
  const uint32_t m = (uint32_t)n_words * 32u;
  for (int j = threadIdx.x; j < per_group; j += blockDim.x) {
    const long long row = g * per_group + j;
    const bool live = valid[row];
    uint32_t h1, h2;
    hash_key(keys + row * lanes, lanes, vec4, h1, h2);
    if (!live) continue;
    for (int i = 0; i < n_probes; ++i) {
      const uint32_t pos = mod_magic(h1 + (uint32_t)i * h2, magic, m);
      atomicOr(&bits[pos >> 5], 1u << (pos & 31u));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < n_words; w += blockDim.x)
    out[g * n_words + w] = bits[w];
}

constexpr int kProbeThreads = 64;   // a 256-candidate wave on 4 SMs
constexpr int kRowWords = 16;    // rows up to this come whole to registers
constexpr int kKeyLanes = 8;     // key lanes loaded in the first trip
constexpr int kProbeBatch = 8;   // probes unrolled: their words together

// f[idx] for idx < kRowWords without indexing registers (which would put
// the row in local memory): a tree of selects, four deep.
__device__ __forceinline__ uint32_t pick(const uint32_t (&f)[kRowWords],
                                         uint32_t idx) {
  static_assert(kRowWords == 16, "a four-level tree");
  uint32_t a[8], b[4];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = idx & 8u ? f[j + 8] : f[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = idx & 4u ? a[j + 4] : a[j];
  const uint32_t c0 = idx & 2u ? b[2] : b[0];
  const uint32_t c1 = idx & 2u ? b[3] : b[1];
  return idx & 1u ? c1 : c0;
}

// Row r of `keys` is probed against filter row r.  kShort: the filter row
// has at most kRowWords words.  magic: `mod_magic`'s for m = 32 * n_words.
template <bool kShort>
__global__ void __launch_bounds__(kProbeThreads)
multi_probe_kernel(const uint32_t* __restrict__ filters,
                   const uint32_t* __restrict__ keys, long long rows,
                   int lanes, int n_words, int n_probes, uint64_t magic,
                   uint8_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kProbeThreads + threadIdx.x;
  if (r >= rows) return;
  const uint32_t* filter = filters + r * n_words;
  const uint32_t* key = keys + r * lanes;
  // the first trip: the whole short filter row and the key lanes
  uint32_t f[kRowWords];
  if constexpr (kShort) {
#pragma unroll
    for (int w = 0; w < kRowWords; ++w)
      f[w] = w < n_words ? __ldg(filter + w) : 0u;
  }
  uint32_t kw[kKeyLanes];
#pragma unroll
  for (int l = 0; l < kKeyLanes; ++l) kw[l] = l < lanes ? __ldg(key + l) : 0u;
  uint32_t h1 = kH1, h2 = kH2;
#pragma unroll
  for (int l = 0; l < kKeyLanes; ++l)
    if (l < lanes) hash_lane(kw[l], h1, h2);
  for (int l = kKeyLanes; l < lanes; ++l) hash_lane(__ldg(key + l), h1, h2);
  h1 = mix32(h1);
  h2 = mix32(h2) | 1u;

  // the AND of the probed bits, kProbeBatch probes at a time, unrolled so
  // that their positions (and, for a long row, their word loads: the
  // second trip) are independent of one another
  const uint32_t m = (uint32_t)n_words * 32u;
  uint32_t all = 1u;
  for (int i0 = 0; i0 < n_probes; i0 += kProbeBatch) {
    if constexpr (kShort) {
#pragma unroll
      for (int j = 0; j < kProbeBatch; ++j) {
        if (i0 + j < n_probes) {   // the same for every thread
          const uint32_t pos =
              mod_magic(h1 + (uint32_t)(i0 + j) * h2, magic, m);
          all &= pick(f, pos >> 5) >> (pos & 31u);
        }
      }
    } else {
      uint32_t word[kProbeBatch], bit[kProbeBatch];
#pragma unroll
      for (int j = 0; j < kProbeBatch; ++j) {
        const uint32_t pos =
            mod_magic(h1 + (uint32_t)(i0 + j) * h2, magic, m);
        bit[j] = pos & 31u;
        word[j] = i0 + j < n_probes ? __ldg(filter + (pos >> 5)) : ~0u;
      }
#pragma unroll
      for (int j = 0; j < kProbeBatch; ++j) all &= word[j] >> bit[j];
    }
  }
  out[r] = (uint8_t)(all & 1u);
}

// (x mod 32W) >> 5, that is (x >> 5) mod W, exact for every 32-bit x:
// minv = floor((2^32 - 1) / W) gives a quotient of y = x >> 5 < 2^27 that
// is right or one short, so one subtraction corrects the remainder.
__device__ __forceinline__ uint32_t word_mod(uint32_t x, uint32_t w,
                                             uint32_t minv) {
  const uint32_t y = x >> 5;
  const uint32_t r = y - __umulhi(y, minv) * w;
  return r >= w ? r - w : r;
}

constexpr int kQueryThreads = 256;

// Query y * blockDim.x + threadIdx.x of group blockIdx.x against the
// group's filter row.
__global__ void __launch_bounds__(kQueryThreads)
bloom_query_kernel(const uint32_t* __restrict__ filters,
                   const uint32_t* __restrict__ keys, long long queries,
                   int lanes, int n_words, int n_probes, bool vec4,
                   uint32_t minv, uint8_t* __restrict__ out) {
  const long long q = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= queries) return;
  const long long g = blockIdx.x;
  const uint32_t* filter = filters + g * n_words;
  const long long r = g * queries + q;
  uint32_t h1, h2;
  hash_key(keys + r * lanes, lanes, vec4, h1, h2);
  uint8_t ok = 1;
  for (int i = 0; i < n_probes; ++i) {
    const uint32_t x = h1 + (uint32_t)i * h2;
    if (!((__ldg(filter + word_mod(x, (uint32_t)n_words, minv)) >>
           (x & 31u)) & 1u)) {
      ok = 0;
      break;
    }
  }
  out[r] = ok;
}

}  // namespace

// keys: uint32 [groups, per_group, lanes]; valid: bool [groups, per_group];
// out: uint32 [groups, n_words].  sub_warp: the lanes a group takes on the
// short route (a power of two up to 32, with n_words <= kShortWords), or 0
// for the block route; the wrapper's `bloom.build_lanes` chooses it.
REPRO_EXPORT int bloom_build(const void* keys, const void* valid,
                             long long groups, int per_group, int lanes,
                             int n_words, int n_probes, int sub_warp,
                             void* out, void* stream) {
  if (groups <= 0) return cudaSuccess;
  if (n_words <= 0 || per_group <= 0 || lanes <= 0 || n_probes < 0 ||
      sub_warp < 0 || sub_warp > 32 || (sub_warp & (sub_warp - 1)) != 0 ||
      (sub_warp > 0 && n_words > kShortWords))
    return cudaErrorInvalidValue;
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint32_t* o = static_cast<uint32_t*>(out);
  const bool vec4 =
      lanes % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const uint64_t magic = ~0ull / ((uint64_t)n_words * 32u) + 1u;
  cudaStream_t s = as_stream(stream);
  if (sub_warp > 0) {
    const int sub_log2 = __builtin_ctz((unsigned)sub_warp);
    const long long threads = groups << sub_log2;
    const unsigned grid =
        (unsigned)((threads + kBuildThreads - 1) / kBuildThreads);
    auto kernel = n_words <= 8 ? bloom_build_warp_kernel<8>
                               : bloom_build_warp_kernel<kShortWords>;
    kernel<<<grid, kBuildThreads, 0, s>>>(k, v, groups, per_group, lanes,
                                          n_words, n_probes, sub_log2, vec4,
                                          magic, o);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)n_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bloom_build_block_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((per_group + 31) / 32) * 32;
  if (threads > kBlockThreads) threads = kBlockThreads;
  bloom_build_block_kernel<<<(unsigned)groups, threads, smem, s>>>(
      k, v, per_group, lanes, n_words, n_probes, vec4, magic, o);
  return (int)cudaGetLastError();
}

// filters: uint32 [c, n_words]; keys: uint32 [c, lanes]; out: bool [c].
REPRO_EXPORT int bloom_multi_probe(const void* filters, const void* keys,
                                   long long c, int lanes, int n_words,
                                   int n_probes, void* out, void* stream) {
  if (c <= 0) return cudaSuccess;
  if (n_words <= 0 || lanes <= 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((c + kProbeThreads - 1) / kProbeThreads);
  const uint64_t magic = ~0ull / ((uint64_t)n_words * 32u) + 1u;
  auto kernel = n_words <= kRowWords ? multi_probe_kernel<true>
                                     : multi_probe_kernel<false>;
  kernel<<<grid, kProbeThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(filters),
      static_cast<const uint32_t*>(keys), c, lanes, n_words, n_probes, magic,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// filters: uint32 [groups, n_words]; keys: uint32 [groups, queries, lanes];
// out: bool [groups, queries].
REPRO_EXPORT int bloom_query(const void* filters, const void* keys,
                             long long groups, long long queries, int lanes,
                             int n_words, int n_probes, void* out,
                             void* stream) {
  if (groups <= 0 || queries <= 0) return cudaSuccess;
  if (n_words <= 0 || lanes <= 0 || n_probes < 0 || groups >= (1ll << 31))
    return cudaErrorInvalidValue;
  // a block of whole warps, no wider than the queries need
  const int threads = (int)(queries < kQueryThreads
                                ? (queries + 31) / 32 * 32 : kQueryThreads);
  const long long chunks = (queries + threads - 1) / threads;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)groups, (unsigned)chunks);
  const bool vec4 =
      lanes % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  bloom_query_kernel<<<grid, threads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(filters),
      static_cast<const uint32_t*>(keys), queries, lanes, n_words, n_probes,
      vec4, 0xFFFFFFFFu / (uint32_t)n_words, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
