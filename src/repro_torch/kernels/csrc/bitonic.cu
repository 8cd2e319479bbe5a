// Bitonic sort of uint32 rows, ascending lexicographically over all lanes
// (compaction phase 2 with sort_mode="device").
//
// Replaces: src/repro/kernels/bitonic_sort.py `_bitonic_kernel` (reached
// from `bitonic_sort`), which runs `bitonic_network` on a VMEM-resident
// buffer of at most 2^17 rows.
//
// What it computes: the compare-exchange network of `bitonic_network`,
// stage (k, j) for k = 2, 4, ..., n and j = k/2, ..., 1: the pair (i,
// i + j) with i & j == 0 is put in ascending order where i & k == 0 and in
// descending order elsewhere.  n is a power of two (the wrapper pads with
// all-ones sentinel rows, which sort last).  Rows compare as unsigned
// words; the callers' index lane makes every row unique, so the output
// equals a stable sort on the key lanes.
//
// Bound on the H100: HBM bytes of reading and writing the rows once.  The
// network moves them (log2 n)(log2 n + 1)/2 times; a 262,144 x 6 buffer
// (6 MB) stays in the 50 MB L2 between stages.
//
// Design: a stage whose pairs lie within aligned tiles of T rows (j < T,
// T = 1,024 rows of 6 lanes = 24 KB) runs in shared memory: one launch
// sorts every tile through all stages k <= T, and after the global stages
// j >= T of each larger k, one launch runs that k's stages j < T.  The
// global stages are one launch each over n/2 pairs, one thread per pair.
// So 262,144 rows take 45 launches instead of 171 (65,536: 28, not 136).  Everything runs on the
// caller's stream; the sort has no size cap (the TPU's 2^17 is a VMEM
// limit).  The entry point enqueues every launch, sets *launched to the
// number of kernels it enqueued, and returns the first launch error.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitonic_stage(uint32_t* __restrict__ rows, long long pairs, int lanes,
              long long j, long long k) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= pairs) return;
  const long long i = (t / j) * 2 * j + (t % j);   // i & j == 0
  uint32_t* a = rows + i * lanes;
  uint32_t* b = rows + (i + j) * lanes;
  const bool asc = (i & k) == 0;
  const bool swap = asc ? row_less(b, a, lanes) : row_less(a, b, lanes);
  if (!swap) return;
  for (int l = 0; l < lanes; ++l) {
    const uint32_t x = a[l];
    a[l] = b[l];
    b[l] = x;
  }
}

// Stages (k, j) with j < tile, for k = k_first..k_last (doubling), j
// starting at j_first for k_first and at k/2 for the rest; one block per
// tile of `tile` rows held in shared memory, tile/2 threads, one pair each.
__global__ void bitonic_tile(uint32_t* __restrict__ rows, int lanes,
                             int tile, long long k_first, long long k_last,
                             long long j_first) {
  extern __shared__ uint32_t sm[];
  const long long base = (long long)blockIdx.x * tile;
  uint32_t* g = rows + base * lanes;
  for (int w = threadIdx.x; w < tile * lanes; w += blockDim.x) sm[w] = g[w];
  __syncthreads();
  const int t = threadIdx.x;
  for (long long k = k_first; k <= k_last; k <<= 1) {
    for (long long j = (k == k_first ? j_first : k >> 1); j > 0; j >>= 1) {
      const int i = (int)((t / j) * 2 * j + (t % j));
      uint32_t* a = sm + i * lanes;
      uint32_t* b = sm + (i + j) * lanes;
      const bool asc = ((base + i) & k) == 0;
      if (asc ? row_less(b, a, lanes) : row_less(a, b, lanes)) {
        for (int l = 0; l < lanes; ++l) {
          const uint32_t x = a[l];
          a[l] = b[l];
          b[l] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int w = threadIdx.x; w < tile * lanes; w += blockDim.x) g[w] = sm[w];
}

constexpr int kMaxTile = 1024;
constexpr size_t kTileBytes = 48 * 1024;

}  // namespace

// rows: uint32 [n, lanes], sorted in place; n a power of two.  launched:
// host int, set to the number of kernels enqueued.
REPRO_EXPORT int bitonic_sort(void* rows, long long n, int lanes,
                              void* launched, void* stream) {
  int* count = static_cast<int*>(launched);
  *count = 0;
  if (n <= 1) return cudaSuccess;
  if (lanes <= 0 || (n & (n - 1)) != 0) return cudaErrorInvalidValue;
  uint32_t* r = static_cast<uint32_t*>(rows);
  cudaStream_t s = as_stream(stream);
  const long long pairs = n / 2;
  const unsigned grid = (unsigned)((pairs + kThreads - 1) / kThreads);
  // the largest power-of-two tile of at most kMaxTile rows in kTileBytes
  long long tile = n < kMaxTile ? n : kMaxTile;
  while (tile > 1 && (size_t)tile * lanes * sizeof(uint32_t) > kTileBytes)
    tile >>= 1;
  const size_t smem = (size_t)tile * lanes * sizeof(uint32_t);
  const unsigned tiles = (unsigned)(n / tile);
  if (tile >= 2) {   // every stage with k <= tile, in shared memory
    bitonic_tile<<<tiles, (unsigned)(tile / 2), smem, s>>>(
        r, lanes, (int)tile, 2, tile, 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*count;
  }
  for (long long k = (tile >= 2 ? tile * 2 : 2); k <= n; k <<= 1) {
    long long j = k >> 1;
    for (; j > 0 && (tile < 2 || j >= tile); j >>= 1) {
      bitonic_stage<<<grid, kThreads, 0, s>>>(r, pairs, lanes, j, k);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      ++*count;
    }
    if (j > 0) {   // the stages j < tile of this k, in shared memory
      bitonic_tile<<<tiles, (unsigned)(tile / 2), smem, s>>>(
          r, lanes, (int)tile, k, k, j);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      ++*count;
    }
  }
  return cudaSuccess;
}
