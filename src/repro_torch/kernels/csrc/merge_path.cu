// Rank-and-scatter merge of two sorted runs of uint32 rows (phase 2).
//
// Replaces: src/repro/kernels/merge_path.py `_merge_kernel` together with
// its XLA-side `_partition` (reached from `merge_sorted` / `merge_runs`).
//
// What it computes: rows of run a and run b (each sorted lexicographically
// over all `lanes` words, compared unsigned) land at their final position
// in the merged run.  Row i of a goes to i + (rows of b strictly less);
// row j of b goes to j + (rows of a less or equal), so ties go to a, the
// earlier run.  The trailing index lane makes every row unique, so any
// correct merge gives this one output.  The Python wrapper drives the same
// pairwise tree as the JAX package (ceil(log2 k) levels), skipping empty
// runs and passing a single run through.
//
// Bound on the H100: HBM bytes (each level reads and writes the tuples
// once).  The binary search re-reads O(log n) rows of the other run per
// row; those reads hit L2 (a 65,536 x 6 run is 1.5 MB).
//
// Design: one thread per output row, no partition pass and no shared
// memory.  The grid is 1-D over the rows of one merge; a later job
// dimension is blockIdx.y.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_pair_kernel(const uint32_t* __restrict__ a, long long na,
                  const uint32_t* __restrict__ b, long long nb,
                  uint32_t* __restrict__ out, int lanes) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= na + nb) return;
  const bool from_a = i < na;
  if (!from_a) i -= na;
  const uint32_t* q = (from_a ? a : b) + i * lanes;
  const uint32_t* hay = from_a ? b : a;
  long long lo = 0, hi = from_a ? nb : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const uint32_t* r = hay + mid * lanes;
    // a rows: lower bound (hay < q); b rows: upper bound (hay <= q)
    const bool descend = from_a ? row_less(r, q, lanes) : !row_less(q, r, lanes);
    if (descend) lo = mid + 1; else hi = mid;
  }
  uint32_t* dst = out + (i + lo) * lanes;
  for (int l = 0; l < lanes; ++l) dst[l] = q[l];
}

}  // namespace

// a: uint32 [na, lanes], b: uint32 [nb, lanes], out: uint32 [na+nb, lanes].
REPRO_EXPORT int merge_pair(const void* a, long long na, const void* b,
                            long long nb, void* out, int lanes, void* stream) {
  const long long n = na + nb;
  if (n <= 0) return cudaSuccess;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  merge_pair_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(a), na, static_cast<const uint32_t*>(b),
      nb, static_cast<uint32_t*>(out), lanes);
  return (int)cudaGetLastError();
}
