// Batched point lookup: query i searched in decoded block i, then the
// matched row's meta word and value gathered (the `multi_get` gather).
//
// Replaces: src/repro/kernels/lookup.py `_lookup_kernel` (reached from
// `lookup_blocks`).
//
// What it computes: block i holds K key rows of `lanes` uint32 words,
// sorted lexicographically (unsigned), with the all-ones sentinel at and
// after nvalid[i].  lo = the number of rows < query (the lower bound, so
// the leftmost equal row: the newest version of the key); found = lo <
// nvalid[i] and row lo equals the query.  meta and value come from row
// lo where found and are zero elsewhere, as `repro.kernels.ref.
// lookup_blocks` returns them.
//
// Bound on the H100: HBM bytes (the query, the rows searched, the one
// value row; the outputs written once).
//
// Design: one warp per candidate.  Lane t compares key row t (of each
// chunk of 32 rows) with the query; `__ballot_sync` / `__popc` of
// "row < query" counts the rows below it, which on sorted rows is the
// lower bound the TPU kernel's unrolled binary search finds.  The warp
// then copies the Vw-word value row coalesced, or writes zeros.  The TPU
// kernel's one-hot select / OR-reduce gathers exist only because the VPU
// has no row gather; here every lane loads its row directly.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // candidates per thread block

__global__ void __launch_bounds__(kWarps * 32)
lookup_kernel(const uint32_t* __restrict__ keys,
              const uint32_t* __restrict__ meta,
              const uint32_t* __restrict__ vals,
              const int32_t* __restrict__ nvalid,
              const uint32_t* __restrict__ queries, long long c, int k,
              int lanes, int vw, uint8_t* __restrict__ found_out,
              uint32_t* __restrict__ meta_out,
              uint32_t* __restrict__ vals_out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= c) return;   // whole warp leaves together
  const uint32_t* q = queries + i * lanes;
  const uint32_t* block = keys + i * k * lanes;
  int lo = 0;
  for (int base = 0; base < k; base += 32) {
    const int r = base + lane;
    const bool less = r < k && row_less(block + (long long)r * lanes, q, lanes);
    lo += __popc(__ballot_sync(0xFFFFFFFFu, less));
  }
  bool found = lo < nvalid[i] && lo < k;
  if (found) {
    const uint32_t* row = block + (long long)lo * lanes;
    for (int l = 0; l < lanes; ++l) found &= row[l] == q[l];
  }
  const long long src = i * k + lo;
  if (lane == 0) {
    found_out[i] = found ? 1 : 0;
    meta_out[i] = found ? meta[src] : 0u;
  }
  uint32_t* dst = vals_out + i * vw;
  const uint32_t* v = vals + src * vw;
  for (int w = lane; w < vw; w += 32) dst[w] = found ? v[w] : 0u;
}

}  // namespace

// keys: uint32 [c, k, lanes]; meta: uint32 [c, k]; vals: uint32 [c, k, vw];
// nvalid: int32 [c]; queries: uint32 [c, lanes]; found_out: bool [c];
// meta_out: uint32 [c]; vals_out: uint32 [c, vw].
REPRO_EXPORT int lookup_blocks(const void* keys, const void* meta,
                               const void* vals, const void* nvalid,
                               const void* queries, long long c, int k,
                               int lanes, int vw, void* found_out,
                               void* meta_out, void* vals_out, void* stream) {
  if (c <= 0) return cudaSuccess;
  if (k <= 0 || lanes <= 0 || vw < 0) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((c + kWarps - 1) / kWarps);
  lookup_kernel<<<grid, kWarps * 32, 0, as_stream(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(nvalid),
      static_cast<const uint32_t*>(queries), c, k, lanes, vw,
      static_cast<uint8_t*>(found_out), static_cast<uint32_t*>(meta_out),
      static_cast<uint32_t*>(vals_out));
  return (int)cudaGetLastError();
}
