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
// nvalid[i] and row lo equals the query.  Output row i is packed as int32
// [2 + Vw]: found (0 or 1), then the meta word and the value of row lo
// where found, zeros elsewhere -- `repro.kernels.ref.lookup_blocks`'s three
// outputs side by side, so the read path copies one buffer back.
//
// Bound on the H100: HBM bytes (the query, the rows searched, the one
// value row; the outputs written once).  A wave of 256 candidates moves
// about 0.1 MB, a few hundredths of a microsecond at the HBM rate, so what
// a launch takes is its chain of dependent memory trips, not its bytes.
//
// Design: one warp per candidate, kWarps candidates a block.  The chain
// is two memory trips.  In the first, every load whose address does not
// depend on the search is issued at once: lane t loads key row t (of each
// chunk of 32 rows; 16-byte loads where `lanes` is a multiple of 4) and
// its meta word, and every lane the query and nvalid[i] (broadcasts).
// `__ballot_sync` / `__popc` of "row < query" gives lo, which on sorted
// rows is the lower bound the TPU kernel's unrolled binary search finds;
// the rows below lo are a prefix, so lo lies in the first chunk that is
// not all below the query, and the equality test and the meta word come
// from the lane that holds row lo (a ballot and a `__shfl_sync`, no
// reload).  The second trip is the value row, which only lo locates:
// coalesced 16-byte loads where Vw is a multiple of 4 (17 lanes for the
// paper's 68 words).  The TPU kernel's one-hot select / OR-reduce gathers
// exist only because the VPU has no row gather; here every lane loads its
// row directly.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // candidates per thread block
constexpr unsigned kFull = 0xFFFFFFFFu;

// Key row `p` into registers: LANES words, 16-byte loads when kVec.
template <int LANES, bool kVec>
__device__ __forceinline__ void load_row(const uint32_t* p,
                                         uint32_t (&r)[LANES]) {
  if constexpr (kVec) {
    static_assert(LANES % 4 == 0, "16-byte loads need lanes % 4 == 0");
#pragma unroll
    for (int l = 0; l < LANES; l += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + l));
      r[l] = v.x;
      r[l + 1] = v.y;
      r[l + 2] = v.z;
      r[l + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < LANES; ++l) r[l] = __ldg(p + l);
  }
}

// a < b and a == b, lexicographic over LANES unsigned words, no branch.
template <int LANES>
__device__ __forceinline__ void compare(const uint32_t (&a)[LANES],
                                        const uint32_t (&b)[LANES],
                                        bool& less, bool& equal) {
  less = false;
  equal = true;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    less = less || (equal && a[l] < b[l]);
    equal = equal && a[l] == b[l];
  }
}

// LANES = 0: `lanes` at run time (more than kMaxLanes), rows compared in
// global memory.
template <int LANES, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
lookup_kernel(const uint32_t* __restrict__ keys,
              const uint32_t* __restrict__ meta,
              const uint32_t* __restrict__ vals,
              const int32_t* __restrict__ nvalid,
              const uint32_t* __restrict__ queries, long long c, int k,
              int lanes, int vw, bool vals_vec, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= c) return;   // whole warp leaves together
  const long long row0 = i * k;
  const int nv = __ldg(nvalid + i);
  uint32_t q[LANES > 0 ? LANES : 1];
  if constexpr (LANES > 0) load_row<LANES, kVec>(queries + i * LANES, q);

  int lo = k;   // stays k when every row is below the query
  bool found = false;
  uint32_t m = 0;
  for (int base = 0; base < k; base += 32) {
    const int r = base + lane;
    bool less = false, equal = false;
    uint32_t mr = 0;
    if (r < k) {
      mr = __ldg(meta + row0 + r);
      if constexpr (LANES > 0) {
        uint32_t row[LANES];
        load_row<LANES, kVec>(keys + (row0 + r) * LANES, row);
        compare<LANES>(row, q, less, equal);
      } else {
        const uint32_t* row = keys + (row0 + r) * lanes;
        const uint32_t* qp = queries + i * lanes;
        less = row_less(row, qp, lanes);
        equal = !less && !row_less(qp, row, lanes);
      }
    }
    const int below = __popc(__ballot_sync(kFull, less));
    const unsigned eq = __ballot_sync(kFull, equal);
    if (below < min(32, k - base)) {   // warp-uniform: row lo is here
      lo = base + below;
      found = (eq >> below) & 1u;
      m = __shfl_sync(kFull, mr, below);
      break;
    }
  }
  found = found && lo < nv;

  uint32_t* dst = out + i * (2 + vw);
  if (lane == 0) {
    dst[0] = found ? 1u : 0u;
    dst[1] = found ? m : 0u;
  }
  dst += 2;
  if (!found) {
    for (int w = lane; w < vw; w += 32) dst[w] = 0u;
  } else if (vals_vec) {
    const uint4* v = reinterpret_cast<const uint4*>(vals + (row0 + lo) * vw);
    for (int w = lane; w < vw / 4; w += 32) {
      const uint4 x = v[w];
      dst[4 * w] = x.x;
      dst[4 * w + 1] = x.y;
      dst[4 * w + 2] = x.z;
      dst[4 * w + 3] = x.w;
    }
  } else {
    const uint32_t* v = vals + (row0 + lo) * vw;
    for (int w = lane; w < vw; w += 32) dst[w] = __ldg(v + w);
  }
}

constexpr int kMaxLanes = 8;

template <int LANES, bool kVec>
int launch(const void* keys, const void* meta, const void* vals,
           const void* nvalid, const void* queries, long long c, int k,
           int lanes, int vw, bool vals_vec, void* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((c + kWarps - 1) / kWarps);
  lookup_kernel<LANES, kVec><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(nvalid),
      static_cast<const uint32_t*>(queries), c, k, lanes, vw, vals_vec,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// keys: uint32 [c, k, lanes]; meta: uint32 [c, k]; vals: uint32 [c, k, vw];
// nvalid: int32 [c]; queries: uint32 [c, lanes]; out: uint32 [c, 2 + vw]
// (found, meta, value).
REPRO_EXPORT int lookup_blocks(const void* keys, const void* meta,
                               const void* vals, const void* nvalid,
                               const void* queries, long long c, int k,
                               int lanes, int vw, void* out, void* stream) {
  if (c <= 0) return cudaSuccess;
  if (k <= 0 || lanes <= 0 || vw < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = as_stream(stream);
  const bool vals_vec = vw % 4 == 0 && aligned16(vals);
  const bool vec = lanes % 4 == 0 && aligned16(keys) && aligned16(queries);
#define REPRO_LOOKUP(L, V) \
  launch<L, V>(keys, meta, vals, nvalid, queries, c, k, lanes, vw, vals_vec, \
               out, s)
  switch (lanes) {
    case 1: return REPRO_LOOKUP(1, false);
    case 2: return REPRO_LOOKUP(2, false);
    case 3: return REPRO_LOOKUP(3, false);
    case 4: return vec ? REPRO_LOOKUP(4, true) : REPRO_LOOKUP(4, false);
    case 5: return REPRO_LOOKUP(5, false);
    case 6: return REPRO_LOOKUP(6, false);
    case 7: return REPRO_LOOKUP(7, false);
    case kMaxLanes:
      return vec ? REPRO_LOOKUP(8, true) : REPRO_LOOKUP(8, false);
    default: return REPRO_LOOKUP(0, false);
  }
#undef REPRO_LOOKUP
}
