// One level of the pairwise merge tree of sorted runs of uint32 rows, as
// device code that more than one kernel runs: `merge_path.cu`'s
// `merge_level_kernel` (phase 2 with sort_mode="merge") and `bitonic.cu`'s
// `sort_level_kernel` (the merge levels of the device sort).  Each file
// instantiates its own `__global__`, so each counts and traces under its
// own kernel.
//
// What a level computes: every pair of the level (the pair table, planned
// on the host by `merge_path.plan_levels`) merged into its output rows.
// Rows are sorted lexicographically over all `lanes` words, compared
// unsigned, and ties go to the left, earlier run, so the tree's result is
// a stable merge.  A run keeps its rows at every level; the table names
// for each operand and output which of the three buffers (input, two
// scratch) holds it, so a run carried up a level is read in place, never
// copied.
//
// Design (the merge path of Green et al. and ModernGPU's merge passes):
// all pairs of a level in one launch, one block for each tile of kTile
// output rows of one pair.  A block finds its tile's two splits itself,
// each by one warp's 33-way search along the cross diagonal (three or four
// rounds of global loads for runs of 16,384 to 131,072 rows, no partition
// launch); stages the two windows, exactly its tile's rows, in shared
// memory with coalesced `cp.async` copies; each thread finds its own split
// of the tile by a binary search in shared memory (comparing words only up
// to the first that differs) and merges kPerThread rows into registers
// without a branch; the merged tile goes back through shared memory and
// out with coalesced stores.  `lanes` (1 to kMaxLanes) is a template
// argument, so a row lives in registers; for an even `lanes` rows move as
// 8-byte words.
//
// A batch of jobs (a leading job axis, every job the same runs): the pair
// table is the one job's, and the grid's y dimension is the job.  Job j's
// rows start at row j * job_rows of each buffer, so one launch merges a
// level of every job, and J jobs take the one job's launches.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 2;                  // output rows a thread
constexpr int kTile = kThreads * kPerThread;   // output rows a block
constexpr int kMaxPairs = 64;                  // pairs a launch
constexpr int kMaxLanes = 8;

// One launch's pair table (by value, in the kernel's parameter space).
struct Level {
  uint32_t* buf[3];   // 0: the input rows; 1, 2: scratch
  long long job_rows;           // rows a job: job blockIdx.y starts there
  long long off[kMaxPairs];     // first row of the pair's left run
  long long len_a[kMaxPairs];
  long long len_b[kMaxPairs];
  int first_tile[kMaxPairs + 1];
  unsigned char src_a[kMaxPairs], src_b[kMaxPairs], dst[kMaxPairs];
  int n_pairs;
};

// The level of host pair table `pairs` (int64 [n_pairs, 6] of (off, len_a,
// len_b, src_a, src_b, dst)) over buffers `bufs` (bufs[2] may be null when
// no pair names it), `tile_rows` output rows a block, each pair inside a
// job of `job_rows` rows.  Sets *tiles to the blocks a job's level takes;
// returns cudaSuccess or the error to report.
static inline int make_level(void* const (&bufs)[3], int n_pairs,
                             const long long* pairs, int tile_rows,
                             long long job_rows, Level& lv, int* tiles) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || tile_rows < 1 || job_rows < 1)
    return cudaErrorInvalidValue;
  for (const void* q : bufs)
    if (reinterpret_cast<uintptr_t>(q) % 8 != 0)
      return cudaErrorMisalignedAddress;
  lv = Level{};
  for (int i = 0; i < 3; ++i) lv.buf[i] = static_cast<uint32_t*>(bufs[i]);
  long long n_tiles = 0;
  for (int p = 0; p < n_pairs; ++p) {
    const long long* q = pairs + 6 * p;
    if (q[1] < 1 || q[2] < 1 || q[3] < 0 || q[3] > 2 || q[4] < 0 ||
        q[4] > 2 || q[5] < 1 || q[5] > 2 || q[3] == q[5] || q[4] == q[5] ||
        bufs[q[3]] == nullptr || bufs[q[4]] == nullptr ||
        bufs[q[5]] == nullptr || q[0] < 0 || q[0] + q[1] + q[2] > job_rows)
      return cudaErrorInvalidValue;
    lv.off[p] = q[0];
    lv.len_a[p] = q[1];
    lv.len_b[p] = q[2];
    lv.src_a[p] = (unsigned char)q[3];
    lv.src_b[p] = (unsigned char)q[4];
    lv.dst[p] = (unsigned char)q[5];
    lv.first_tile[p] = (int)n_tiles;
    n_tiles += (q[1] + q[2] + tile_rows - 1) / tile_rows;
  }
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  lv.first_tile[n_pairs] = (int)n_tiles;
  lv.n_pairs = n_pairs;
  lv.job_rows = job_rows;
  *tiles = (int)n_tiles;
  return cudaSuccess;
}

// The pair of block t: the last whose first tile is <= t.
__device__ __forceinline__ int pair_of_tile(const Level& lv, int t) {
  int p = 0;
  for (int step = kMaxPairs / 2; step > 0; step >>= 1)
    if (p + step < lv.n_pairs && lv.first_tile[p + step] <= t) p += step;
  return p;
}

// A row into registers; 8-byte loads for an even `lanes` (every row of the
// buffers, global and shared, is then 8-byte aligned).
template <int L>
__device__ __forceinline__ void load_row(const uint32_t* p, uint32_t (&r)[L]) {
  if (L % 2 == 0) {
#pragma unroll
    for (int l = 0; l < L / 2; ++l) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[l];
      r[2 * l] = v.x;
      r[2 * l + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) r[l] = p[l];
  }
}

// x < y, lexicographic and unsigned, on rows in registers
template <int L>
__device__ __forceinline__ bool row_lt(const uint32_t (&x)[L],
                                       const uint32_t (&y)[L]) {
  bool lt = false, eq = true;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    lt = lt || (eq && x[l] < y[l]);
    eq = eq && x[l] == y[l];
  }
  return lt;
}

// x < y on rows in shared memory, reading words only up to the first that
// differs
template <int L>
__device__ __forceinline__ bool smem_row_lt(const uint32_t* x,
                                            const uint32_t* y) {
#pragma unroll
  for (int l = 0; l < L - 1; ++l) {
    const uint32_t a = x[l], b = y[l];
    if (a != b) return a < b;
  }
  return x[L - 1] < y[L - 1];
}

// Rows of a among the first d rows of the stable merge of a (na rows) and
// b (nb rows): the first i with b[d-1-i] < a[i], by the whole warp.  Each
// round the 32 lanes test 32 points spread over [lo, hi); the points that
// keep taking a are a prefix of the lanes, so a ballot narrows the range
// 33-fold (exactly, once it is 32 rows or fewer).
template <int L>
__device__ long long warp_split(const uint32_t* a, long long na,
                                const uint32_t* b, long long nb, long long d,
                                int lane) {
  long long lo = max(0LL, d - nb), hi = min(d, na);
  while (lo < hi) {
    const long long p = lo + (long long)(lane + 1) * (hi - lo) / 33;
    uint32_t ra[L], rb[L];
    load_row<L>(a + p * L, ra);
    load_row<L>(b + (d - 1 - p) * L, rb);
    const unsigned take_a = __ballot_sync(0xffffffffu, !row_lt<L>(rb, ra));
    const int c = __popc(take_a);
    const long long p_last = __shfl_sync(0xffffffffu, p, (c + 31) & 31);
    const long long p_next = __shfl_sync(0xffffffffu, p, c & 31);
    if (c > 0) lo = p_last + 1;
    if (c < 32) hi = p_next;
  }
  return lo;
}

template <int W>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(4 * W));
}

// The body of a level kernel: block blockIdx.x merges its tile of kTile
// output rows of job blockIdx.y; run by kThreads threads.
template <int L>
__device__ __forceinline__ void merge_level(const Level& lv) {
  // words move W at a time: 2 for an even `lanes`, else 1
  constexpr int W = L % 2 == 0 ? 2 : 1;
  __shared__ __align__(16) uint32_t tile[kTile * L];
  __shared__ long long split[2];

  const int t = blockIdx.x;
  const int p = pair_of_tile(lv, t);
  const long long off = (long long)blockIdx.y * lv.job_rows + lv.off[p];
  const long long na = lv.len_a[p], nb = lv.len_b[p];
  const uint32_t* a = lv.buf[lv.src_a[p]] + off * L;
  const uint32_t* b = lv.buf[lv.src_b[p]] + (off + na) * L;
  uint32_t* out = lv.buf[lv.dst[p]] + off * L;
  const long long d0 = (long long)(t - lv.first_tile[p]) * kTile;
  const long long d1 = min(d0 + kTile, na + nb);

  // 1. the tile's start and end splits, one warp each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long s = warp_split<L>(a, na, b, nb, warp ? d1 : d0, lane);
    if (lane == 0) split[warp] = s;
  }
  __syncthreads();
  const long long i0 = split[0];
  const int n_t = (int)(d1 - d0);
  const int na_t = (int)(split[1] - i0), nb_t = n_t - na_t;

  // 2. the two windows, a's rows then b's, into shared memory
  const uint32_t* ga = a + i0 * L;
  const uint32_t* gb = b + (d0 - i0) * L;
  const int wa = na_t * L, wn = n_t * L;
  for (int w = threadIdx.x * W; w < wn; w += kThreads * W)
    cp_async<W>(tile + w, w < wa ? ga + w : gb + (w - wa));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. this thread's rows [k0, k0 + cnt) of the tile: its split by a binary
  //    search in shared memory, then a serial merge into registers
  const uint32_t* sa = tile;
  const uint32_t* sb = tile + wa;
  const int k0 = min((int)threadIdx.x * kPerThread, n_t);
  const int cnt = min(kPerThread, n_t - k0);
  int lo = max(0, k0 - nb_t), hi = min(k0, na_t);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (smem_row_lt<L>(sb + (k0 - 1 - mid) * L, sa + mid * L))
      hi = mid;
    else
      lo = mid + 1;
  }
  int ia = lo, ib = k0 - lo;
  uint32_t ra[L] = {}, rb[L] = {}, res[kPerThread][L];
  if (ia < na_t) load_row<L>(sa + ia * L, ra);
  if (ib < nb_t) load_row<L>(sb + ib * L, rb);
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const bool take_a = ia < na_t && (ib >= nb_t || !row_lt<L>(rb, ra));
#pragma unroll
    for (int l = 0; l < L; ++l) res[v][l] = take_a ? ra[l] : rb[l];
    ia += take_a;
    ib += !take_a;
    // the next row of the side taken (clamped: past its window's end that
    // side is not taken again)
    const int next = take_a ? min(ia, na_t - 1) : min(ib, nb_t - 1);
    uint32_t r[L];
    load_row<L>((take_a ? sa : sb) + max(next, 0) * L, r);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      ra[l] = take_a ? r[l] : ra[l];
      rb[l] = take_a ? rb[l] : r[l];
    }
  }
  __syncthreads();   // every thread has read its windows

  // 4. the merged tile back through shared memory, out coalesced
#pragma unroll
  for (int v = 0; v < kPerThread; ++v)
    if (v < cnt) {
#pragma unroll
      for (int l = 0; l < L; ++l) tile[(k0 + v) * L + l] = res[v][l];
    }
  __syncthreads();
  uint32_t* gout = out + d0 * L;
  if (W == 2) {
    uint2* g2 = reinterpret_cast<uint2*>(gout);
    const uint2* s2 = reinterpret_cast<const uint2*>(tile);
    for (int w = threadIdx.x; w < wn / 2; w += kThreads) g2[w] = s2[w];
  } else {
    for (int w = threadIdx.x; w < wn; w += kThreads) gout[w] = tile[w];
  }
}

}  // namespace
