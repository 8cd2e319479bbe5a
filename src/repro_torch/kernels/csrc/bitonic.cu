// Sort of uint32 rows, ascending lexicographically over all lanes
// (compaction phase 2 with sort_mode="device"): sorted tiles, then the
// merge tree over them.
//
// Replaces: src/repro/kernels/bitonic_sort.py `_bitonic_kernel` (reached
// from `bitonic_sort`), which runs `bitonic_network` on a VMEM-resident
// buffer of at most 2^17 rows.
//
// What it computes: the rows sorted ascending, words compared unsigned.
// The callers' last lane is a unique index, which makes the result equal
// to a stable sort on the key lanes; where rows repeat, every correct sort
// gives the same output.
//
// Bound on the H100: HBM bytes of reading and writing the rows once (a
// 262,144 x 6 sort moves 6 MB each way, all of it in the 50 MB L2 between
// launches).  At the store's sizes the launches are a few waves of blocks,
// so what the sort takes is its launches' chains of dependent steps.
//
// Design: one launch sorts every tile of T consecutive rows
// (`sort_tile_kernel`), then one launch a level of the pairwise merge tree
// over the n/T sorted tiles (`sort_level_kernel`, the merge path of
// `merge_path.cuh`; the host plans the levels with
// `merge_path.plan_levels`).  The tile sort reads `rows` directly (a short
// last tile reads only its rows; no padded copy) and writes buffer 0 of the
// merge, a scratch buffer; the stable merge of the sorted tiles is the
// sort.  A tile is one block's merge sort (CUB's block merge sort): each
// of kSortThreads threads sorts kRowsPerThread consecutive rows in
// registers (`lanes` is a template argument) by a bitonic network of four,
// then log2(T / 4) passes through shared memory merge runs of w rows into
// runs of 2w, each thread finding its own 4 output rows by a binary search
// of the merge path and merging them into registers, as a merge level
// does.  Rows sit in shared memory with one pad word after each thread's
// four, so that the threads of a warp, each storing its own rows, hit 32
// banks.  Rows past the end of a short tile are all-ones sentinels; they
// sort last and are not written.  T = 2,048 (512 threads of 4 rows) keeps
// every level of a 262,144-row sort in one launch (128 tiles, 64 pairs);
// on the H100 it beat 256 threads of 8 rows, 128 of 16 and T = 1,024 or
// 4,096 at 262,144 rows.  A bitonic network over the whole tile
// (compare-exchanges in registers, by `__shfl_xor_sync` inside a warp and
// through shared memory beyond) was slower: its O(T log^2 T)
// compare-exchanges outweigh the merge passes' searches.  So 65,536 rows
// take 1 + 5 launches and 262,144 rows 1 + 7 (the first version's bitonic
// network over the whole buffer: 28 and 45).  What a launch takes is one
// block's chain of dependent steps: nine passes of a search and a serial
// merge for the tile, a split search and a merge for each level.
//
// A batch of jobs (rows [jobs, n, lanes], each job sorted on its own) adds
// the job as the grid's y dimension of both launches: a tile never
// straddles two jobs (a job's last tile is short when the tile does not
// divide n), and the level kernels offset every buffer by the job's rows,
// so J jobs take the one job's launches.
//
// Rows of more than kMaxLanes words take the same two steps with `lanes` at
// run time: the tile sort with its rows in shared memory (one thread a
// pair, T chosen by the host so the tile fits), the merge levels one thread
// an output row (a binary search of the merge path in global memory).
#include "merge_path.cuh"

namespace {

constexpr int kSortThreads = 512;
constexpr int kRowsPerThread = 4;
constexpr int kSortTile = kSortThreads * kRowsPerThread;   // 2,048 rows
constexpr int kWideSmemBytes = 96 * 1024;   // a run-time-lanes tile at most
constexpr int kWideMaxTile = 2048;

// a and b ordered: ascending (a <= b) or descending
template <int L>
__device__ __forceinline__ void order_pair(uint32_t (&a)[L], uint32_t (&b)[L],
                                           bool asc) {
  const bool swap = asc ? row_lt<L>(b, a) : row_lt<L>(a, b);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint32_t x = a[l];
    a[l] = swap ? b[l] : x;
    b[l] = swap ? x : b[l];
  }
}

// Row i of a tile in shared memory: rows sit in groups of kRowsPerThread
// with one pad word after each group, so that the threads of a warp, each
// storing its own group, hit 32 banks.
template <int L>
__device__ __forceinline__ uint32_t* srow(uint32_t* sm, int i) {
  return sm + i * L + i / kRowsPerThread;
}

template <int L>
__device__ __forceinline__ void load_srow(const uint32_t* p,
                                          uint32_t (&r)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) r[l] = p[l];
}

// Tile blockIdx.x of job blockIdx.y (n rows a job): kSortTile rows sorted
// by one block of kSortThreads; `sm` holds kSortThreads * (kRowsPerThread
// * L + 1) words.
template <int L>
__device__ __forceinline__ void tile_sort_regs(const uint32_t* rows,
                                               long long n, uint32_t* out,
                                               uint32_t* sm) {
  constexpr int R = kRowsPerThread;
  constexpr int T = kSortTile;
  const long long first = (long long)blockIdx.x * T;
  const long long base = (long long)blockIdx.y * n + first;
  const int nt = (int)min((long long)T, n - first);
  const int t = threadIdx.x;
  // 1. the tile into shared memory, coalesced; all-ones sentinels past the
  //    end of a short tile (they sort last and are not written)
  const uint32_t* g = rows + base * L;
  for (int w = t; w < T * L; w += kSortThreads)
    srow<L>(sm, w / L)[w % L] = w < nt * L ? g[w] : ~0u;
  __syncthreads();

  // 2. each thread's R consecutive rows sorted in registers (a bitonic
  //    network of R)
  uint32_t x[R][L];
#pragma unroll
  for (int r = 0; r < R; ++r) load_srow<L>(srow<L>(sm, t * R + r), x[r]);
#pragma unroll
  for (int k = 2; k <= R; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if ((r & j) == 0) order_pair<L>(x[r], x[r | j], (r & k) == 0);

  // 3. merge passes: sorted runs of w rows become runs of 2w.  Each thread
  //    finds where its R output rows start by a binary search of the merge
  //    path in shared memory and merges them into registers
  for (int w = R; w < T; w <<= 1) {
    __syncthreads();   // every thread has read the last pass's rows
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int l = 0; l < L; ++l) srow<L>(sm, t * R + r)[l] = x[r][l];
    __syncthreads();
    const int k0 = t * R;
    const int pa = k0 & ~(2 * w - 1), pb = pa + w;   // the pair's two runs
    const int d = k0 - pa;
    int lo = max(0, d - w), hi = min(d, w);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (smem_row_lt<L>(srow<L>(sm, pb + d - 1 - mid), srow<L>(sm, pa + mid)))
        hi = mid;
      else
        lo = mid + 1;
    }
    int ia = lo, ib = d - lo;
    uint32_t ra[L], rb[L];
    load_srow<L>(srow<L>(sm, pa + min(ia, w - 1)), ra);
    load_srow<L>(srow<L>(sm, pb + min(ib, w - 1)), rb);
#pragma unroll
    for (int v = 0; v < R; ++v) {
      const bool take_a = ia < w && (ib >= w || !row_lt<L>(rb, ra));
#pragma unroll
      for (int l = 0; l < L; ++l) x[v][l] = take_a ? ra[l] : rb[l];
      ia += take_a;
      ib += !take_a;
      // the next row of the side taken (clamped: past its run's end that
      // side is not taken again)
      uint32_t nx[L];
      load_srow<L>(take_a ? srow<L>(sm, pa + min(ia, w - 1))
                          : srow<L>(sm, pb + min(ib, w - 1)), nx);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        ra[l] = take_a ? nx[l] : ra[l];
        rb[l] = take_a ? rb[l] : nx[l];
      }
    }
  }

  // 4. out through shared memory, coalesced
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int l = 0; l < L; ++l) srow<L>(sm, t * R + r)[l] = x[r][l];
  __syncthreads();
  uint32_t* o = out + base * L;
  for (int w = t; w < nt * L; w += kSortThreads) o[w] = srow<L>(sm, w / L)[w % L];
}

// Tile blockIdx.x of job blockIdx.y: `tile` rows of `lanes` words (run
// time) sorted in shared memory (`tile` * `lanes` words), tile / 2
// threads, one pair a stage.
__device__ __forceinline__ void tile_sort_wide(const uint32_t* rows,
                                               long long n, int lanes,
                                               int tile, uint32_t* out,
                                               uint32_t* sm) {
  const long long first = (long long)blockIdx.x * tile;
  const long long base = (long long)blockIdx.y * n + first;
  const int nt = (int)min((long long)tile, n - first);
  const uint32_t* g = rows + base * lanes;
  for (int w = threadIdx.x; w < tile * lanes; w += blockDim.x)
    sm[w] = w < nt * lanes ? g[w] : ~0u;
  __syncthreads();
  const int t = threadIdx.x;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = (t / j) * 2 * j + (t % j);
      uint32_t* a = sm + i * lanes;
      uint32_t* b = a + j * lanes;
      const bool asc = (i & k) == 0;
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
  uint32_t* o = out + base * lanes;
  for (int w = threadIdx.x; w < nt * lanes; w += blockDim.x) o[w] = sm[w];
}

// L > 0: L lanes, kSortThreads threads, kSortTile rows.  L = 0: `lanes`
// at run time, `tile` rows, tile / 2 threads.
template <int L>
__global__ void __launch_bounds__(L > 0 ? kSortThreads : kWideMaxTile / 2)
sort_tile_kernel(const uint32_t* __restrict__ rows, long long n, int lanes,
                 int tile, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t sm[];
  if constexpr (L > 0)
    tile_sort_regs<L>(rows, n, out, sm);
  else
    tile_sort_wide(rows, n, lanes, tile, out, sm);
}

// One output row a thread, kThreads a block (job blockIdx.y): its split
// by a binary search of the merge path in global memory, then the row
// taken.
__device__ __forceinline__ void merge_level_wide(const Level& lv,
                                                 int lanes) {
  const int t = blockIdx.x;
  const int p = pair_of_tile(lv, t);
  const long long off = (long long)blockIdx.y * lv.job_rows + lv.off[p];
  const long long na = lv.len_a[p], nb = lv.len_b[p];
  const uint32_t* a = lv.buf[lv.src_a[p]] + off * lanes;
  const uint32_t* b = lv.buf[lv.src_b[p]] + (off + na) * lanes;
  uint32_t* out = lv.buf[lv.dst[p]] + off * lanes;
  const long long d =
      (long long)(t - lv.first_tile[p]) * kThreads + threadIdx.x;
  if (d >= na + nb) return;
  long long lo = max(0LL, d - nb), hi = min(d, na);
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (row_less(b + (d - 1 - mid) * lanes, a + mid * lanes, lanes))
      hi = mid;
    else
      lo = mid + 1;
  }
  const long long ia = lo, ib = d - lo;
  const bool take_a =
      ia < na && (ib >= nb || !row_less(b + ib * lanes, a + ia * lanes,
                                        lanes));
  const uint32_t* src = take_a ? a + ia * lanes : b + ib * lanes;
  for (int l = 0; l < lanes; ++l) out[d * lanes + l] = src[l];
}

// L > 0: the merge path of `merge_path.cuh`; L = 0: `lanes` at run time.
template <int L>
__global__ void __launch_bounds__(kThreads)
sort_level_kernel(const __grid_constant__ Level lv, int lanes) {
  if constexpr (L > 0)
    merge_level<L>(lv);
  else
    merge_level_wide(lv, lanes);
}

template <int L>
int launch_tiles(const uint32_t* rows, long long n, int lanes, int tile,
                 int jobs, uint32_t* out, cudaStream_t s) {
  const size_t smem =
      L > 0 ? (size_t)kSortThreads * (kRowsPerThread * L + 1) *
                  sizeof(uint32_t)
            : (size_t)tile * lanes * sizeof(uint32_t);
  static size_t opted = 48 * 1024;   // the dynamic shared memory allowed
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        sort_tile_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const unsigned threads = L > 0 ? kSortThreads : (unsigned)(tile / 2);
  const dim3 grid((unsigned)((n + tile - 1) / tile), (unsigned)jobs);
  sort_tile_kernel<L><<<grid, threads, smem, s>>>(rows, n, lanes, tile, out);
  return (int)cudaGetLastError();
}

int launch_tiles_by_lanes(const uint32_t* rows, long long n, int lanes,
                          int tile, int jobs, uint32_t* out,
                          cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_tiles<1>(rows, n, lanes, tile, jobs, out, s);
    case 2: return launch_tiles<2>(rows, n, lanes, tile, jobs, out, s);
    case 3: return launch_tiles<3>(rows, n, lanes, tile, jobs, out, s);
    case 4: return launch_tiles<4>(rows, n, lanes, tile, jobs, out, s);
    case 5: return launch_tiles<5>(rows, n, lanes, tile, jobs, out, s);
    case 6: return launch_tiles<6>(rows, n, lanes, tile, jobs, out, s);
    case 7: return launch_tiles<7>(rows, n, lanes, tile, jobs, out, s);
    case 8: return launch_tiles<8>(rows, n, lanes, tile, jobs, out, s);
    default: return launch_tiles<0>(rows, n, lanes, tile, jobs, out, s);
  }
}

template <int L>
int launch_level(const Level& lv, dim3 grid, int lanes, cudaStream_t s) {
  sort_level_kernel<L><<<grid, kThreads, 0, s>>>(lv, lanes);
  return (int)cudaGetLastError();
}

int launch_level_by_lanes(const Level& lv, dim3 grid, int lanes,
                          cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_level<1>(lv, grid, lanes, s);
    case 2: return launch_level<2>(lv, grid, lanes, s);
    case 3: return launch_level<3>(lv, grid, lanes, s);
    case 4: return launch_level<4>(lv, grid, lanes, s);
    case 5: return launch_level<5>(lv, grid, lanes, s);
    case 6: return launch_level<6>(lv, grid, lanes, s);
    case 7: return launch_level<7>(lv, grid, lanes, s);
    case 8: return launch_level<8>(lv, grid, lanes, s);
    default: return launch_level<0>(lv, grid, lanes, s);
  }
}

}  // namespace

// rows: uint32 [jobs, n, lanes] on the card (n >= 1, jobs 1 to 65,535),
// each job sorted on its own, left as it is; buf0, buf1, buf2: uint32
// [jobs, n, lanes] scratch, 8-byte aligned (buf1 and buf2 may be null when
// no level names them); the pair tables are one job's.  The tiles of `tile_rows` rows land
// sorted in buf0; then level table i merges table_pairs[i] pairs, the
// next rows of `pairs` (int64 [*, 6] of (off, len_a, len_b, src_a, src_b,
// dst), buffers 0-2 as above; the wrapper's `merge_path.plan_levels` over
// the tiles), so the result is buf1 when there is a level, else buf0.
// tile_rows: kSortTile (the wrapper's TILE_ROWS) for lanes <= kMaxLanes;
// for more lanes a power of two from 2 to kWideMaxTile whose
// rows fit kWideSmemBytes.  launched: host int, set to the number of
// kernels enqueued.
REPRO_EXPORT int bitonic_sort(const void* rows, void* buf0, void* buf1,
                              void* buf2, long long n, int lanes,
                              int tile_rows, int jobs, int n_tables,
                              const int* table_pairs,
                              const long long* pairs, void* launched,
                              void* stream) {
  int* count = static_cast<int*>(launched);
  *count = 0;
  if (n < 1 || lanes < 1 || n_tables < 0 || buf0 == nullptr || jobs < 1 ||
      jobs > 65535)
    return cudaErrorInvalidValue;
  const uint32_t* r = static_cast<const uint32_t*>(rows);
  uint32_t* b0 = static_cast<uint32_t*>(buf0);
  cudaStream_t s = as_stream(stream);
  const bool fits =
      lanes <= kMaxLanes
          ? tile_rows == kSortTile
          : tile_rows >= 2 && tile_rows <= kWideMaxTile &&
                (tile_rows & (tile_rows - 1)) == 0 &&
                (long long)tile_rows * lanes * 4 <= kWideSmemBytes;
  if (!fits) return cudaErrorInvalidValue;
  int err = launch_tiles_by_lanes(r, n, lanes, tile_rows, jobs, b0, s);
  if (err != cudaSuccess) return err;
  ++*count;
  void* const bufs[3] = {buf0, buf1, buf2};
  const int rows_a_block = lanes <= kMaxLanes ? kTile : kThreads;
  for (int i = 0; i < n_tables; ++i) {
    Level lv;
    int tiles = 0;
    err = make_level(bufs, table_pairs[i], pairs, rows_a_block, n, lv,
                     &tiles);
    if (err != cudaSuccess) return err;
    pairs += 6 * table_pairs[i];
    err = launch_level_by_lanes(lv, dim3((unsigned)tiles, (unsigned)jobs),
                                lanes, s);
    if (err != cudaSuccess) return err;
    ++*count;
  }
  return cudaSuccess;
}
