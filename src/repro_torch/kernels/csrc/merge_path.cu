// Merge-path merge of sorted runs of uint32 rows (phase 2), one launch per
// level of the pairwise merge tree.
//
// Replaces: src/repro/kernels/merge_path.py:87 `_merge_kernel` together with
// its XLA-side `_partition` :64 (reached from `merge_sorted` and
// `merge_runs` :138).
//
// What it computes: every pair of one tree level (the pair table, planned
// on the host by `merge_path.plan_levels`) merged into its output rows.
// Rows are sorted lexicographically over all `lanes` words, compared
// unsigned, and ties go to the left, earlier run, so the tree's result is
// a stable merge, the one output of `ref.merge_runs`.  A run keeps its rows
// at every level; the table names for each operand and output which of
// the three buffers (input, two scratch) holds it, so a run carried up a
// level is read in place, never copied.
//
// Bound on the H100: bytes.  Each level reads and writes every row once
// (1.57 MB each way for 65,536 rows of 6 lanes, all of it in the 50 MB L2),
// and the comparisons are a few operations a row.  At the store's sizes a
// level is one wave of blocks, so what a level takes is the chain of
// dependent steps of one block, not the bytes.
//
// Design: all pairs of a level in one launch, one block for each tile of
// kTile output rows of one pair (and, for a batch of jobs, of one job: the
// grid's y dimension), by the merge path of `merge_path.cuh`
// (shared with the device sort's merge levels in `bitonic.cu`).  The two
// searches (the split in global memory, each thread's in shared memory)
// take more of a block's chain than moving the rows does.
#include "merge_path.cuh"

namespace {

template <int L>
__global__ void __launch_bounds__(kThreads)
merge_level_kernel(const __grid_constant__ Level lv) {
  merge_level<L>(lv);
}

template <int L>
int launch_level(const Level& lv, dim3 grid, cudaStream_t stream) {
  merge_level_kernel<L><<<grid, kThreads, 0, stream>>>(lv);
  return (int)cudaGetLastError();
}

}  // namespace

// One level of the merge tree (or up to kMaxPairs of its pairs), for each
// of `jobs` jobs of `job_rows` rows stored back to back.
// rows, buf1, buf2: uint32 [jobs * job_rows, lanes] on the card, 8-byte
// aligned (buf2 may be null when no pair names it); pairs: host int64
// [n_pairs, 6] of (off, len_a, len_b, src_a, src_b, dst) inside one job,
// buffers numbered as in `Level::buf`; tile_rows must equal kTile (the
// wrapper's TILE_ROWS); jobs: 1 to 65,535 (the grid's y dimension).
REPRO_EXPORT int merge_runs(const void* rows, void* buf1, void* buf2,
                            int lanes, int n_pairs, const long long* pairs,
                            int tile_rows, int jobs, long long job_rows,
                            void* stream) {
  if (tile_rows != kTile || lanes < 1 || lanes > kMaxLanes || jobs < 1 ||
      jobs > 65535)
    return cudaErrorInvalidValue;
  void* const bufs[3] = {const_cast<void*>(rows), buf1, buf2};
  Level lv;
  int tiles = 0;
  const int err =
      make_level(bufs, n_pairs, pairs, kTile, job_rows, lv, &tiles);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles, (unsigned)jobs);
  cudaStream_t s = as_stream(stream);
  switch (lanes) {
    case 1: return launch_level<1>(lv, grid, s);
    case 2: return launch_level<2>(lv, grid, s);
    case 3: return launch_level<3>(lv, grid, s);
    case 4: return launch_level<4>(lv, grid, s);
    case 5: return launch_level<5>(lv, grid, s);
    case 6: return launch_level<6>(lv, grid, s);
    case 7: return launch_level<7>(lv, grid, s);
    default: return launch_level<8>(lv, grid, s);
  }
}
