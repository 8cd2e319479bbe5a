// Sectioned CRC-32 of SST block rows: a segmented byte-table CRC.
//
// Replaces: src/repro/kernels/crc32.py `_crc32_kernel` (reached through
// `_raw_contrib` from `crc32_blocks` and `crc32_blocks_sections`).
//
// What it computes: for each block row, the CRC-32 of the little-endian
// serialization of the logical concatenation of up to five per-block
// sections (nvalid, keys, meta, vals, shared), bit-exact with
// `binascii.crc32`.  No concatenated copy is made in device memory.
//
// Bound on the H100: HBM bytes, the image read once (4 bytes a word).  The
// work the function needs is one table step a byte.
//
// Design.  The first version XORed an operator-table word for every set
// bit of the image: ~16 dependent loads a word, in a divergent loop, from a
// 151,680-byte table that did not stay in L1 beside the working set (27 x
// its bound).  Here one warp owns one row at a time (eight warps a block,
// two blocks an SM, as many blocks as are resident at once, so each block
// fills its tables once and its warps walk the rows):
//   * the row comes to the warp's shared-memory buffer by `cp.async`, a
//     chunk of 32 * run words at a time, coalesced across the five section
//     pointers, into one of two buffers while the warp walks the other: the
//     load of the next row overlaps the table walk of this one.  (Trials on
//     the card: staging alone and the walk alone each took about two thirds
//     of the staged-then-walked time);
//   * the chunk is cut into 32 runs of `run` words, one a lane; a lane runs
//     the byte-table CRC register update over its run, one shared-memory
//     load a byte.  (Three runs a lane, as three independent chains,
//     measured slower: three runs a lane triple the shifts below and the
//     operator table.)  The 1 KB byte table is held 16 times over, entry e
//     of copy c at word 16 e + c, lane l reading copy l % 16, so the 32
//     lanes' lookups collide at most two to a bank whatever their bytes (a
//     single copy collides ~3.5-way on random bytes); `run` is odd, so the
//     lanes' reads of their runs fall in 32 banks;
//   * each run's CRC is moved to the row's end by the GF(2) "append n zero
//     bytes" operator of the bytes after the run (32 columns, read from
//     shared memory), and the warp XORs the 32 results by shuffles.
//     Rows longer than one chunk join chunks by the shift of one chunk.
// The byte table and the operators depend only on the row width; the
// host computes them once (tables.py `crc32_kernel_tables`), and
// `crc32_segmented` there walks this algorithm in numpy.  The affine
// zero-message constant is XORed in last.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSections = 5;
constexpr int kRuns = 32;                  // runs a chunk, one a lane
                                           // (CRC32_RUNS)
constexpr int kMaxRun = 39;                // words a run (CRC32_MAX_RUN)
constexpr int kSlots = 2 * kRuns + 2;      // shift operators (CRC32_SLOTS)
constexpr int kCopies = 16;                // copies of the byte table
constexpr int kFixedWords = 256 * kCopies + 32 * kSlots;

struct Sections {
  const uint32_t* ptr[kMaxSections];
  int width[kMaxSections];
  int offset[kMaxSections];  // word offset of the section in the row
  int count;
  int total;                 // words a row
};

__device__ __forceinline__ void cp_async4(uint32_t* dst,
                                          const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The shift operator of `slot` applied to x: XOR of the columns of x's set
// bits.  Columns of one slot are kSlots words apart, so lanes reading
// their own slots read consecutive words.
__device__ __forceinline__ uint32_t shift(const uint32_t* ops, int slot,
                                          uint32_t x) {
  uint32_t y = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    y ^= ops[j * kSlots + slot] & (0u - ((x >> j) & 1u));
  return y;
}

__global__ void __launch_bounds__(kThreads)
crc32_sections_kernel(Sections s, const uint32_t* __restrict__ tables,
                      int run, uint32_t base, uint32_t* __restrict__ out,
                      long long n_rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* t = smem;                          // [256][kCopies]
  uint32_t* ops = smem + 256 * kCopies;        // [32][kSlots]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = kRuns * run;
  uint32_t* bufs = smem + kFixedWords + warp * 2 * chunk;   // two buffers
  for (int k = threadIdx.x; k < 256 * kCopies / 4; k += kThreads) {
    const uint32_t e = __ldg(tables + k / (kCopies / 4));
    reinterpret_cast<uint4*>(t)[k] = make_uint4(e, e, e, e);
  }
  for (int k = threadIdx.x; k < 32 * kSlots; k += kThreads)
    ops[k] = __ldg(tables + 256 + k);
  __syncthreads();

  // the warp's work: items (row, chunk) in order, rows first + k * stride
  const int n_chunks = (s.total + chunk - 1) / chunk;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long n_items =
      first < n_rows ? ((n_rows - 1 - first) / stride + 1) * n_chunks : 0;
  // copy item k into buffer k % 2 (one commit group an item, empty past
  // the end, so the group count stays uniform)
  auto issue = [&](long long k) {
    if (k < n_items) {
      const long long row = first + (k / n_chunks) * stride;
      const int c0 = (int)(k % n_chunks) * chunk;
      const int width = min(chunk, s.total - c0);
      uint32_t* buf = bufs + (k & 1) * chunk;
#pragma unroll
      for (int sec = 0; sec < kMaxSections; ++sec) {   // static indices
        const int lo = max(s.offset[sec], c0);
        const int hi = min(s.offset[sec] + s.width[sec], c0 + width);
        if (sec < s.count && lo < hi) {
          const uint32_t* src =
              s.ptr[sec] + row * s.width[sec] + (lo - s.offset[sec]);
          for (int i = lane; i < hi - lo; i += 32)
            cp_async4(buf + (lo - c0) + i, src + i);
        }
      }
    }
    cp_async_commit();
  };

  const uint32_t* tl = t + (lane & (kCopies - 1));
  uint32_t acc = 0;
  issue(0);
  for (long long k = 0; k < n_items; ++k) {
    issue(k + 1);        // the next item lands while this one is walked
    cp_async_wait1();    // this lane's copies of item k landed
    __syncwarp();        // and the other lanes'
    const int c = (int)(k % n_chunks);
    const bool last = c == n_chunks - 1;
    const int width = last ? s.total - c * chunk : chunk;
    // this lane's run: words [lane * run, lane * run + n) of the chunk
    const int n = max(0, min(run, width - lane * run));
    const uint32_t* w = bufs + (k & 1) * chunk + lane * run;
    uint32_t r = 0;
    for (int i = 0; i < n; ++i) {
      r ^= w[i];
#pragma unroll
      for (int b = 0; b < 4; ++b) r = (r >> 8) ^ tl[(r & 0xFFu) * kCopies];
    }
    uint32_t part = shift(ops, lane + (last ? kRuns : 0), r);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part ^= __shfl_xor_sync(0xffffffffu, part, o);
    acc = (c == 0 ? 0u : shift(ops, 2 * kRuns + last, acc)) ^ part;
    if (last && lane == 0) out[first + (k / n_chunks) * stride] = acc ^ base;
    __syncwarp();        // buffer k % 2 is read before item k + 2 lands
  }
}

}  // namespace

// sections: `n_sections` (1..5) row-major uint32 arrays [n_rows, w_i];
// tables: uint32 [256 + 32 * 66] from tables.py `crc32_kernel_tables`
// for rows of sum(w_i) words, which also gives `run`; out: uint32 [n_rows].
REPRO_EXPORT int crc32_sections(const void* s0, const void* s1,
                                const void* s2, const void* s3,
                                const void* s4, int w0, int w1, int w2,
                                int w3, int w4, int n_sections,
                                const void* tables, int run,
                                unsigned int base, void* out,
                                long long n_rows, void* stream) {
  if (n_sections < 1 || n_sections > kMaxSections || run < 1 ||
      run > kMaxRun)
    return cudaErrorInvalidValue;
  if (n_rows <= 0) return cudaSuccess;
  Sections s;
  const void* ptrs[kMaxSections] = {s0, s1, s2, s3, s4};
  const int widths[kMaxSections] = {w0, w1, w2, w3, w4};
  int off = 0;
  for (int i = 0; i < kMaxSections; ++i) {
    const bool used = i < n_sections;
    s.ptr[i] = used ? static_cast<const uint32_t*>(ptrs[i]) : nullptr;
    s.width[i] = used ? widths[i] : 0;
    s.offset[i] = off;
    off += s.width[i];
  }
  s.count = n_sections;
  s.total = off;
  if (off < 1) return cudaErrorInvalidValue;
  const int smem = (kFixedWords + kWarps * 2 * kRuns * run) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      crc32_sections_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + kWarps - 1) / kWarps;
  const long long resident = 2LL * sm_count();
  const unsigned grid = (unsigned)(blocks < resident ? blocks : resident);
  crc32_sections_kernel<<<grid, kThreads, smem, as_stream(stream)>>>(
      s, static_cast<const uint32_t*>(tables), run, base,
      static_cast<uint32_t*>(out), n_rows);
  return (int)cudaGetLastError();
}

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
