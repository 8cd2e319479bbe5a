// Sectioned CRC-32 of SST block rows.
//
// Replaces: src/repro/kernels/crc32.py `_crc32_kernel` (reached through
// `_raw_contrib` from `crc32_blocks` and `crc32_blocks_sections`).
//
// What it computes: for each block row, the CRC-32 of the little-endian
// serialization of the logical concatenation of up to five per-block
// sections (nvalid, keys, meta, vals, shared), bit-exact with
// `binascii.crc32`.  CRC-32 is affine over GF(2) (see tables.py), so the
// CRC is the XOR of the operator-table words T[p][b] of every set bit b of
// every word p, XOR the zero-message constant; no concatenated copy is
// made.
//
// Bound on the H100: HBM bytes.  The image is read once (4 bytes per
// word); the operator table (W x 32 words, 151,680 B at W = 1185) is shared
// by every block and stays in L2 and L1.
//
// Design: one thread block per SST block row (a later job dimension is
// blockIdx.y).  Threads stride over the row's words, so neighbouring
// threads read neighbouring words; each thread XORs the table words of its
// word's set bits (a `__ffs` loop, as many table reads as set bits), then
// the block reduces by warp shuffles and shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSections = 5;

struct Sections {
  const uint32_t* ptr[kMaxSections];
  int width[kMaxSections];
  int offset[kMaxSections];  // word offset of the section in the row
  int count;
};

__global__ void __launch_bounds__(kThreads)
crc32_sections_kernel(Sections s, const uint32_t* __restrict__ table,
                      uint32_t base, uint32_t* __restrict__ out) {
  const long long row = blockIdx.x;
  uint32_t acc = 0;
  for (int sec = 0; sec < s.count; ++sec) {
    const int w = s.width[sec];
    const uint32_t* __restrict__ p = s.ptr[sec] + row * w;
    const uint32_t* __restrict__ t = table + (size_t)s.offset[sec] * 32;
    for (int i = threadIdx.x; i < w; i += kThreads) {
      uint32_t x = p[i];
      const uint32_t* tw = t + (size_t)i * 32;
      while (x) {
        acc ^= __ldg(tw + (__ffs(x) - 1));
        x &= x - 1;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  __shared__ uint32_t warp_acc[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_acc[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[row] = acc ^ base;
  }
}

}  // namespace

// sections: `n_sections` (1..5) row-major uint32 arrays [n_rows, w_i];
// table: uint32 [sum(w_i), 32]; out: uint32 [n_rows].
REPRO_EXPORT int crc32_sections(const void* s0, const void* s1,
                                const void* s2, const void* s3,
                                const void* s4, int w0, int w1, int w2,
                                int w3, int w4, int n_sections,
                                const void* table, unsigned int base,
                                void* out, long long n_rows, void* stream) {
  if (n_sections < 1 || n_sections > kMaxSections) return cudaErrorInvalidValue;
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
  crc32_sections_kernel<<<(unsigned)n_rows, kThreads, 0, as_stream(stream)>>>(
      s, static_cast<const uint32_t*>(table), base,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
