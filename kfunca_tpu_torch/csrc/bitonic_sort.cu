// Stable per-row sort of (key, index) pairs (K10), for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   kfunca_tpu/ops/pallas_kernels/bitonic_sort.py: bitonic_sort_pairs
//   (body _sort_kernel), the engine of ops/sort.py under KFUNCA_PALLAS_SORT=1.
//
// Contract: keys (rows, n) fp32 or int32, row-major, n <= 8192.  Out: the
// keys of each row in ascending order and their int32 positions in the row,
// ordered by (key, index), so equal keys keep their order (the stable
// order).  Float keys: every NaN sorts after every number (ties by index),
// -0.0 and 0.0 tie; the keys written out are the input's own bits, read back
// through the sorted index, so a NaN's payload and a zero's sign survive.
//
// Design.  Each key becomes a 64-bit word (ordered key << 32 | index): the
// key's bits mapped to an unsigned integer with the same order (float:
// sign-magnitude flipped; NaN to the top, -0.0 to 0.0; int32: sign bit
// flipped), the index below it.  The word's unsigned order is the contract's
// order, and a pad cell (position >= n, up to the row's power of two P =
// next_pow2(max(n, 128))) gets the top key and its position as index, so it
// is greater than every real cell whatever that cell's key: a real NaN or
// INT32_MAX still sorts before the pads.  A block holds max(P, 1024) words in
// shared memory (8 KB; 64 KB for one row of 8192, set through
// cudaFuncSetAttribute): one row when P >= 1024, else 1024 / P rows, so
// that the 128-512 rows still give blocks of 512 threads.  The full bitonic
// network runs over the block's words, a compare-exchange per thread and
// pair each pass (several from P = 4096, where a pass has more pairs than a
// block has threads), __syncthreads() between passes; a pair never crosses
// a row, since its distance is at most P / 2.
//
// What bounds it.  The bytes are 12 an element (the key read, the key and
// the index written): 50.3 MB at (8192, 512), 0.015 ms at 3.35 TB/s.  The
// network does log2(P) (log2(P) + 1) / 2 passes of P / 2 compare-exchanges
// a row, each two 8-byte shared-memory reads and up to two writes: at
// (8192, 512) 45 passes x 256 pairs x 8192 rows = 94.4 M exchanges, ~3 GB of
// shared-memory traffic, ~0.09 ms at the card's ~33 TB/s of shared-memory
// bandwidth, and each pass waits at a barrier.  So the network's shared
// memory and its barriers bound this design, not device memory.  Left for
// later: the passes with d < 32 in registers through warp shuffles, or a
// segmented radix sort (the reference's own engine).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8192;
constexpr int kMinBlock = 1024;  // words a block holds at least
constexpr int kMaxThreads = 1024;

// The unsigned 32-bit image of a key with the contract's order.
__device__ __forceinline__ uint32_t ordered(uint32_t bits, bool is_float) {
  if (!is_float) return bits ^ 0x80000000u;
  if ((bits & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN: last
  if (bits == 0x80000000u) bits = 0u;                           // -0.0 = 0.0
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__global__ void __launch_bounds__(kMaxThreads) bitonic_rows_kernel(
    const uint32_t* __restrict__ keys, uint32_t* __restrict__ out_keys,
    int32_t* __restrict__ out_idx, long long rows, int n, int log2p,
    int rows_per_block, bool is_float) {
  extern __shared__ unsigned long long words[];
  const int p = 1 << log2p;
  const int e_total = rows_per_block << log2p;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  for (int e = threadIdx.x; e < e_total; e += blockDim.x) {
    const int r = e >> log2p, pos = e & (p - 1);
    const long long row = row0 + r;
    uint32_t key = 0xffffffffu;  // pad: the top key, its position as index
    if (pos < n && row < rows) key = ordered(keys[row * n + pos], is_float);
    words[e] = ((unsigned long long)key << 32) | (uint32_t)pos;
  }
  __syncthreads();
  const int pairs = e_total >> 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int lo = ((q & ~(d - 1)) << 1) | (q & (d - 1));
        const int hi = lo + d;
        // blocks of `size` alternate ascending / descending within the row;
        // the last merge (size == p) is ascending
        const bool ascending = ((lo & (p - 1)) & size) == 0;
        const unsigned long long a = words[lo], b = words[hi];
        if ((a > b) == ascending) {
          words[lo] = b;
          words[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < e_total; e += blockDim.x) {
    const int r = e >> log2p, pos = e & (p - 1);
    const long long row = row0 + r;
    if (pos < n && row < rows) {
      const int idx = (int)(uint32_t)words[e];
      out_idx[row * n + pos] = idx;
      out_keys[row * n + pos] = keys[row * n + idx];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  keys, out_keys: (rows, n) of
// 4-byte keys (is_float 1: fp32, 0: int32); out_idx: (rows, n) int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int kf_bitonic_sort_pairs(const void* keys, void* out_keys,
                                     void* out_idx, long long rows, int n,
                                     int is_float, void* stream) {
  if (rows <= 0 || n <= 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  int log2p = 7;  // rows pad to a power of two >= 128
  while ((1 << log2p) < n) ++log2p;
  const int p = 1 << log2p;
  const int e_total = p > kMinBlock ? p : kMinBlock;
  const int rows_per_block = e_total / p;
  const int threads = e_total / 2 < kMaxThreads ? e_total / 2 : kMaxThreads;
  const size_t smem = (size_t)e_total * sizeof(unsigned long long);
  cudaError_t e = cudaFuncSetAttribute(
      bitonic_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bitonic_rows_kernel<<<(unsigned)blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(out_keys),
      static_cast<int32_t*>(out_idx), rows, n, log2p, rows_per_block,
      is_float != 0);
  return (int)cudaGetLastError();
}
