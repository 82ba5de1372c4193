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
// Words.  Each key becomes a 64-bit word (ordered key << 32 | index): the
// key's bits mapped to an unsigned integer with the same order (float:
// sign-magnitude flipped; NaN to the top, -0.0 to 0.0; int32: sign bit
// flipped), the index below it.  The word's unsigned order is the contract's
// order, and a pad cell (position >= n, up to the row's power of two P =
// next_pow2(max(n, 128))) gets the top key and its position as index, so it
// is greater than every real cell whatever that cell's key: a real NaN or
// INT32_MAX still sorts before the pads.  Words are unique within a row, so
// every compare-exchange is a min and a max.
//
// Layout.  Thread t of a row holds its row's words t * kE .. t * kE + kE - 1
// in registers (kE = 8).  A block has max(1024, P) / kE threads: one row
// when P >= 1024, else 1024 / P rows (a row of 128 spans 16 lanes, so two
// rows share a warp).  Rows start at multiples of P / kE threads, so a partner at
// position pos ^ d (d < P) is thread t ^ (d / kE) of the same row.
//
// The network.  For each merge size (2 .. P) and each pair distance d
// (size / 2 .. 1), by where the pair lives:
//   * d < kE: both words in one thread's registers; no shuffle, no barrier;
//   * kE <= d < 32 kE: the partner is lane ^ (d / kE) of the same warp; each
//     lane gets its partner's word by __shfl_xor_sync and keeps the min or
//     the max, by whether it holds the lower position and by the direction;
//   * d >= 32 kE: the same exchange through shared memory between two
//     barriers (at P = 1024, 3 of the 55 passes; at P = 8192, 15 of 91).
// Blocks of `size` alternate ascending and descending within the row (the
// direction of a position is whether its `size` bit is clear), so the last
// merge (size = P) is ascending.  Shared memory holds word j of thread t at
// j * (threads + kPad) + t: a warp's stores and loads of one j are
// consecutive words (no bank conflict), and so are the coalesced load and
// store phases, which go through the same layout (linear position e is word
// e % kE of thread e / kE; the pad of 16 / kE words a j puts the words of
// 16 consecutive positions on distinct banks).
//
// What bounds it.  The bytes are 12 an element (the key read, the key and
// the index written): 0.030 ms at (8192, 1024) at 3.35 TB/s.  The network
// does log2(P) (log2(P) + 1) / 2 passes of P / 2 compare-exchanges a row;
// with the words in registers each costs a 64-bit compare and selects (and
// two 32-bit shuffles a word in a shuffle pass): about 290 instructions a
// word at P = 1024, 0.07 ms at (8192, 1024) at four a clock on 132 SMs.  So
// the issue of the compare/select arithmetic and the latency between
// dependent passes, not memory, bound this design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8192;
constexpr int kE = 8;                // words a thread holds
constexpr int kMinWords = 1024;      // words a block holds at least
constexpr int kShflSpan = 32 * kE;   // pair distances a warp reaches
constexpr int kPad = 16 / kE;        // shared-memory words between two j's

// The unsigned 32-bit image of a key with the contract's order.
__device__ __forceinline__ uint32_t ordered(uint32_t bits, bool is_float) {
  if (!is_float) return bits ^ 0x80000000u;
  if ((bits & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN: last
  if (bits == 0x80000000u) bits = 0u;                           // -0.0 = 0.0
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

typedef unsigned long long word_t;

// Keep the min of (mine, other) if keep_min, else the max.
__device__ __forceinline__ word_t keep(word_t mine, word_t other, bool keep_min) {
  return ((other < mine) == keep_min) ? other : mine;
}

// The pairs at distance D < kE, within each thread's registers; `base` is
// the row position of the thread's first word.
template <int D>
__device__ __forceinline__ void register_pass(word_t (&w)[kE], int base, int size) {
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    if (j & D) continue;
    const bool ascending = ((base + j) & size) == 0;
    const word_t a = w[j], b = w[j + D];
    const bool swap = (a > b) == ascending;
    w[j] = swap ? b : a;
    w[j + D] = swap ? a : b;
  }
}

// The register passes of one merge size: D = kE / 2, ..., 1, those below it.
template <int D>
__device__ __forceinline__ void register_passes(word_t (&w)[kE], int base, int size) {
  if (size >= 2 * D) register_pass<D>(w, base, size);
  if constexpr (D > 1) register_passes<D / 2>(w, base, size);
}

__global__ void __launch_bounds__(kMaxN / kE) bitonic_rows_kernel(
    const uint32_t* __restrict__ keys, uint32_t* __restrict__ out_keys,
    int32_t* __restrict__ out_idx, long long rows, int n, int log2p,
    bool is_float) {
  extern __shared__ word_t smem[];
  const int p = 1 << log2p;
  const int threads = blockDim.x;
  const int stride = threads + kPad;  // words from one j to the next
  const int tid = threadIdx.x;
  const int t_row = tid & ((p / kE) - 1);  // this thread within its row
  const int base = t_row * kE;
  const int block_words = threads * kE;
  const long long row0 = (long long)blockIdx.x * (block_words >> log2p);

  // load: coalesced from device memory into shared memory, then kE words a
  // thread into registers
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int e = k * threads + tid;
    const int pos = e & (p - 1);
    const long long row = row0 + (e >> log2p);
    uint32_t key = 0xffffffffu;  // pad: the top key, its position as index
    if (pos < n && row < rows) key = ordered(keys[row * n + pos], is_float);
    smem[(e & (kE - 1)) * stride + (e / kE)] = ((word_t)key << 32) | (uint32_t)pos;
  }
  __syncthreads();
  word_t w[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) w[j] = smem[j * stride + tid];

  for (int size = 2; size <= p; size <<= 1) {
    int d = size >> 1;
    // the direction of every word of a thread once size > kE
    const bool ascending = (base & size) == 0;
    for (; d >= kShflSpan; d >>= 1) {
      const int m = d / kE;
      const bool keep_min = ((t_row & m) == 0) == ascending;
      __syncthreads();  // the last reads of shared memory are done
#pragma unroll
      for (int j = 0; j < kE; ++j) smem[j * stride + tid] = w[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kE; ++j) w[j] = keep(w[j], smem[j * stride + (tid ^ m)], keep_min);
    }
    for (; d >= kE; d >>= 1) {
      const int m = d / kE;
      const bool keep_min = ((t_row & m) == 0) == ascending;
#pragma unroll
      for (int j = 0; j < kE; ++j)
        w[j] = keep(w[j], __shfl_xor_sync(0xffffffffu, w[j], m), keep_min);
    }
    register_passes<kE / 2>(w, base, size);
  }

  // store: back through shared memory, then coalesced; the keys are read
  // again through the sorted index, so each keeps its own bits
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kE; ++j) smem[j * stride + tid] = w[j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int e = k * threads + tid;
    const int pos = e & (p - 1);
    const long long row = row0 + (e >> log2p);
    if (pos < n && row < rows) {
      const int idx = (int)(uint32_t)smem[(e & (kE - 1)) * stride + (e / kE)];
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
  const int threads = (p > kMinWords ? p : kMinWords) / kE;
  const int rows_per_block = threads * kE / p;
  const size_t smem = (size_t)kE * (threads + kPad) * sizeof(word_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitonic_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bitonic_rows_kernel<<<(unsigned)blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(out_keys),
      static_cast<int32_t*>(out_idx), rows, n, log2p, is_float != 0);
  return (int)cudaGetLastError();
}
