// int8 x int8 matmul with exact int32 accumulation and a fused rank-1
// dequantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   kfunca_tpu/ops/quant.py: matmul_q8 (body _q8_kernel).
//
// Contract (the same as the TPU kernel's):
//   a (m, k) int8 row-major, b (k, n) int8 row-major,
//   a_scale (m,) fp32, b_scale (n,) fp32
//   out[i, j] = (float(acc[i, j]) * a_scale[i]) * b_scale[j]   fp32 or bf16
// with acc the exact int32 sum over k (the caller checks k * 127^2 < 2^31).
// Any m, k, n: ragged edges are masked here, nothing is padded on the host.
//
// What bounds it: HBM bytes.  Its caller is weight-quantized decode:
// m = 8 activation rows against weights of 4096 x 4096 up to 4096 x 32000,
// about 2 operations per weight byte, far under what the card needs before
// arithmetic matters.  So the design streams b exactly once with whole
// 128-byte lines and keeps everything else on chip:
//   * a block owns 8 rows of a and 128 columns of b.  The 8 rows of a sit
//     in shared memory (a chunk of k at a time), packed four k values to a
//     32-bit word;
//   * a thread owns 4 adjacent columns: one 32-bit load fetches them from
//     one row of b, and a warp's 32 loads cover one 128-byte line.  The 8
//     warps of a block split k between them, four rows at a time, with
//     several such groups of loads in flight per thread;
//   * __dp4a wants four k values of ONE column in a register, while b is
//     row-major in n: the four words of a 4 x 4 byte block are transposed
//     in registers with __byte_perm, then 8 rows x 4 columns of __dp4a
//     follow against words of a that the whole warp reads from one shared
//     address (a broadcast);
//   * the 8 warps' partial sums meet in shared memory.  Integer sums are
//     exact in any order, so the result is bitwise repeatable;
//   * a skinny product has too few (row, column) tiles to fill 132 SMs, so
//     the grid's third dimension splits k across blocks.  Their partial
//     int32 tiles go to a scratch buffer and a second small kernel adds
//     them and applies the scales (again exact, in a fixed order).
// Left for later: tensor cores (mma/wgmma s8), which large m needs, and
// cp.async/TMA staging of b.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;      // rows of a per block
constexpr int kCols = 128;    // columns of b per block (4 per lane)
constexpr int kChunk = 1024;  // k values of a held in shared memory at a time
constexpr int kUnroll = 4;    // 4-row groups a thread loads before it computes

__device__ __forceinline__ void store_out(float* out, long long i, float x) {
  out[i] = x;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long i,
                                          float x) {
  out[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn((float)acc, sa), sb);
}

// The 4 columns [col, col + 4) of row kk of b as one word; out-of-range
// rows and columns read as 0.  `vec` says that n % 4 == 0 and b is 4-byte
// aligned, so that the word is one aligned load.
__device__ __forceinline__ uint32_t load_b(const int8_t* __restrict__ b,
                                           int kk, int col, int k, int n,
                                           bool vec) {
  if (kk >= k || col >= n) return 0u;
  const int8_t* src = b + (long long)kk * n + col;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t w = 0u;
  for (int c = 0; c < 4; ++c)
    if (col + c < n) w |= (uint32_t)(uint8_t)src[c] << (8 * c);
  return w;
}

// grid (ceil(n / 128), ceil(m / 8), split), block 256.
// Shared memory: one buffer, first the chunk of a (8 x kChunk bytes), then,
// once the k loop is over, the warps' partial sums (8 warps x 8 x 128 int32).
template <typename TOut>
__global__ void __launch_bounds__(kThreads) matmul_q8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const float* __restrict__ a_scale, const float* __restrict__ b_scale,
    TOut* __restrict__ out, int* __restrict__ partial, int m, int k, int n,
    int k_per_split, bool vec, bool a_vec) {
  __shared__ __align__(16) int smem[kWarps * kRows * kCols];  // 32 KB
  uint32_t* a_s = reinterpret_cast<uint32_t*>(smem);  // [kRows][kChunk / 4]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = blockIdx.x * kCols + lane * 4;
  const int row0 = blockIdx.y * kRows;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);

  int acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    // the chunk of a: word w of row i packs a[row0 + i, kc + 4w .. + 3];
    // rows past m and k values past k_end are 0
    for (int idx = tid; idx < kRows * (kChunk / 4); idx += kThreads) {
      const int i = idx / (kChunk / 4);
      const int w = idx - i * (kChunk / 4);
      uint32_t word = 0u;
      if (row0 + i < m) {
        const int8_t* src = a + (long long)(row0 + i) * k;
        const int kk = kc + 4 * w;
        if (a_vec && kk + 3 < k_end) {  // one aligned word (k % 4 == 0)
          word = __ldg(reinterpret_cast<const uint32_t*>(src + kk));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (kk + c < k_end)
              word |= (uint32_t)(uint8_t)src[kk + c] << (8 * c);
        }
      }
      a_s[idx] = word;
    }
    __syncthreads();

    // warp `warp` takes the 4-row groups warp, warp + 8, ... of the chunk
    const int groups = (min(kChunk, k_end - kc) + 3) / 4;
    for (int g0 = warp; g0 < groups; g0 += kWarps * kUnroll) {
      uint32_t r[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int g = g0 + u * kWarps;
        const int kk = kc + 4 * g;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[u][j] = (g < groups && kk + j < k_end)
                        ? load_b(b, kk + j, col, k, n, vec) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int g = g0 + u * kWarps;
        if (g >= groups) break;
        // 4 x 4 byte transpose: c[j] = column j's four k values
        const uint32_t t0 = __byte_perm(r[u][0], r[u][1], 0x5140);
        const uint32_t t1 = __byte_perm(r[u][2], r[u][3], 0x5140);
        const uint32_t t2 = __byte_perm(r[u][0], r[u][1], 0x7362);
        const uint32_t t3 = __byte_perm(r[u][2], r[u][3], 0x7362);
        const int c0 = (int)__byte_perm(t0, t1, 0x5410);
        const int c1 = (int)__byte_perm(t0, t1, 0x7632);
        const int c2 = (int)__byte_perm(t2, t3, 0x5410);
        const int c3 = (int)__byte_perm(t2, t3, 0x7632);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int aw = (int)a_s[i * (kChunk / 4) + g];
          acc[i][0] = __dp4a(aw, c0, acc[i][0]);
          acc[i][1] = __dp4a(aw, c1, acc[i][1]);
          acc[i][2] = __dp4a(aw, c2, acc[i][2]);
          acc[i][3] = __dp4a(aw, c3, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

  // the warps' partial sums meet in shared memory: red[warp][row][column]
  int* red = smem;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    *reinterpret_cast<int4*>(red + (warp * kRows + i) * kCols + lane * 4) =
        make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int idx = tid; idx < kRows * kCols; idx += kThreads) {
    const int i = idx / kCols;
    const int c = idx - i * kCols;
    const int gi = row0 + i;
    const int gj = blockIdx.x * kCols + c;
    if (gi >= m || gj >= n) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + i) * kCols + c];
    const long long o = (long long)gi * n + gj;
    if (partial != nullptr)
      partial[(long long)blockIdx.z * m * n + o] = sum;
    else
      store_out(out, o, dequant(sum, a_scale[gi], b_scale[gj]));
  }
}

// Adds the `split` partial tiles of every output element and dequantizes.
template <typename TOut>
__global__ void __launch_bounds__(kThreads) reduce_q8_kernel(
    const int* __restrict__ partial, const float* __restrict__ a_scale,
    const float* __restrict__ b_scale, TOut* __restrict__ out, int m, int n,
    int split) {
  const long long total = (long long)m * n;
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < total;
       o += (long long)gridDim.x * kThreads) {
    int sum = 0;
    for (int z = 0; z < split; ++z) sum += partial[z * total + o];
    store_out(out, o, dequant(sum, a_scale[o / n], b_scale[o % n]));
  }
}

template <typename TOut>
int launch(const int8_t* a, const int8_t* b, const float* a_scale,
           const float* b_scale, void* out, int* partial, int m, int k, int n,
           int split, cudaStream_t stream) {
  if (split < 1 || (split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  // every split but the last covers a whole number of 4-row groups
  int k_per_split = (k + split - 1) / split;
  k_per_split = (k_per_split + 3) / 4 * 4;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  const bool a_vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows, split);
  matmul_q8_kernel<TOut><<<grid, kThreads, 0, stream>>>(
      a, b, a_scale, b_scale, static_cast<TOut*>(out),
      split > 1 ? partial : nullptr, m, k, n, k_per_split, vec, a_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  const long long total = (long long)m * n;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = want < 4096 ? (int)want : 4096;
  reduce_q8_kernel<TOut><<<blocks, kThreads, 0, stream>>>(
      partial, a_scale, b_scale, static_cast<TOut*>(out), m, n, split);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  out_dtype: 0 = float32,
// 1 = bfloat16.  `partial` is a caller-allocated (split, m, n) int32 scratch
// buffer, needed when split > 1.  Returns cudaGetLastError() after the
// launches (0 on success).  The caller checks shapes, dtypes, contiguity
// and that k cannot overflow the int32 accumulator.
extern "C" int kf_matmul_q8(const void* a, const void* b, const void* a_scale,
                            const void* b_scale, void* out, void* partial,
                            int m, int k, int n, int split, int out_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  int* pp = static_cast<int*>(partial);
  if (out_dtype == 0)
    return launch<float>(ap, bp, sa, sb, out, pp, m, k, n, split, s);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(ap, bp, sa, sb, out, pp, m, k, n, split, s);
  return (int)cudaErrorInvalidValue;
}
