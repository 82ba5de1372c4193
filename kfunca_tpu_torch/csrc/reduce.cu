// Column reductions of a row-major (R, C) matrix over its rows, for Hopper
// (sm_90a): sum / mean / max (K8) and Welford mean + invstd (K7).
//
// Replaces the TPU kernels
//   kfunca_tpu/ops/pallas_kernels/reduce.py: reduce_2d (body _reduce_kernel),
//   kfunca_tpu/ops/pallas_kernels/welford.py: welford_norm_stat (body
//   _welford_kernel, plus the XLA merge of its ragged tail rows).
//
// Contracts (the TPU kernels'):
//   reduce_2d:  out[0, c] = sum_r x[r, c] (mean: times float32(1 / R); max
//               starts from -3.4e38 and lets NaN through), fp32 accumulation
//               of fp32 / bf16 / fp16 input, stored in fp32 / bf16 / fp16.
//   welford:    mean[0, c] and invstd[0, c] = 1 / sqrt(m2 / R + 1e-12) of an
//               fp32 column, biased variance, fp32.  Every row is reduced
//               here, the ragged tail included (the TPU kernel leaves the
//               rows past its last whole block to XLA and merges them).
//
// What bounds them: HBM bytes.  At the 16387 x 16387 fp32 shape that
// norm_stat users run, the input is 1.07 GB and both kernels' floor is its
// read, 0.32 ms.  The TPU grid walks row tiles in order and carries the
// accumulator between them; on the card the blocks run at once.
//
// K8: a block owns a strip of 32 columns (lane c of each warp reads column
// c, one 128-byte line of a row); its 8 warps take rows w, w + 8, ..., each
// thread keeping its own running sum or max and issuing kUnroll independent
// loads before it uses them; the 8 partials of a column meet in shared
// memory and are merged in warp order.
//
// K7, a split-row reduction in two launches:
//   * welford_split_kernel: a block of 256 threads owns 256 contiguous
//     columns (thread t reads column c0 + t, so each row the block reads is
//     one contiguous 1 KB run), and blockIdx.y picks one of S row splits of
//     rps = ceil(R / S) rows.  S comes from the shape alone (the wrapper's
//     `split_count`: enough blocks for about four waves of 8 blocks an SM,
//     at most one split a kChunk rows), so the result repeats bit for bit.
//     The row pitch of the measured 16387-column shape (65,548 bytes) is not
//     a multiple of 16, so neither 16-byte loads nor TMA apply: the loads
//     are 4-byte and coalesced, and bandwidth comes from having many of
//     them in flight.  Each thread loads kChunk = 16 rows of its column
//     before it uses any, takes them relative to its running mean
//     (d = v - mean), forms the chunk's mean of d (times 1 / 16) and the
//     chunk's M2 as the sum of (d - chunk mean)^2 in registers, then folds
//     the chunk into its running (n, mean, M2) by Chan's formula: one divide
//     a chunk, not one an element.  Counts are integers, made float only
//     inside a merge.  The split writes its (mean, M2) to a workspace of
//     2 x S x C fp32 that the wrapper allocates; its count is
//     clamp(R - s * rps, 0, rps), known from the shape, so it is not
//     stored.  A split with no rows writes nothing.
//   * welford_merge_kernel: a block of 32 columns x 8 warps; warp w merges
//     the splits [w * per, (w + 1) * per) of its lane's column in split
//     order (per = ceil(S / 8), loads issued 8 at a time), then warp 0
//     merges the 8 results in warp order and writes mean and invstd.  No
//     atomics: a fixed order, bitwise repeatable.  An empty split (n = 0)
//     is the merge's identity.
// Raw sums of squares are never formed over a column: cancellation there
// is what Welford avoids.
// Left for later (K8): the same split-row layout for sum / mean / max.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns per block (one per lane)
constexpr int kWarps = 8;  // row groups per block
constexpr int kUnroll = 8;

enum ReduceOp { kSum = 0, kMean = 1, kMax = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ float combine(int op, float acc, float x) {
  if (op == kMax) return (x != x || x > acc) ? x : acc;  // NaN sticks
  return acc + x;
}

template <typename T, typename TOut>
__global__ void __launch_bounds__(kCols * kWarps) reduce_2d_kernel(
    const T* __restrict__ x, TOut* __restrict__ out, int rows, int cols,
    int op, float scale) {
  __shared__ float part[kWarps][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const float init = op == kMax ? -3.4e38f : 0.0f;
  float acc = init;
  if (col < cols) {
    const T* p = x + col;
    long long r = warp;
    for (; r + (kUnroll - 1) * kWarps < rows; r += kUnroll * kWarps) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = to_f(p[(r + (long long)u * kWarps) * cols]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = combine(op, acc, v[u]);
    }
    for (; r < rows; r += kWarps) acc = combine(op, acc, to_f(p[r * cols]));
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < cols) {
    float r = part[0][lane];
    for (int w = 1; w < kWarps; ++w) r = combine(op, r, part[w][lane]);
    if (op == kMean) r *= scale;
    put(out + col, r);
  }
}

// Chan et al.'s update of a (count, mean, M2) partial by nb more values
// whose mean lies `delta` above the partial's and whose M2 is m2b.  The
// counts stay integers, made float only here.  From n = 0 and mean = 0 it
// gives (nb, delta, m2b) exactly.
__device__ __forceinline__ void chan_fold(int& n, float& mean, float& m2,
                                          int nb, float delta, float m2b) {
  const int tot = n + nb;
  const float f = (float)nb / (float)tot;
  mean = fmaf(delta, f, mean);
  m2 = m2 + m2b + delta * delta * ((float)n * f);
  n = tot;
}

// Chan's merge of two partials (a <- a + b); nb == 0 is the identity.
__device__ __forceinline__ void chan_merge(int& n, float& mean, float& m2,
                                           int nb, float meanb, float m2b) {
  if (nb != 0) chan_fold(n, mean, m2, nb, meanb - mean, m2b);
}

constexpr int kWelfordThreads = 256;  // columns per split block
constexpr int kChunk = 16;            // rows a thread loads before using them

__global__ void __launch_bounds__(kWelfordThreads) welford_split_kernel(
    const float* __restrict__ x, float* __restrict__ ws, int rows, int cols,
    int rps) {
  const int col = blockIdx.x * kWelfordThreads + threadIdx.x;
  const long long first = (long long)blockIdx.y * rps;
  if (col >= cols || first >= rows) return;  // past the matrix, or an empty split
  const int r0 = (int)first;
  const int r1 = (int)min((long long)rows, first + rps);
  const size_t pitch = (size_t)cols;
  const float* p = x + (size_t)r0 * pitch + col;
  int n = 0;
  float mean = 0.0f, m2 = 0.0f;
  int r = r0;
  for (; r + kChunk <= r1; r += kChunk, p += kChunk * pitch) {
    float d[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) d[u] = __ldg(p + u * pitch);
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      d[u] -= mean;
      s += d[u];
    }
    const float md = s * (1.0f / kChunk);
    float m2c = 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float e = d[u] - md;
      m2c = fmaf(e, e, m2c);
    }
    // the chunk was taken relative to the running mean, so md is Chan's
    // delta, free of the cancellation of (chunk mean - running mean)
    chan_fold(n, mean, m2, kChunk, md, m2c);
  }
  if (r < r1) {  // the split's last rows, fewer than kChunk
    const int u_n = r1 - r;
    float d[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) d[u] = u < u_n ? __ldg(p + u * pitch) : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      d[u] = u < u_n ? d[u] - mean : 0.0f;
      s += d[u];
    }
    const float md = s / (float)u_n;
    float m2c = 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float e = u < u_n ? d[u] - md : 0.0f;
      m2c = fmaf(e, e, m2c);
    }
    chan_fold(n, mean, m2, u_n, md, m2c);
  }
  const size_t plane = (size_t)gridDim.y * pitch;
  ws[blockIdx.y * pitch + col] = mean;
  ws[plane + blockIdx.y * pitch + col] = m2;
}

constexpr int kMergeLoads = 8;  // partials a thread loads before merging

__global__ void __launch_bounds__(kCols * kWarps) welford_merge_kernel(
    const float* __restrict__ ws, float* __restrict__ mean_out,
    float* __restrict__ invstd_out, int rows, int cols, int splits, int rps) {
  __shared__ float part_mean[kWarps][kCols], part_m2[kWarps][kCols];
  __shared__ int part_n[kWarps][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const int per = (splits + kWarps - 1) / kWarps;
  const int s_end = min(splits, (warp + 1) * per);
  const size_t pitch = (size_t)cols;
  const size_t plane = (size_t)splits * pitch;
  int n = 0;
  float mean = 0.0f, m2 = 0.0f;
  if (col < cols) {
    for (int s0 = warp * per; s0 < s_end; s0 += kMergeLoads) {
      float mb[kMergeLoads], m2b[kMergeLoads];
      int nb[kMergeLoads];
#pragma unroll
      for (int i = 0; i < kMergeLoads; ++i) {
        const int s = s0 + i;
        nb[i] = s < s_end ? (int)max(0LL, min((long long)rps, rows - (long long)s * rps)) : 0;
        mb[i] = nb[i] ? ws[s * pitch + col] : 0.0f;
        m2b[i] = nb[i] ? ws[plane + s * pitch + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kMergeLoads; ++i) chan_merge(n, mean, m2, nb[i], mb[i], m2b[i]);
    }
  }
  part_n[warp][lane] = n;
  part_mean[warp][lane] = mean;
  part_m2[warp][lane] = m2;
  __syncthreads();
  if (warp == 0 && col < cols) {
    for (int w = 1; w < kWarps; ++w)
      chan_merge(n, mean, m2, part_n[w][lane], part_mean[w][lane], part_m2[w][lane]);
    mean_out[col] = mean;
    invstd_out[col] = 1.0f / sqrtf(m2 / (float)rows + 1e-12f);
  }
}

template <typename T, typename TOut>
int launch_reduce(const void* x, void* out, int rows, int cols, int op,
                  float scale, cudaStream_t stream) {
  const dim3 block(kCols, kWarps);
  const dim3 grid((cols + kCols - 1) / kCols);
  reduce_2d_kernel<T, TOut><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<TOut*>(out), rows, cols, op, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int reduce_to(const void* x, void* out, int out_code, int rows, int cols,
              int op, float scale, cudaStream_t s) {
  switch (out_code) {
    case 6: return launch_reduce<T, __half>(x, out, rows, cols, op, scale, s);
    case 7: return launch_reduce<T, __nv_bfloat16>(x, out, rows, cols, op, scale, s);
    case 8: return launch_reduce<T, float>(x, out, rows, cols, op, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes); dtype codes as in
// kfunca_tpu_torch/core/dtype.py (6 fp16, 7 bf16, 8 fp32).  x is a
// row-major (rows, cols) matrix, out / mean / invstd hold cols values.
// op: 0 sum, 1 mean (times `scale`), 2 max.  Return cudaGetLastError()
// after the launch (0 on success).
extern "C" int kf_reduce_2d(const void* x, int in_code, void* out, int out_code,
                            int rows, int cols, int op, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || op < 0 || op > 2) return (int)cudaErrorInvalidValue;
  switch (in_code) {
    case 6: return reduce_to<__half>(x, out, out_code, rows, cols, op, scale, s);
    case 7: return reduce_to<__nv_bfloat16>(x, out, out_code, rows, cols, op, scale, s);
    case 8: return reduce_to<float>(x, out, out_code, rows, cols, op, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x: (rows, cols) fp32; mean, invstd: cols fp32 each; ws: a workspace of
// 2 x splits x cols fp32 (the split partials' means, then their M2), which
// the caller allocates.  Two launches, split then merge.
extern "C" int kf_welford_norm_stat(const void* x, void* mean, void* invstd,
                                    void* ws, int rows, int cols, int splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int rps = (int)(((long long)rows + splits - 1) / splits);
  const dim3 grid((cols + kWelfordThreads - 1) / kWelfordThreads, splits);
  welford_split_kernel<<<grid, kWelfordThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(ws), rows, cols, rps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  welford_merge_kernel<<<(cols + kCols - 1) / kCols, dim3(kCols, kWarps), 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(mean),
      static_cast<float*>(invstd), rows, cols, splits, rps);
  return (int)cudaGetLastError();
}
