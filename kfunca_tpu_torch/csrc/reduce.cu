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
// accumulator between them; on the card the blocks run at once, so the
// row walk moves inside the block:
//   * a block owns a strip of 32 columns: lane c of each warp reads column
//     c, so a warp's loads are one 128-byte line of a row;
//   * the block's 8 warps take rows w, w + 8, w + 16, ..., each thread
//     keeping its own accumulator (a running sum or max, or a Welford
//     triple n, mean, m2 updated one element at a time) and issuing
//     kUnroll independent loads before it uses them;
//   * the 8 partial results of a column meet in shared memory and are
//     merged in a fixed order (the Welford ones by Chan's formula), so the
//     result repeats bit for bit with no atomics.
// Raw sums of squares are never formed over a column: cancellation there
// is what Welford avoids.
// Left for later: splitting the rows of a narrow matrix across blocks (a
// matrix of few columns gets few blocks), and 16-byte loads.

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

// Chan et al.'s merge of two Welford partials (a <- a + b)
__device__ __forceinline__ void merge(float& n, float& mean, float& m2,
                                      float nb, float meanb, float m2b) {
  if (nb == 0.0f) return;
  if (n == 0.0f) {
    n = nb;
    mean = meanb;
    m2 = m2b;
    return;
  }
  const float tot = n + nb;
  const float delta = meanb - mean;
  mean = mean + delta * (nb / tot);
  m2 = m2 + m2b + delta * delta * (n * nb / tot);
  n = tot;
}

__global__ void __launch_bounds__(kCols * kWarps) welford_kernel(
    const float* __restrict__ x, float* __restrict__ mean_out,
    float* __restrict__ invstd_out, int rows, int cols) {
  __shared__ float part[3][kWarps][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (col < cols) {
    const float* p = x + col;
    long long r = warp;
    for (; r + (kUnroll - 1) * kWarps < rows; r += kUnroll * kWarps) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = p[(r + (long long)u * kWarps) * cols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        n += 1.0f;
        const float d = v[u] - mean;
        mean += d / n;
        m2 += d * (v[u] - mean);
      }
    }
    for (; r < rows; r += kWarps) {
      const float v = p[r * cols];
      n += 1.0f;
      const float d = v - mean;
      mean += d / n;
      m2 += d * (v - mean);
    }
  }
  part[0][warp][lane] = n;
  part[1][warp][lane] = mean;
  part[2][warp][lane] = m2;
  __syncthreads();
  if (warp == 0 && col < cols) {
    for (int w = 1; w < kWarps; ++w)
      merge(n, mean, m2, part[0][w][lane], part[1][w][lane], part[2][w][lane]);
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

extern "C" int kf_welford_norm_stat(const void* x, void* mean, void* invstd,
                                    int rows, int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kCols, kWarps);
  const dim3 grid((cols + kCols - 1) / kCols);
  welford_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(x),
                                        static_cast<float*>(mean),
                                        static_cast<float*>(invstd), rows, cols);
  return (int)cudaGetLastError();
}
