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
// Both are split-row reductions in two launches, on one layout:
//   * a split kernel: a block of kSplitThreads = 256 threads owns 256
//     contiguous columns (K8 with 16-bit input in pairs: 512) of one of S
//     row splits of rps = ceil(R / S) rows (blockIdx.y), so each row the
//     block reads is one contiguous 1 KB run.  S comes from the shape alone
//     (the wrappers' `welford.split_count`: enough blocks for about four
//     waves of 8 blocks an SM, at most one split a kChunk rows), so the
//     result repeats bit for bit.  The row pitch of the measured
//     16387-column shape (65,548 bytes) is not a multiple of 16, so neither
//     16-byte loads nor TMA apply: the loads are 4-byte and coalesced, and
//     bandwidth comes from having many of them in flight: each thread loads
//     kChunk = 16 rows of its column(s) before it uses any.  A split writes
//     its partials to an fp32 workspace that the wrapper allocates; its row
//     count is clamp(R - s * rps, 0, rps), known from the shape, so it is
//     not stored, and a split with no rows writes nothing.
//   * a merge kernel: a block of 32 columns x 8 warps; warp w folds the
//     splits [w * per, (w + 1) * per) of its lane's column in split order
//     (per = ceil(S / 8), loads issued 8 at a time), then warp 0 folds the
//     8 results in warp order and stores.  No atomics: a fixed order,
//     bitwise repeatable.  An empty split is the fold's identity.
//
// K8 (reduce_split_kernel, reduce_merge_kernel): each thread keeps a running
// sum (sum, mean) or max of its column over its split's rows, adding the
// chunk's 16 values in row order; max starts from -3.4e38 and NaN sticks
// through both passes.  With 16-bit input, C even and a 4-byte aligned
// base, a thread reads its two adjacent columns as one 4-byte load
// (bf16x2 / half2, each half widened to fp32 exactly), so a block covers 512
// columns and a row's read is again 1 KB; otherwise one column a thread.
// The merge multiplies mean's sum by float32(1 / R) and stores in out_dt.
// The workspace is S x C fp32.
//
// K7 (welford_split_kernel, welford_merge_kernel): each thread takes its
// chunk relative to its running mean (d = v - mean), forms the chunk's
// mean of d (times 1 / 16) and the chunk's M2 as the sum of (d - chunk
// mean)^2 in registers, then folds the chunk into its running (n, mean, M2)
// by Chan's formula: one divide a chunk, not one an element.  Counts are
// integers, made float only inside a merge.  The workspace is 2 x S x C
// fp32 (the splits' means, then their M2); the merge folds by Chan's
// formula and writes mean and invstd.
// Raw sums of squares are never formed over a column: cancellation there
// is what Welford avoids.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns per merge block (one per lane)
constexpr int kWarps = 8;  // split groups per merge block
constexpr int kSplitThreads = 256;  // threads of a split block, one per column (or pair)
constexpr int kChunk = 16;          // rows a thread loads before using them
constexpr int kPair = 2;            // 16-bit columns a thread reads as one 4-byte load
constexpr int kMergeLoads = 8;      // partials a thread loads before merging

enum ReduceOp { kSum = 0, kMean = 1, kMax = 2 };

// The row count of split s: clamp(rows - s * rps, 0, rps).
__device__ __forceinline__ int split_rows(int rows, int rps, int s) {
  return (int)max(0LL, min((long long)rps, rows - (long long)s * rps));
}

// -- K8: sum / mean / max ----------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half_rn(v); }

// P = 1: one value of T; P = 2: a 4-byte pair of 16-bit values, each widened.
template <typename T, int P>
struct Cols;

template <typename T>
struct Cols<T, 1> {
  __device__ static void load(const T* p, float* v) { v[0] = to_f(*p); }
};

template <>
struct Cols<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};

template <>
struct Cols<__half, 2> {
  __device__ static void load(const __half* p, float* v) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    v[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
};

template <int OP>
__device__ __forceinline__ float combine(float acc, float x) {
  if (OP == kMax) return (x != x || x > acc) ? x : acc;  // NaN sticks
  return acc + x;
}

__device__ __forceinline__ float combine(int op, float acc, float x) {
  return op == kMax ? combine<kMax>(acc, x) : combine<kSum>(acc, x);
}

// OP: kSum (for sum and mean) or kMax.  Thread t of block (bx, s) owns
// columns (bx * kSplitThreads + t) * P + [0, P) over split s's rows and
// writes their partials to ws[s, :].
template <typename T, int P, int OP>
__global__ void __launch_bounds__(kSplitThreads) reduce_split_kernel(
    const T* __restrict__ x, float* __restrict__ ws, int rows, int cols, int rps) {
  const int col = (blockIdx.x * kSplitThreads + threadIdx.x) * P;
  const int n = split_rows(rows, rps, blockIdx.y);
  if (col >= cols || n == 0) return;  // past the matrix, or an empty split
  const size_t pitch = (size_t)cols;
  const T* p = x + (size_t)blockIdx.y * rps * pitch + col;
  float acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = OP == kMax ? -3.4e38f : 0.0f;
  int r = 0;
  for (; r + kChunk <= n; r += kChunk, p += kChunk * pitch) {
    float v[kChunk][P];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) Cols<T, P>::load(p + u * pitch, v[u]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j] = combine<OP>(acc[j], v[u][j]);
  }
  if (r < n) {  // the split's last rows, fewer than kChunk
    const int u_n = n - r;
    float v[kChunk][P];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (u < u_n) Cols<T, P>::load(p + u * pitch, v[u]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (u < u_n)
#pragma unroll
        for (int j = 0; j < P; ++j) acc[j] = combine<OP>(acc[j], v[u][j]);
  }
  float* w = ws + (size_t)blockIdx.y * pitch + col;
#pragma unroll
  for (int j = 0; j < P; ++j) w[j] = acc[j];
}

template <typename TOut>
__global__ void __launch_bounds__(kCols * kWarps) reduce_merge_kernel(
    const float* __restrict__ ws, TOut* __restrict__ out, int rows, int cols,
    int splits, int rps, int op, float scale) {
  __shared__ float part[kWarps][kCols];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const int per = (splits + kWarps - 1) / kWarps;
  const int s_end = min(splits, (warp + 1) * per);
  const size_t pitch = (size_t)cols;
  const float init = op == kMax ? -3.4e38f : 0.0f;
  float acc = init;
  if (col < cols) {
    for (int s0 = warp * per; s0 < s_end; s0 += kMergeLoads) {
      float v[kMergeLoads];
      bool live[kMergeLoads];
#pragma unroll
      for (int i = 0; i < kMergeLoads; ++i) {
        const int s = s0 + i;
        live[i] = s < s_end && split_rows(rows, rps, s) > 0;
        v[i] = live[i] ? ws[s * pitch + col] : init;
      }
#pragma unroll
      for (int i = 0; i < kMergeLoads; ++i)
        if (live[i]) acc = combine(op, acc, v[i]);
    }
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

// -- K7: Welford mean and invstd -----------------------------------------------

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

__global__ void __launch_bounds__(kSplitThreads) welford_split_kernel(
    const float* __restrict__ x, float* __restrict__ ws, int rows, int cols,
    int rps) {
  const int col = blockIdx.x * kSplitThreads + threadIdx.x;
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
        nb[i] = s < s_end ? split_rows(rows, rps, s) : 0;
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

template <typename T, int P>
int launch_split(const void* x, float* ws, int rows, int cols, int op, int rps,
                 int splits, cudaStream_t stream) {
  const int per_block = kSplitThreads * P;
  const dim3 grid((cols + per_block - 1) / per_block, splits);
  const T* px = static_cast<const T*>(x);
  if (op == kMax)
    reduce_split_kernel<T, P, kMax><<<grid, kSplitThreads, 0, stream>>>(px, ws, rows, cols, rps);
  else
    reduce_split_kernel<T, P, kSum><<<grid, kSplitThreads, 0, stream>>>(px, ws, rows, cols, rps);
  return (int)cudaGetLastError();
}

template <typename T>
int split_of(const void* x, float* ws, int rows, int cols, int op, int rps,
             int splits, int pair, cudaStream_t s) {
  if (pair) return launch_split<T, kPair>(x, ws, rows, cols, op, rps, splits, s);
  return launch_split<T, 1>(x, ws, rows, cols, op, rps, splits, s);
}

template <typename TOut>
int launch_merge(const float* ws, void* out, int rows, int cols, int splits,
                 int rps, int op, float scale, cudaStream_t stream) {
  reduce_merge_kernel<TOut><<<(cols + kCols - 1) / kCols, dim3(kCols, kWarps), 0, stream>>>(
      ws, static_cast<TOut*>(out), rows, cols, splits, rps, op, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes); dtype codes as in
// kfunca_tpu_torch/core/dtype.py (6 fp16, 7 bf16, 8 fp32).  x is a
// row-major (rows, cols) matrix, out / mean / invstd hold cols values.
// Each runs two launches, split then merge, and returns cudaGetLastError()
// after them (0 on success).

// K8.  op: 0 sum, 1 mean (times `scale`), 2 max.  ws: a workspace of
// splits x cols fp32, which the caller allocates.  pair: read 16-bit
// columns two at a time (the caller checks cols is even and x 4-byte
// aligned; fp32 takes one column a thread).
extern "C" int kf_reduce_2d(const void* x, int in_code, void* out, int out_code,
                            void* ws, int rows, int cols, int splits, int pair,
                            int op, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || op < 0 || op > 2 || splits <= 0 || splits > 65535 ||
      (pair && (in_code == 8 || cols % kPair != 0 || (uintptr_t)x % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (out_code < 6 || out_code > 8) return (int)cudaErrorInvalidValue;
  const int rps = (int)(((long long)rows + splits - 1) / splits);
  float* w = static_cast<float*>(ws);
  int e;
  switch (in_code) {
    case 6: e = split_of<__half>(x, w, rows, cols, op, rps, splits, pair, s); break;
    case 7: e = split_of<__nv_bfloat16>(x, w, rows, cols, op, rps, splits, pair, s); break;
    case 8: e = launch_split<float, 1>(x, w, rows, cols, op, rps, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  switch (out_code) {
    case 6: return launch_merge<__half>(w, out, rows, cols, splits, rps, op, scale, s);
    case 7: return launch_merge<__nv_bfloat16>(w, out, rows, cols, splits, rps, op, scale, s);
    default: return launch_merge<float>(w, out, rows, cols, splits, rps, op, scale, s);
  }
}

// K7.  ws: a workspace of 2 x splits x cols fp32 (the split partials'
// means, then their M2), which the caller allocates.
extern "C" int kf_welford_norm_stat(const void* x, void* mean, void* invstd,
                                    void* ws, int rows, int cols, int splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int rps = (int)(((long long)rows + splits - 1) / splits);
  const dim3 grid((cols + kSplitThreads - 1) / kSplitThreads, splits);
  welford_split_kernel<<<grid, kSplitThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(ws), rows, cols, rps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  welford_merge_kernel<<<(cols + kCols - 1) / kCols, dim3(kCols, kWarps), 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(mean),
      static_cast<float*>(invstd), rows, cols, splits, rps);
  return (int)cudaGetLastError();
}
