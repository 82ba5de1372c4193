// Tiled GEMM with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   kfunca_tpu/ops/pallas_kernels/matmul.py: matmul (bodies _matmul_kernel,
//   _apply_epilogue).
//
// Contract (the TPU kernel's): out = epilogue(a @ b) for row-major a (m, k)
// and b (k, n), any m, k, n (ragged edges are masked here; nothing is
// padded on the host), with
//   * bf16 / fp16 inputs: fp32 accumulation;
//   * fp32 inputs: full fp32 products and sums (the TPU kernel's
//     Precision.HIGHEST; no TF32);
//   * int8 inputs: exact int32 accumulation (the caller bounds k);
// and the epilogue on the accumulator in the TPU kernel's order, in fp32:
// + bias[j] (n fp32 values), then one of tanh-GELU, SiLU or ReLU, then
// + residual[i, j] (m x n fp32), then the store in the output dtype (fp32,
// bf16, fp16 or int32; an fp32 value stored into int32 saturates, as XLA
// converts).  Without an epilogue an int8 product stores its exact int32.
//
// What bounds it: operations at the shapes the eager API runs (4096^3
// bf16: 137 GFLOP against 100 MB of operands, ~1,400 operations a byte,
// far past the card's ~295).  Two device bodies, chosen by input type:
//   * bf16 / fp16: tensor cores through mma.sync.m16n8k16 with fp32
//     accumulators.  A block of 8 warps owns a 128 x 128 output tile, a
//     warp 64 x 32 of it (4 x 4 mma tiles); 128 x 32 tiles of a and
//     32 x 128 tiles of b are staged in shared memory with 16-byte loads
//     (padded rows keep the fragment reads free of bank conflicts);
//   * fp32 and int8: CUDA-core FMA.  A block of 256 threads owns a
//     128 x 128 tile, a thread 8 x 8 of it from registers, over k steps of
//     8 staged in shared memory (a transposed).
// The TPU kernel's (2048, 512, 2048) VMEM blocks and its sequential k grid
// do not carry over: the k loop runs inside the block, and the blocks of
// the output tile grid run at once.
// Left for later: wgmma and TMA with a multi-stage shared-memory ring, which
// the tensor cores' full rate needs; a tensor-core path for int8.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Epilogue {
  const float* bias;  // (n,) or null
  const float* res;   // (m, n) row-major or null
  int act;            // 0 none, 1 tanh-GELU, 2 SiLU, 3 ReLU
  bool any;
};

__device__ __forceinline__ float apply_epilogue(float v, int row, int col,
                                                int n, const Epilogue& e) {
  if (e.bias != nullptr) v += e.bias[col];
  if (e.act == 1) {
    const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    v = v * (0.5f * (1.0f + tanhf(inner)));
  } else if (e.act == 2) {
    v = v * (1.0f / (1.0f + expf(-v)));
  } else if (e.act == 3) {
    v = (v > 0.0f || v != v) ? v : 0.0f;  // max(v, 0), NaN through
  }
  if (e.res != nullptr) v += e.res[(long long)row * n + col];
  return v;
}

// dtype codes as in kfunca_tpu_torch/core/dtype.py: 4 int32, 6 fp16,
// 7 bf16, 8 fp32
__device__ __forceinline__ void store(void* out, int code, long long i, float v) {
  switch (code) {
    case 6: static_cast<__half*>(out)[i] = __float2half_rn(v); break;
    case 7: static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v); break;
    case 4: {
      int r;
      if (v != v) r = 0;
      else if (v >= 2147483647.0f) r = 2147483647;
      else if (v <= -2147483648.0f) r = (-2147483647 - 1);
      else r = (int)v;
      static_cast<int*>(out)[i] = r;
      break;
    }
    default: static_cast<float*>(out)[i] = v; break;
  }
}

__device__ __forceinline__ void store(void* out, int code, long long i, int v) {
  if (code == 4) static_cast<int*>(out)[i] = v;
  else store(out, code, i, (float)v);
}

template <typename Acc>
__device__ __forceinline__ void finish(void* out, int code, int row, int col,
                                       int m, int n, Acc v, const Epilogue& e) {
  if (row >= m || col >= n) return;
  const long long i = (long long)row * n + col;
  if (e.any) store(out, code, i, apply_epilogue((float)v, row, col, n, e));
  else store(out, code, i, v);
}

// -- bf16 / fp16: tensor cores (mma.sync m16n8k16, fp32 accumulators) -------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAStride = kBK + 8;  // shared row strides, in 16-bit elements
constexpr int kBStride = kBN + 8;

template <bool kBf16>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  if (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// 8 consecutive 16-bit values of a row starting at column c (of `cols`);
// values past the row's end read as 0
__device__ __forceinline__ uint4 load8(const uint16_t* row, int c, int cols,
                                       bool vec) {
  if (vec && c + 8 <= cols) return __ldg(reinterpret_cast<const uint4*>(row + c));
  uint16_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (c + j < cols) ? row[c + j] : (uint16_t)0;
  uint4 r;
  r.x = v[0] | ((uint32_t)v[1] << 16);
  r.y = v[2] | ((uint32_t)v[3] << 16);
  r.z = v[4] | ((uint32_t)v[5] << 16);
  r.w = v[6] | ((uint32_t)v[7] << 16);
  return r;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) mma_gemm_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
    void* __restrict__ out, int out_code, int m, int n, int k, Epilogue e,
    bool a_vec, bool b_vec) {
  __shared__ __align__(16) uint16_t as[kBM * kAStride];
  __shared__ __align__(16) uint16_t bs[kBK * kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // a tile: 128 rows x 32 columns, 4 chunks of 8 a row
    for (int c = tid; c < kBM * kBK / 8; c += kThreads) {
      const int r = c >> 2, kc = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) v = load8(a + (long long)(m0 + r) * k, k0 + kc, k, a_vec);
      *reinterpret_cast<uint4*>(as + r * kAStride + kc) = v;
    }
    // b tile: 32 rows x 128 columns, 16 chunks of 8 a row
    for (int c = tid; c < kBK * kBN / 8; c += kThreads) {
      const int r = c >> 4, nc = (c & 15) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k) v = load8(b + (long long)(k0 + r) * n, n0 + nc, n, b_vec);
      *reinterpret_cast<uint4*>(bs + r * kBStride + nc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint16_t* p = as + (wm * 64 + mi * 16 + g) * kAStride + kk + t4 * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* p = bs + (kk + t4 * 2) * kBStride + wn * 32 + ni * 8 + g;
        bf[ni][0] = p[0] | ((uint32_t)p[kBStride] << 16);
        bf[ni][1] = p[8 * kBStride] | ((uint32_t)p[9 * kBStride] << 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816<kBf16>(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * 64 + mi * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + (r & 1);
        finish(out, out_code, row, col, m, n, acc[mi][ni][r], e);
      }
}

// -- fp32 and int8: CUDA-core FMA -------------------------------------------

constexpr int kSB = 128;        // output tile side
constexpr int kSK = 8;          // k step
constexpr int kSStride = kSB + 4;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ int widen(int8_t x) { return (int)x; }

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads) simt_gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, void* __restrict__ out,
    int out_code, int m, int n, int k, Epilogue e) {
  __shared__ __align__(16) Acc as[kSK][kSStride];  // a transposed: [k][row]
  __shared__ __align__(16) Acc bs[kSK][kSStride];  // [k][column]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads, 8 x 8 each
  const int m0 = blockIdx.y * kSB, n0 = blockIdx.x * kSB;

  Acc acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = (Acc)0;

  for (int k0 = 0; k0 < k; k0 += kSK) {
#pragma unroll
    for (int u = 0; u < kSB * kSK / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int r = idx >> 3, c = idx & 7;  // a: row r, k column c
      const int gr = m0 + r, gk = k0 + c;
      as[c][r] = (gr < m && gk < k) ? widen(a[(long long)gr * k + gk]) : (Acc)0;
      const int br = idx >> 7, bc = idx & 127;  // b: k row br, column bc
      const int hk = k0 + br, gn = n0 + bc;
      bs[br][bc] = (hk < k && gn < n) ? widen(b[(long long)hk * n + gn]) : (Acc)0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      Acc av[8], bv[8];
      *reinterpret_cast<uint4*>(av) = *reinterpret_cast<const uint4*>(&as[kk][ty * 8]);
      *reinterpret_cast<uint4*>(av + 4) = *reinterpret_cast<const uint4*>(&as[kk][ty * 8 + 4]);
      *reinterpret_cast<uint4*>(bv) = *reinterpret_cast<const uint4*>(&bs[kk][tx * 8]);
      *reinterpret_cast<uint4*>(bv + 4) = *reinterpret_cast<const uint4*>(&bs[kk][tx * 8 + 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      finish(out, out_code, m0 + ty * 8 + i, n0 + tx * 8 + j, m, n, acc[i][j], e);
}

}  // namespace

// Plain C entry point (bound with ctypes).  in_code: 2 int8, 6 fp16,
// 7 bf16, 8 fp32; out_code: 4 int32, 6 fp16, 7 bf16, 8 fp32 (dtype codes of
// kfunca_tpu_torch/core/dtype.py).  a (m, k) and b (k, n) are contiguous
// row-major; bias (n,) and residual (m, n) are contiguous fp32 or null;
// act: 0 none, 1 tanh-GELU, 2 SiLU, 3 ReLU.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int kf_matmul(const void* a, const void* b, const void* bias,
                         const void* residual, void* out, int in_code,
                         int out_code, int m, int k, int n, int act,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0 || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  Epilogue e;
  e.bias = static_cast<const float*>(bias);
  e.res = static_cast<const float*>(residual);
  e.act = act;
  e.any = bias != nullptr || residual != nullptr || act != 0;
  const dim3 block(kThreads);
  if (in_code == 6 || in_code == 7) {
    const bool a_vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const bool b_vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    const uint16_t* ap = static_cast<const uint16_t*>(a);
    const uint16_t* bp = static_cast<const uint16_t*>(b);
    if (in_code == 7)
      mma_gemm_kernel<true><<<grid, block, 0, s>>>(ap, bp, out, out_code, m, n,
                                                   k, e, a_vec, b_vec);
    else
      mma_gemm_kernel<false><<<grid, block, 0, s>>>(ap, bp, out, out_code, m, n,
                                                    k, e, a_vec, b_vec);
    return (int)cudaGetLastError();
  }
  const dim3 grid((n + kSB - 1) / kSB, (m + kSB - 1) / kSB);
  if (in_code == 8) {
    simt_gemm_kernel<float, float><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), out,
        out_code, m, n, k, e);
  } else if (in_code == 2) {
    simt_gemm_kernel<int8_t, int><<<grid, block, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), out,
        out_code, m, n, k, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
