// Elementwise kernel family over contiguous operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   kfunca_tpu/ops/pallas_kernels/elementwise.py: elementwise (body _ew_kernel).
//
// Contract (the TPU kernel's): out[i] = op(a[i] [, b[i]]) for i < n over
// same-shape contiguous operands, ops add, sub, mul, div, copy, neg, abs,
// exp.  Each operand is read in its own dtype and widened to the
// accumulation type, the math runs there, and the result is stored in the
// output dtype:
//   * accumulation type float (fp32 and 16-bit floats), double (fp64) or
//     int64 (every integer type and bool), as the wrapper asks;
//   * integer division truncates toward zero, as XLA's lax.div does, with
//     its answers where C++ leaves them undefined: x / 0 = -1 and
//     INT64_MIN / -1 = INT64_MIN (two's-complement wrap);
//   * a float stored into an integer type saturates at the type's range
//     and NaN becomes 0 (XLA's convert); integer narrowing wraps; a store
//     into bool is `value != 0`.
// Operand dtypes are ScalarType codes (kfunca_tpu_torch/core/dtype.py):
// 0 bool, 1 uint8, 2 int8, 3 int16, 4 int32, 5 int64, 6 fp16, 7 bf16,
// 8 fp32, 9 fp64.  The dtype switch is uniform across a launch, so every
// thread takes the same branch.
//
// What bounds it: HBM bytes (one or two reads and a write per element, at
// most one transcendental).  The design is the plainest that streams at
// the memory's rate: a grid-stride loop in which neighbouring threads touch
// neighbouring elements, so each warp's loads and stores are whole lines.
// Left for later: 16-byte vector loads and a dtype specialization of the
// common same-dtype case.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kAdd = 0, kSub, kMul, kDiv, kCopy, kNeg, kAbs, kExp };

constexpr int kThreads = 256;

template <typename Acc>
__device__ __forceinline__ Acc load(const void* p, int code, long long i) {
  switch (code) {
    case 0: return (Acc)(static_cast<const uint8_t*>(p)[i] != 0);
    case 1: return (Acc)static_cast<const uint8_t*>(p)[i];
    case 2: return (Acc)static_cast<const int8_t*>(p)[i];
    case 3: return (Acc)static_cast<const int16_t*>(p)[i];
    case 4: return (Acc)static_cast<const int32_t*>(p)[i];
    case 5: return (Acc)static_cast<const long long*>(p)[i];
    case 6: return (Acc)__half2float(static_cast<const __half*>(p)[i]);
    case 7: return (Acc)__bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 8: return (Acc)static_cast<const float*>(p)[i];
    default: return (Acc)static_cast<const double*>(p)[i];
  }
}

// float -> integer as XLA converts: NaN -> 0, saturate, truncate
template <typename I>
__device__ __forceinline__ I sat(double v, double lo, double hi) {
  if (v != v) return (I)0;
  if (v <= lo) return (I)lo;
  if (v >= hi) return (I)hi;
  return (I)v;
}

__device__ __forceinline__ long long sat64(double v) {
  if (v != v) return 0;
  if (v <= -9223372036854775808.0) return (long long)(-9223372036854775807LL - 1);
  if (v >= 9223372036854775807.0) return 9223372036854775807LL;
  return (long long)v;
}

__device__ __forceinline__ void store_float(void* p, int code, long long i, double v) {
  switch (code) {
    case 0: static_cast<uint8_t*>(p)[i] = v != 0.0; break;
    case 1: static_cast<uint8_t*>(p)[i] = sat<uint8_t>(v, 0.0, 255.0); break;
    case 2: static_cast<int8_t*>(p)[i] = sat<int8_t>(v, -128.0, 127.0); break;
    case 3: static_cast<int16_t*>(p)[i] = sat<int16_t>(v, -32768.0, 32767.0); break;
    case 4: static_cast<int32_t*>(p)[i] = sat<int32_t>(v, -2147483648.0, 2147483647.0); break;
    case 5: static_cast<long long*>(p)[i] = sat64(v); break;
    case 6: static_cast<__half*>(p)[i] = __double2half(v); break;
    case 7: static_cast<__nv_bfloat16*>(p)[i] = __double2bfloat16(v); break;
    case 8: static_cast<float*>(p)[i] = (float)v; break;
    default: static_cast<double*>(p)[i] = v; break;
  }
}

// float accumulators store through float -> 16-bit rounding directly (one
// rounding, as XLA rounds the fp32 result once)
__device__ __forceinline__ void store(void* p, int code, long long i, float v) {
  switch (code) {
    case 6: static_cast<__half*>(p)[i] = __float2half_rn(v); break;
    case 7: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v); break;
    case 8: static_cast<float*>(p)[i] = v; break;
    default: store_float(p, code, i, (double)v); break;
  }
}

__device__ __forceinline__ void store(void* p, int code, long long i, double v) {
  store_float(p, code, i, v);
}

__device__ __forceinline__ void store(void* p, int code, long long i, long long v) {
  switch (code) {
    case 0: static_cast<uint8_t*>(p)[i] = v != 0; break;
    case 1: static_cast<uint8_t*>(p)[i] = (uint8_t)v; break;
    case 2: static_cast<int8_t*>(p)[i] = (int8_t)v; break;
    case 3: static_cast<int16_t*>(p)[i] = (int16_t)v; break;
    case 4: static_cast<int32_t*>(p)[i] = (int32_t)v; break;
    case 5: static_cast<long long*>(p)[i] = v; break;
    default: store_float(p, code, i, (double)v); break;
  }
}

__device__ __forceinline__ long long wrap_neg(long long x) {
  return (long long)(0ULL - (unsigned long long)x);
}

__device__ __forceinline__ float apply(int op, float x, float y) {
  switch (op) {
    case kAdd: return x + y;
    case kSub: return x - y;
    case kMul: return x * y;
    case kDiv: return x / y;
    case kNeg: return -x;
    case kAbs: return fabsf(x);
    case kExp: return expf(x);
    default: return x;
  }
}

__device__ __forceinline__ double apply(int op, double x, double y) {
  switch (op) {
    case kAdd: return x + y;
    case kSub: return x - y;
    case kMul: return x * y;
    case kDiv: return x / y;
    case kNeg: return -x;
    case kAbs: return fabs(x);
    case kExp: return exp(x);
    default: return x;
  }
}

__device__ __forceinline__ long long apply(int op, long long x, long long y) {
  switch (op) {
    case kAdd: return (long long)((unsigned long long)x + (unsigned long long)y);
    case kSub: return (long long)((unsigned long long)x - (unsigned long long)y);
    case kMul: return (long long)((unsigned long long)x * (unsigned long long)y);
    case kDiv:
      if (y == 0) return -1;
      if (y == -1) return wrap_neg(x);
      return x / y;
    case kNeg: return wrap_neg(x);
    case kAbs: return x < 0 ? wrap_neg(x) : x;
    default: return x;
  }
}

template <typename Acc, int OP>
__global__ void __launch_bounds__(kThreads) elementwise_kernel(
    const void* __restrict__ a, int a_code, const void* __restrict__ b,
    int b_code, void* __restrict__ out, int out_code, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const Acc x = load<Acc>(a, a_code, i);
    const Acc y = (OP <= kDiv) ? load<Acc>(b, b_code, i) : x;
    store(out, out_code, i, apply(OP, x, y));
  }
}

template <typename Acc>
int launch(int op, const void* a, int a_code, const void* b, int b_code,
           void* out, int out_code, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
#define KF_EW_CASE(OPV)                                                  \
  case OPV:                                                              \
    elementwise_kernel<Acc, OPV><<<blocks, kThreads, 0, stream>>>(       \
        a, a_code, b, b_code, out, out_code, n);                         \
    break;
  switch (op) {
    KF_EW_CASE(kAdd)
    KF_EW_CASE(kSub)
    KF_EW_CASE(kMul)
    KF_EW_CASE(kDiv)
    KF_EW_CASE(kCopy)
    KF_EW_CASE(kNeg)
    KF_EW_CASE(kAbs)
    KF_EW_CASE(kExp)
    default: return (int)cudaErrorInvalidValue;
  }
#undef KF_EW_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  op: 0 add, 1 sub, 2 mul, 3 div,
// 4 copy, 5 neg, 6 abs, 7 exp; acc: 0 float, 1 double, 2 int64.  `b` is
// read only by the binary ops.  Operands hold n contiguous elements.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int kf_elementwise(int op, int acc, const void* a, int a_code,
                              const void* b, int b_code, void* out,
                              int out_code, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kExp && acc == 2) return (int)cudaErrorInvalidValue;
  switch (acc) {
    case 0: return launch<float>(op, a, a_code, b, b_code, out, out_code, n, s);
    case 1: return launch<double>(op, a, a_code, b, b_code, out, out_code, n, s);
    case 2: return launch<long long>(op, a, a_code, b, b_code, out, out_code, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
