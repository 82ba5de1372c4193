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
// 8 fp32, 9 fp64.
//
// What bounds it: HBM bytes (one or two reads and a write per element, at
// most one transcendental).  Three bodies, which the wrapper picks from the
// dtypes and the operands' alignment alone (ops/pallas_kernels/
// elementwise.route), each with its own C entry point:
//   * the vector body (kf_elementwise_vector): every operand and the
//     output share one dtype of fp32, bf16 or fp16, the math is in float,
//     and every pointer is 16-byte aligned.  A thread moves kVecBytes = 16
//     bytes of each operand per access (4 fp32 or 8 16-bit values, one
//     uint4) and issues kVecUnroll of them before it uses any, so a
//     resident block keeps 16 KB of each operand in flight; the n mod
//     (16 / size) elements past the last whole vector are a scalar tail of
//     block 0.  16-bit values widen to fp32 (exactly, by their bits), the
//     math runs in fp32 and each result rounds once on the store
//     (__float2bfloat16_rn / __float2half_rn), as _ew_kernel's astype does;
//     no packed 16-bit arithmetic, which would round elsewhere.
//   * the byte copy (kf_copy_bytes): `copy` whose input and output dtypes
//     are equal, any dtype.  It moves the bytes: 16-byte vectors where both
//     ends share their offset mod 16 (else the widest width they do share),
//     single bytes at the edges.  Bitwise the plain version, NaN payloads
//     included (a copy through a float register would keep the value, not
//     always the payload).
//   * the generic body (kf_elementwise): everything else -- mixed dtypes,
//     integer math, converting copies (one rounding, from the input's
//     value), exp of an integer type.  A grid-stride loop in which
//     neighbouring threads touch neighbouring elements; each load and store
//     goes through a switch on the dtype code, uniform across a launch.
// `out` may be an operand itself (`+=`).  No pointer is __restrict__ and no
// load goes through the read-only path: each element is read and then
// written by one thread, its loads issued before its stores, and no other
// thread touches it, so the in-place form is race-free in every body.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kAdd = 0, kSub, kMul, kDiv, kCopy, kNeg, kAbs, kExp };

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;  // bytes of one operand a vector access moves
constexpr int kVecUnroll = 4;  // vector accesses a thread issues before using any

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
    const void* a, int a_code, const void* b, int b_code, void* out,
    int out_code, long long n) {
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

// -- the vector body: one dtype of fp32 / bf16 / fp16 throughout --------------

// A 16-byte vector as four 32-bit words; Lane<T> widens the T values of a
// word to fp32 (exactly, from their bits) and rounds fp32 values back into
// one word, each value once, to nearest even.  Word k holds elements
// k * kPerWord, ... (the lower address in the low bits).
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int kPerWord = 1;
  __device__ static void get(unsigned w, float* f) { f[0] = __uint_as_float(w); }
  __device__ static unsigned put(const float* f) { return __float_as_uint(f[0]); }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static void get(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static unsigned put(const float* f) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[0])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[1])) << 16);
  }
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

template <>
struct Lane<__half> {
  static constexpr int kPerWord = 2;
  __device__ static void get(unsigned w, float* f) {
    f[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    f[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  __device__ static unsigned put(const float* f) {
    return (unsigned)__half_as_ushort(__float2half_rn(f[0])) |
           ((unsigned)__half_as_ushort(__float2half_rn(f[1])) << 16);
  }
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) { *p = __float2half_rn(v); }
};

template <typename T, int OP>
__device__ __forceinline__ uint4 apply_vector(const uint4& va, const uint4& vb) {
  constexpr int kP = Lane<T>::kPerWord;
  const unsigned wa[4] = {va.x, va.y, va.z, va.w};
  const unsigned wb[4] = {vb.x, vb.y, vb.z, vb.w};
  unsigned wo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x[kP], y[kP], r[kP];
    Lane<T>::get(wa[k], x);
    if (OP <= kDiv) Lane<T>::get(wb[k], y);
#pragma unroll
    for (int j = 0; j < kP; ++j) r[j] = apply(OP, x[j], OP <= kDiv ? y[j] : x[j]);
    wo[k] = Lane<T>::put(r);
  }
  return make_uint4(wo[0], wo[1], wo[2], wo[3]);
}

// Block b owns vectors [b * kThreads * kVecUnroll, (b + 1) * ...); thread t
// takes vectors t, t + kThreads, ... of it, so each access of a warp is one
// contiguous 512-byte run.  nvec = n / elements-a-vector; the elements from
// nvec * (16 / size) to n are block 0's scalar tail.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) elementwise_vector_kernel(
    const T* a, const T* b, T* out, long long n) {
  constexpr int kE = kVecBytes / (int)sizeof(T);
  const long long nvec = n / kE;
  const uint4* va = reinterpret_cast<const uint4*>(a);
  const uint4* vb = reinterpret_cast<const uint4*>(b);
  uint4* vo = reinterpret_cast<uint4*>(out);
  const long long first = (long long)blockIdx.x * (kThreads * kVecUnroll) + threadIdx.x;
  uint4 ra[kVecUnroll], rb[kVecUnroll];
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u) {
    const long long i = first + (long long)u * kThreads;
    if (i < nvec) {
      ra[u] = va[i];
      if (OP <= kDiv) rb[u] = vb[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u) {
    const long long i = first + (long long)u * kThreads;
    if (i < nvec) vo[i] = apply_vector<T, OP>(ra[u], OP <= kDiv ? rb[u] : ra[u]);
  }
  const long long t = nvec * kE + threadIdx.x;
  if (blockIdx.x == 0 && t < n) {
    const float x = Lane<T>::load(a + t);
    const float y = OP <= kDiv ? Lane<T>::load(b + t) : x;
    Lane<T>::store(out + t, apply(OP, x, y));
  }
}

template <typename T>
int launch_vector(int op, const void* a, const void* b, void* out, long long n,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr long long kE = kVecBytes / sizeof(T);
  const long long per_block = (long long)kThreads * kVecUnroll;
  const long long want = (n / kE + per_block - 1) / per_block;
  const unsigned blocks = (unsigned)(want > 0 ? want : 1);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
#define KF_EW_VCASE(OPV)                                                      \
  case OPV:                                                                   \
    elementwise_vector_kernel<T, OPV><<<blocks, kThreads, 0, stream>>>(pa, pb, \
                                                                       po, n); \
    break;
  switch (op) {
    KF_EW_VCASE(kAdd)
    KF_EW_VCASE(kSub)
    KF_EW_VCASE(kMul)
    KF_EW_VCASE(kDiv)
    KF_EW_VCASE(kNeg)
    KF_EW_VCASE(kAbs)
    KF_EW_VCASE(kExp)
    default: return (int)cudaErrorInvalidValue;
  }
#undef KF_EW_VCASE
  return (int)cudaGetLastError();
}

// -- the byte copy ------------------------------------------------------------

// V is the access width (16, 8, 4, 2 or 1 bytes) that src and dst share mod
// 16.  The first `head` bytes (up to src's next V boundary) and the bytes
// past the last whole V are copied one by one by block 0's first threads;
// the vectors between them as the vector body streams its operands.
template <typename V>
__global__ void __launch_bounds__(kThreads) copy_bytes_kernel(
    const unsigned char* src, unsigned char* dst, long long head, long long nvec,
    long long nbytes) {
  const V* vs = reinterpret_cast<const V*>(src + head);
  V* vd = reinterpret_cast<V*>(dst + head);
  const long long first = (long long)blockIdx.x * (kThreads * kVecUnroll) + threadIdx.x;
  V r[kVecUnroll];
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u) {
    const long long i = first + (long long)u * kThreads;
    if (i < nvec) r[u] = vs[i];
  }
#pragma unroll
  for (int u = 0; u < kVecUnroll; ++u) {
    const long long i = first + (long long)u * kThreads;
    if (i < nvec) vd[i] = r[u];
  }
  if (blockIdx.x == 0) {
    const long long tail = head + nvec * (long long)sizeof(V);
    if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
    if (tail + threadIdx.x < nbytes) dst[tail + threadIdx.x] = src[tail + threadIdx.x];
  }
}

template <typename V>
int launch_copy(const unsigned char* src, unsigned char* dst, long long nbytes,
                cudaStream_t stream) {
  constexpr long long kW = sizeof(V);
  long long head = (long long)((kW - (uintptr_t)src % kW) % kW);
  if (head > nbytes) head = nbytes;
  const long long nvec = (nbytes - head) / kW;
  const long long per_block = (long long)kThreads * kVecUnroll;
  const long long want = (nvec + per_block - 1) / per_block;
  copy_bytes_kernel<V><<<(unsigned)(want > 0 ? want : 1), kThreads, 0, stream>>>(
      src, dst, head, nvec, nbytes);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// The generic body.  op: 0 add, 1 sub, 2 mul, 3 div,
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

// The vector body: a, b (read by the binary ops only) and out hold n values
// of one dtype, `code` 6 fp16, 7 bf16 or 8 fp32, each pointer 16-byte
// aligned; the math is in fp32.  Not `copy` (a same-dtype copy is the byte
// copy's).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int kf_elementwise_vector(int op, const void* a, const void* b,
                                     void* out, int code, long long n,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) % kVecBytes != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (code) {
    case 6: return launch_vector<__half>(op, a, b, out, n, s);
    case 7: return launch_vector<__nv_bfloat16>(op, a, b, out, n, s);
    case 8: return launch_vector<float>(op, a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The byte copy: dst[i] = src[i] for i < nbytes.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int kf_copy_bytes(const void* src, void* dst, long long nbytes,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbytes <= 0) return 0;
  const unsigned char* ps = static_cast<const unsigned char*>(src);
  unsigned char* pd = static_cast<unsigned char*>(dst);
  const uintptr_t skew = ((uintptr_t)ps ^ (uintptr_t)pd) % kVecBytes;
  if (skew == 0) return launch_copy<uint4>(ps, pd, nbytes, s);
  if (skew % 8 == 0) return launch_copy<uint2>(ps, pd, nbytes, s);
  if (skew % 4 == 0) return launch_copy<unsigned>(ps, pd, nbytes, s);
  if (skew % 2 == 0) return launch_copy<unsigned short>(ps, pd, nbytes, s);
  return launch_copy<unsigned char>(ps, pd, nbytes, s);
}
