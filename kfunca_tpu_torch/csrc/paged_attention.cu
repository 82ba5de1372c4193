// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends over the live pages of a paged KV pool.
//
// Replaces the TPU kernels
//   kfunca_tpu/ops/pallas_kernels/paged_attention.py:
//     paged_decode_attention_dma (body _decode_kernel_dma): fused [k|v] pool
//       or split pools, fp32/bf16 or int8 with fp32 scales, slot-major or
//       head-major scale pools;
//     paged_decode_attention (bodies _decode_kernel, _decode_kernel_mxu):
//       split pools, 4-D or flat 3-D, fp32/bf16 or int8 with a slot-major
//       scale pair.
// One device body serves both entry points: the pool forms differ only in
// where a (page, slot, kv head) vector and its scale sit, which the caller
// states as base pointers and strides (struct Layout).
//
// Contract (the same as the TPU kernels'):
//   q        (B, H, hd), already scaled by 1/sqrt(hd), fp32 or bf16
//   k, v     rows of hd elements: element d of (page p, slot s, kv head j) is
//            base[(p * page + s) * row_stride + j * hd + d].  The fused pool
//            (n_pool_pages, page, 2*Hkv*hd) has row_stride 2*Hkv*hd and
//            v = k + Hkv*hd; split pools (n_pool_pages, page, Hkv, hd), or
//            the same memory flat, have row_stride Hkv*hd.  fp pools have
//            q's type; int8 pools carry scales.  The serving engine passes
//            its layer-stacked pools flattened, with page_base =
//            layer * n_pages selecting the layer
//   sk, sv   fp32 scale of (page p, slot s, kv head j) at
//            base[p * s_page + s * s_slot + j * s_head]: the fused engine's
//            slot-major (page, 128) rows [sk heads | sv heads | unused],
//            split slot-major (page, Hkv) or head-major (Hkv, page)
//   tables   (B, max_pages) int32 page ids, positions (B,) int32
//   out      (B, H, hd) in q's dtype
// Sequence b reads pages jj in [first_live, n_live) with
//   n_live = min(pos / page + 1, max_pages)      (clamped: idle slots can
//            run past the table inside a decode burst; the plain gather
//            version then admits every table slot, as this does)
//   first_live = max(0, (pos - window + 1) / page)  (window > 0 only)
// and masks slots > pos and slots <= pos - window with the finite -1e30.
// Query head h reads kv head h / (H / Hkv).  fp32 online softmax; a row
// whose every slot was masked (l == 0) divides by 1, as the TPU kernel does.
// int8: s = (q . k_q8) * sk[slot] and acc += (p * sv[slot]) * v_q8, the
// scales folded into the scores and the probabilities as on the TPU, while
// l sums the unscaled p.
// Pages outside [first_live, n_live) are never read, neither their data nor
// their scales, and masked slots of a live page are zeroed on load (data and
// scales), so NaN there cannot reach the output.
//
// What bounds it: HBM bytes.  Each decode step reads every live KV page
// once (B * live_slots * 2*Hkv*hd elements, plus 2*Hkv scales a slot for
// int8) and does only ~2 flops per byte read, far under the ~295 flop/byte
// a Hopper card needs before compute matters.  The design therefore aims at
// reading exactly the live bytes, each once, with wide loads:
//   * one thread block per (kv head, sequence); the block keeps its GQA
//     group's H/Hkv query rows in shared memory, so every k/v row is read
//     from HBM once and used by all the query heads that share it;
//   * the block walks the live pages in chunks of ~64 slots; each chunk's
//     k and v rows of this kv head are fetched with coalesced 16-byte
//     loads (4 fp32, 8 bf16 or 16 int8 values; all the block's loads for a
//     chunk are in flight together), widened to fp32 in shared memory, then
//     scored, softmaxed (one warp per query row) and accumulated;
//   * the page table is read by the block itself, so only live pages move.
// Left for later: splitting long sequences over several blocks (flash-
// decoding) to fill all 132 SMs at small batch, and cp.async/TMA double
// buffering so the next chunk's loads overlap this chunk's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kChunkSlots = 64;

constexpr int kLoadBatch = 8;  // 16-byte loads per thread per tensor in flight

// 16 bytes of T (4 fp32, 8 bf16 or 16 int8) widened to fp32 in shared memory
__device__ __forceinline__ void store16(uint4 raw, float* dst, float) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void store16(uint4 raw, float* dst, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(uint4 raw, float* dst, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = (float)b[i];
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where the pools' vectors and scales sit; see the contract above.
struct Layout {
  const void* k;
  const void* v;
  long long row_stride;  // pool elements between successive slots
  const float* sk;       // null for fp pools
  const float* sv;
  long long s_page, s_slot, s_head;  // floats between pages, slots, heads
};

// grid (Hkv, B), block kThreads.  TQ: q's and out's type; TP: the pools'.
// Shared memory (fp32):
//   q_s (G, hd) | acc_s (G, hd) | k_s (C, hd+1) | v_s (C, hd) | p_s (G, C)
//   | sk_s, sv_s (C each) | m_s, l_s, alpha_s (G each)
// with G = H/Hkv, C = chunk slots.  k_s rows are padded by one float so the
// score loop, where neighbouring threads read neighbouring rows at the same
// column, is free of bank conflicts.
template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, Layout lay, const int* __restrict__ tables,
    const int* __restrict__ positions, TQ* __restrict__ out, int H, int Hkv,
    int hd, int page, int max_pages, long long n_pool_pages,
    long long page_base, int window, int chunk_pages) {
  const TP* __restrict__ kpool = static_cast<const TP*>(lay.k);
  const TP* __restrict__ vpool = static_cast<const TP*>(lay.v);
  const bool quantized = lay.sk != nullptr;
  extern __shared__ float smem[];
  const int group = H / Hkv;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int C = chunk_pages * page;
  const int ks = hd + 1;
  float* q_s = smem;
  float* acc_s = q_s + group * hd;
  float* k_s = acc_s + group * hd;
  float* v_s = k_s + C * ks;
  float* p_s = v_s + C * hd;
  float* sk_s = p_s + group * C;
  float* sv_s = sk_s + C;
  float* m_s = sv_s + C;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const TQ* qg = q + ((long long)b * H + (long long)kvh * group) * hd;
  for (int i = tid; i < group * hd; i += blockDim.x) {
    q_s[i] = to_float(qg[i]);
    acc_s[i] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int pos = positions[b];
  const int n_live = min(pos / page + 1, max_pages);
  int first_live = 0;
  if (window > 0) {
    const int f = pos - window + 1;
    first_live = f > 0 ? f / page : 0;
  }
  constexpr int E = 16 / sizeof(TP);  // elements per 16-byte load
  const int vec_per_row = hd / E;
  const int* table = tables + (long long)b * max_pages;
  __syncthreads();

  for (int c0 = first_live; c0 < n_live; c0 += chunk_pages) {
    const int slot0 = c0 * page;
    // k/v rows of this kv head for the chunk's live slots; masked slots
    // (past pos, behind the window, or past the live pages) are zeroed.
    // Each thread issues kLoadBatch loads per tensor before it stores any,
    // so their HBM latencies overlap.
    const int n_vec = C * vec_per_row;
    for (int base = tid; base < n_vec; base += kLoadBatch * blockDim.x) {
      uint4 kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = base + u * blockDim.x;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        const int r = i / vec_per_row;
        const int jj = c0 + r / page;
        const int slot = slot0 + r;
        if (i < n_vec && jj < n_live && slot <= pos &&
            (window <= 0 || slot > pos - window)) {
          long long pid = (long long)table[jj] + page_base;
          // out-of-range page ids are clamped, as XLA clamps gathers
          pid = pid < 0 ? 0 : (pid >= n_pool_pages ? n_pool_pages - 1 : pid);
          const long long off = (pid * page + (r % page)) * lay.row_stride +
                                (long long)kvh * hd + (i - r * vec_per_row) * E;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(kpool + off));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(vpool + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n_vec) {
          const int r = i / vec_per_row;
          const int c = (i - r * vec_per_row) * E;
          store16(kr[u], k_s + r * ks + c, TP());
          store16(vr[u], v_s + r * hd + c, TP());
        }
      }
    }
    // this kv head's scales of the chunk's unmasked slots; 0 where masked,
    // so that a dead scale row is never read and p * sv is an exact 0 there
    if (quantized) {
      for (int r = tid; r < C; r += blockDim.x) {
        const int jj = c0 + r / page;
        const int slot = slot0 + r;
        float a = 0.f, c = 0.f;
        if (jj < n_live && slot <= pos &&
            (window <= 0 || slot > pos - window)) {
          long long pid = (long long)table[jj] + page_base;
          pid = pid < 0 ? 0 : (pid >= n_pool_pages ? n_pool_pages - 1 : pid);
          const long long off =
              pid * lay.s_page + (r % page) * lay.s_slot + kvh * lay.s_head;
          a = __ldg(lay.sk + off);
          c = __ldg(lay.sv + off);
        }
        sk_s[r] = a;
        sv_s[r] = c;
      }
    }
    __syncthreads();

    // scores s[g, r] = q_g . k_r over the chunk, -1e30 where masked
    for (int i = tid; i < group * C; i += blockDim.x) {
      const int g = i / C;
      const int r = i - g * C;
      const int jj = c0 + r / page;
      const int slot = slot0 + r;
      float s = kNegInf;
      if (jj < n_live && slot <= pos && (window <= 0 || slot > pos - window)) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + r * ks;
        float a = 0.f;
        for (int d = 0; d < hd; ++d) a = fmaf(qr[d], kr[d], a);
        s = quantized ? a * sk_s[r] : a;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < group; g += n_warps) {
      float* pr = p_s + g * C;
      float mx = kNegInf;
      for (int r = lane; r < C; r += 32) mx = fmaxf(mx, pr[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < C; r += 32) {
        const float p = expf(pr[r] - m_new);
        pr[r] = quantized ? p * sv_s[r] : p;  // l sums the unscaled p
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * alpha[g] + sum_r p[g, r] * v[r, d]
    for (int i = tid; i < group * hd; i += blockDim.x) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pr = p_s + g * C;
      float a = acc_s[i] * alpha_s[g];
      for (int r = 0; r < C; ++r) a = fmaf(pr[r], v_s[r * hd + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  TQ* og = out + ((long long)b * H + (long long)kvh * group) * hd;
  for (int i = tid; i < group * hd; i += blockDim.x) {
    float l = l_s[i / hd];
    if (l == 0.f) l = 1.f;
    og[i] = from_float<TQ>(acc_s[i] / l);
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const Layout& lay, const int* tables,
           const int* positions, void* out, int B, int H, int Hkv, int hd,
           int page, int max_pages, long long n_pool_pages,
           long long page_base, int window, cudaStream_t stream) {
  const int chunk_pages = page >= kChunkSlots ? 1 : kChunkSlots / page;
  const int C = chunk_pages * page;
  const int group = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)2 * group * hd +
                                       (size_t)C * (hd + 1) + (size_t)C * hd +
                                       (size_t)group * C + 2 * (size_t)C +
                                       3 * (size_t)group);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<TQ, TP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Hkv, B);
  paged_decode_kernel<TQ, TP><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), lay, tables, positions,
      static_cast<TQ*>(out), H, Hkv, hd, page, max_pages, n_pool_pages,
      page_base, window, chunk_pages);
  return (int)cudaGetLastError();
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and out).  pool_dtype: 0 and 1 the
// same (and then equal to q_dtype), 2 = int8 (and then sk, sv are given).
int dispatch(const void* q, const Layout& lay, const int* tables,
             const int* positions, void* out, int B, int H, int Hkv, int hd,
             int page, int max_pages, long long n_pool_pages,
             long long page_base, int window, int q_dtype, int pool_dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = lay.sk != nullptr && lay.sv != nullptr;
  if ((pool_dtype == 2) != scaled) return (int)cudaErrorInvalidValue;
#define KF_LAUNCH(TQ, TP)                                                   \
  return launch<TQ, TP>(q, lay, tables, positions, out, B, H, Hkv, hd, page, \
                        max_pages, n_pool_pages, page_base, window, s)
  if (q_dtype == 0 && pool_dtype == 0) KF_LAUNCH(float, float);
  if (q_dtype == 1 && pool_dtype == 1) KF_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && pool_dtype == 2) KF_LAUNCH(float, int8_t);
  if (q_dtype == 1 && pool_dtype == 2) KF_LAUNCH(__nv_bfloat16, int8_t);
#undef KF_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes), one per TPU entry point; both
// take the layout as pointers and strides (see struct Layout; sk = sv = null
// for fp pools) and run the same device body.  window <= 0 means no window.
// They return cudaGetLastError() after the launch (0 on success).  The
// caller checks shapes, dtypes, contiguity and the 16-byte alignment of
// every k/v vector.
#define KF_PAGED_ENTRY(NAME)                                                  \
  extern "C" int NAME(                                                        \
      const void* q, const void* k, const void* v, long long row_stride,      \
      const void* sk, const void* sv, long long s_page, long long s_slot,     \
      long long s_head, const int* tables, const int* positions, void* out,   \
      int B, int H, int Hkv, int hd, int page, int max_pages,                 \
      long long n_pool_pages, long long page_base, int window, int q_dtype,   \
      int pool_dtype, void* stream) {                                         \
    const Layout lay{k,      v,      row_stride,                              \
                     static_cast<const float*>(sk),                           \
                     static_cast<const float*>(sv),                           \
                     s_page, s_slot, s_head};                                 \
    return dispatch(q, lay, tables, positions, out, B, H, Hkv, hd, page,      \
                    max_pages, n_pool_pages, page_base, window, q_dtype,      \
                    pool_dtype, stream);                                      \
  }

// fused or split pools, every scale layout (the TPU's manual-DMA kernel)
KF_PAGED_ENTRY(kf_paged_decode_attention_dma)
// split pools with a slot-major scale pair (the TPU's BlockSpec kernel)
KF_PAGED_ENTRY(kf_paged_decode_attention)
#undef KF_PAGED_ENTRY
