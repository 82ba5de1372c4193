// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends over the live pages of a fused [k|v] paged KV pool.
//
// Replaces the TPU kernel
//   kfunca_tpu/ops/pallas_kernels/paged_attention.py: paged_decode_attention_dma
//   (body _decode_kernel_dma), fused fp32/bf16 branch (no int8 KV scales).
//
// Contract (the same as the TPU kernel's):
//   q        (B, H, hd), already scaled by 1/sqrt(hd)
//   pool     (n_pool_pages, page, 2*Hkv*hd) rows [k heads | v heads]; the
//            serving engine passes its layer-stacked pool flattened, with
//            page_base = layer * n_pages selecting the layer
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
// Pages outside [first_live, n_live) are never read, and masked slots of a
// live page are zeroed on load, so NaN there cannot reach the output.
//
// What bounds it: HBM bytes.  Each decode step reads every live KV page
// once (B * live_slots * 2*Hkv*hd elements) and does only ~2 flops per
// byte read, far under the ~295 flop/byte a Hopper card needs before
// compute matters.  The design therefore aims at reading exactly the live
// bytes, each once, with wide loads:
//   * one thread block per (kv head, sequence); the block keeps its GQA
//     group's H/Hkv query rows in shared memory, so every k/v row is read
//     from HBM once and used by all the query heads that share it;
//   * the block walks the live pages in chunks of ~64 slots; each chunk's
//     k and v rows of this kv head are fetched with coalesced 16-byte
//     loads (all the block's loads for a chunk are in flight together),
//     converted to fp32 in shared memory, then scored, softmaxed (one warp
//     per query row) and accumulated;
//   * the page table is read by the block itself, so only live pages move.
// Left for later: splitting long sequences over several blocks (flash-
// decoding) to fill all 132 SMs at small batch, and cp.async/TMA double
// buffering so the next chunk's loads overlap this chunk's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kChunkSlots = 64;

constexpr int kLoadBatch = 8;  // 16-byte loads per thread per tensor in flight

// 16 bytes of T (4 fp32 or 8 bf16) widened to fp32 in shared memory
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

// grid (Hkv, B), block kThreads.  Shared memory (fp32):
//   q_s (G, hd) | acc_s (G, hd) | k_s (C, hd+1) | v_s (C, hd) | p_s (G, C)
//   | m_s, l_s, alpha_s (G each)       with G = H/Hkv, C = chunk slots.
// k_s rows are padded by one float so the score loop, where neighbouring
// threads read neighbouring rows at the same column, is free of bank
// conflicts.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ positions,
    T* __restrict__ out, int H, int Hkv, int hd, int page, int max_pages,
    long long n_pool_pages, long long page_base, int window, int chunk_pages) {
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
  float* m_s = p_s + group * C;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const T* qg = q + ((long long)b * H + (long long)kvh * group) * hd;
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
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  const int vec_per_row = hd / E;
  const long long row_len = 2LL * Hkv * hd;
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
          const T* src = pool + (pid * page + (r % page)) * row_len +
                         (long long)kvh * hd + (i - r * vec_per_row) * E;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(src));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(src + (long long)Hkv * hd));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n_vec) {
          const int r = i / vec_per_row;
          const int c = (i - r * vec_per_row) * E;
          store16(kr[u], k_s + r * ks + c, T());
          store16(vr[u], v_s + r * hd + c, T());
        }
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
        s = a;
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
        pr[r] = p;
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

  T* og = out + ((long long)b * H + (long long)kvh * group) * hd;
  for (int i = tid; i < group * hd; i += blockDim.x) {
    float l = l_s[i / hd];
    if (l == 0.f) l = 1.f;
    og[i] = from_float<T>(acc_s[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* pool, const int* tables,
           const int* positions, void* out, int B, int H, int Hkv, int hd,
           int page, int max_pages, long long n_pool_pages,
           long long page_base, int window, cudaStream_t stream) {
  const int chunk_pages = page >= kChunkSlots ? 1 : kChunkSlots / page;
  const int C = chunk_pages * page;
  const int group = H / Hkv;
  const size_t smem = sizeof(float) * ((size_t)2 * group * hd +
                                       (size_t)C * (hd + 1) + (size_t)C * hd +
                                       (size_t)group * C + 3 * (size_t)group);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), tables,
      positions, static_cast<T*>(out), H, Hkv, hd, page, max_pages,
      n_pool_pages, page_base, window, chunk_pages);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 for q, pool and out alike.  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, dtypes, contiguity and 16-byte alignment of the pool.
extern "C" int kf_paged_decode_attention_dma(
    const void* q, const void* pool, const int* tables, const int* positions,
    void* out, int B, int H, int Hkv, int hd, int page, int max_pages,
    long long n_pool_pages, long long page_base, int window, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, pool, tables, positions, out, B, H, Hkv,
                                 hd, page, max_pages, n_pool_pages, page_base,
                                 window, s);
  if (dtype == 0)
    return launch<float>(q, pool, tables, positions, out, B, H, Hkv, hd, page,
                         max_pages, n_pool_pages, page_base, window, s);
  return (int)cudaErrorInvalidValue;
}
