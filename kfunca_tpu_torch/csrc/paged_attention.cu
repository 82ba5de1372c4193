// Paged decode attention for Hopper (sm_90a): one query token per sequence
// attends over the live pages of a paged KV pool.
//
// Replaces the TPU kernels
//   kfunca_tpu/ops/pallas_kernels/paged_attention.py:
//     paged_decode_attention_dma (body _decode_kernel_dma): fused [k|v] pool
//       or split pools, fp32/bf16/fp16 or int8 with fp32 scales, slot-major or
//       head-major scale pools;
//     paged_decode_attention (bodies _decode_kernel, _decode_kernel_mxu):
//       split pools, 4-D or flat 3-D, fp32/bf16/fp16 or int8 with a slot-major
//       scale pair.
// One device body serves both entry points: the pool forms differ only in
// where a (page, slot, kv head) vector and its scale sit, which the caller
// states as base pointers and strides (struct Layout).
//
// Contract (the same as the TPU kernels'):
//   q        (B, H, hd), already scaled by 1/sqrt(hd), fp32, bf16 or fp16
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
// and masks slots > pos and slots <= pos - window: a masked slot's p is an
// exact 0.  Query head h reads kv head h / (H / Hkv).  fp32 softmax state:
// each split's (m, l, acc), merged in split order; a row whose every slot
// was masked (l == 0) divides by 1, as the TPU kernel does.
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
// reading exactly the live bytes, each once, with enough of them in flight
// to keep HBM busy (flash-decoding):
//   * a split pass: grid (splits, Hkv x head blocks, B); a block owns a
//     fixed span of span_pages pages of one (sequence, kv head) and up to
//     four query heads of the kv head's group, so every k/v row is read
//     from HBM once for a group of up to four heads.  The number of splits
//     comes from max_pages (the table's width), never from the positions,
//     so the launch needs no host sync; a block whose span holds no live
//     page returns at once;
//   * a live block streams its span's k rows, then its v rows, through a
//     3-stage shared-memory ring of 64-slot chunks: cp.async 16-byte copies
//     in the pool's type (a zero source size for masked slots zero-fills
//     them, so dead data never enters), the next chunks in flight while one
//     is computed; values are widened to fp32 in registers.  The scores of
//     the whole span (already in the exp2 domain: q is scaled by log2 e)
//     sit in shared memory, so one softmax over the span replaces any
//     rescaling; the block writes its (m, l, acc) partials, fp32;
//   * a combine pass: grid (H, B); it recomputes each sequence's live
//     splits from its position and merges their partials in split order
//     (bitwise repeatable: no atomics anywhere), writing out in q's type;
//   * the page table is read by the blocks themselves, so only live pages
//     move.
// Left for later: a CUDA graph of the decode step (it is host-bound), and
// TMA multicast of a page across the blocks of a group.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kChunk = 64;       // slots of a ring stage (two threads a slot)
constexpr int kStages = 3;
constexpr int kHeads = 4;        // query heads of a block (one warp each in
                                 // the softmax)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes of T (4 fp32, 8 bf16 or fp16, or 16 int8 values) widened to fp32, from
// the four 32-bit words (no address is taken, so the vector stays in
// registers)
__device__ __forceinline__ void widen(uint4 raw, float (&x)[4], float) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void widen(uint4 raw, float (&x)[8],
                                      __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// fp16 has no shift to fp32 (its exponent is narrower): two values a word
// through __half22float2
__device__ __forceinline__ void widen(uint4 raw, float (&x)[8], __half) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(
        __halves2half2(__ushort_as_half((unsigned short)(w[i] & 0xffffu)),
                       __ushort_as_half((unsigned short)(w[i] >> 16))));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(uint4 raw, float (&x)[16], int8_t) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Bytes between two slots' rows in a ring stage: the row rounded up to 128
// bytes plus 32, so that the 16-byte reads of eight threads (four slots,
// two neighbouring chunks each) fall on eight different bank groups.
__host__ __device__ __forceinline__ int ring_stride(int row_bytes) {
  return (row_bytes + 127) / 128 * 128 + 32;
}

// Shared memory of a split block (bytes): the ring (or, after it, the
// reduction of the P.V partial sums) | q (kHeads x hd fp32) | scores / p
// (kHeads x span fp32) | sk, sv (span each) | page ids (span_pages) |
// m, l (kHeads each).
struct SplitSmem {
  int ring, q, s, scales, pids, total;
  __host__ __device__ SplitSmem(int hd, int elem, int span, int span_pages) {
    const int vecs = hd * elem / 16, e = 16 / elem;
    const int red = (kThreads / vecs) * kHeads * vecs * e * 4;
    ring = kStages * kChunk * ring_stride(hd * elem);
    if (red > ring) ring = red;
    q = ring;
    s = q + kHeads * hd * 4;
    scales = s + kHeads * span * 4;
    pids = scales + 2 * span * 4;
    total = pids + span_pages * 8 + 2 * kHeads * 4;
  }
};

// The live pages [first, end) of a sequence at position pos; see the
// contract above (end clamped to the table).
__device__ __forceinline__ void live_pages(int pos, int page, int max_pages,
                                           int window, int& first, int& end) {
  end = min(pos / page + 1, max_pages);
  first = 0;
  if (window > 0) {
    const int f = pos - window + 1;
    first = f > 0 ? f / page : 0;
  }
}

// A split block's live slots, [slot_lo, slot_lo + n_slots) of its
// sequence, and where their rows sit in the pools and the ring.
struct Span {
  int slot_lo, n_slots, pos, window, page, pg_lo;
  int stride, vpr;     // ring bytes a slot; 16-byte vectors a row
  long long head_off;  // pool elements to the kv head's vector
  // slot (relative to slot_lo) is attended: inside the span's live pages,
  // at or before pos and, with a window, after pos - window
  __device__ __forceinline__ bool valid(int slot) const {
    const int a = slot_lo + slot;
    return slot < n_slots && a <= pos && (window <= 0 || a > pos - window);
  }
};

// The cp.async copies of ring iteration `it` (k chunks, then v chunks)
// into its stage, masked slots zero-filled (a zero source size), then one
// commit group, empty or not, so that the groups count the iterations.
template <typename TP>
__device__ __forceinline__ void load_chunk(int it, int n_chunks,
                                            const Span& sp, const Layout& lay,
                                            const long long* pid_s,
                                            uint8_t* ring) {
  constexpr int E = 16 / sizeof(TP);
  if (it < 2 * n_chunks) {
    const TP* base = static_cast<const TP*>(it < n_chunks ? lay.k : lay.v);
    const int c = it < n_chunks ? it : it - n_chunks;
    uint8_t* st = ring + (it % kStages) * kChunk * sp.stride;
    for (int i = threadIdx.x; i < kChunk * sp.vpr; i += kThreads) {
      const int r = i / sp.vpr, cv = i - r * sp.vpr;
      const int slot = c * kChunk + r;
      const TP* src = base;
      int bytes = 0;
      if (sp.valid(slot)) {
        const int a = sp.slot_lo + slot;
        src = base +
              (pid_s[a / sp.page - sp.pg_lo] * sp.page + a % sp.page) *
                  lay.row_stride +
              sp.head_off + cv * E;
        bytes = 16;
      }
      cp_async16(st + r * sp.stride + cv * 16, src, bytes);
    }
  }
  cp_async_commit();
}

// Split pass.  grid (splits, Hkv * head blocks, B), block kThreads.  TQ: q's
// type; TP: the pools'.  part[((b * H + h) * n_splits + split) * (hd + 2)
// + d]: acc (d < hd, unnormalized), then m (log2 domain) and l.
template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const TQ* __restrict__ q, Layout lay, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ part, int H,
    int Hkv, int hd, int page, int max_pages, long long n_pool_pages,
    long long page_base, int window, int span_pages) {
  constexpr int E = 16 / sizeof(TP);  // values a 16-byte vector holds
  const int split = blockIdx.x;
  const int group = H / Hkv;
  const int n_hb = (group + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / n_hb;
  const int g0 = (blockIdx.y % n_hb) * kHeads;  // first head of the group
  const int ng = min(kHeads, group - g0);
  const int b = blockIdx.z;

  const int pos = positions[b];
  int first_live, n_live;
  live_pages(pos, page, max_pages, window, first_live, n_live);
  const int pg_lo = max(split * span_pages, first_live);
  const int pg_hi = min((split + 1) * span_pages, n_live);
  if (pg_lo >= pg_hi) return;  // no live page in this span

  const int span = span_pages * page;
  const SplitSmem L(hd, (int)sizeof(TP), span, span_pages);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* sk_s = reinterpret_cast<float*>(smem + L.scales);
  float* sv_s = sk_s + span;
  long long* pid_s = reinterpret_cast<long long*>(smem + L.pids);
  float* m_s = reinterpret_cast<float*>(pid_s + span_pages);
  float* l_s = m_s + kHeads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vpr = hd / E;  // 16-byte vectors a row
  const int stride = ring_stride(hd * (int)sizeof(TP));
  const int slot_lo = pg_lo * page;
  const int n_slots = (pg_hi - pg_lo) * page;
  const int n_chunks = (n_slots + kChunk - 1) / kChunk;
  const int n_it = 2 * n_chunks;  // k chunks, then v chunks
  const bool quantized = lay.sk != nullptr;
  const int* table = tables + (long long)b * max_pages;

  for (int i = tid; i < pg_hi - pg_lo; i += kThreads) {
    // out-of-range page ids are clamped, as XLA clamps gathers
    long long pid = (long long)table[pg_lo + i] + page_base;
    pid_s[i] = pid < 0 ? 0 : (pid >= n_pool_pages ? n_pool_pages - 1 : pid);
  }
  const TQ* qg = q + ((long long)b * H + (long long)kvh * group + g0) * hd;
  for (int i = tid; i < kHeads * hd; i += kThreads)
    q_s[i] = i < ng * hd ? to_float(qg[i]) * kLog2e : 0.f;
  __syncthreads();

  const Span sp{slot_lo, n_slots, pos, window, page, pg_lo, stride, vpr,
                (long long)kvh * hd};
  for (int it = 0; it < kStages - 1; ++it)
    load_chunk<TP>(it, n_chunks, sp, lay, pid_s, ring);

  // this kv head's scales of the span's live slots; 0 where masked, so
  // that a dead scale row is never read and p * sv is an exact 0 there
  if (quantized) {
    for (int slot = tid; slot < n_slots; slot += kThreads) {
      float a = 0.f, c = 0.f;
      if (sp.valid(slot)) {
        const int sa = slot_lo + slot;
        const long long off = pid_s[sa / page - pg_lo] * lay.s_page +
                              (sa % page) * lay.s_slot + kvh * lay.s_head;
        a = __ldg(lay.sk + off);
        c = __ldg(lay.sv + off);
      }
      sk_s[slot] = a;
      sv_s[slot] = c;
    }
  }

  // P.V: thread (ss, cv) sums slots ss, ss + n_ss, ... of each chunk for
  // columns [cv E, cv E + E) of the block's heads
  const int n_ss = kThreads / vpr;
  const int cv_pv = tid % vpr, ss = tid / vpr;
  float o[kHeads][E];
#pragma unroll
  for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
    for (int e = 0; e < E; ++e) o[gi][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();  // this iteration's chunk has landed
    __syncthreads();  // ... for every thread, and the stage to refill is free
    load_chunk<TP>(it + kStages - 1, n_chunks, sp, lay, pid_s, ring);
    const uint8_t* st = ring + (it % kStages) * kChunk * stride;
    if (it < n_chunks) {
      // scores of the chunk's slots: two threads a slot, alternate vectors
      const int r = tid >> 1, half = tid & 1;
      float a[kHeads] = {};
      for (int cv = half; cv < vpr; cv += 2) {
        float x[E];
        widen(*reinterpret_cast<const uint4*>(st + r * stride + cv * 16), x,
              TP());
#pragma unroll
        for (int gi = 0; gi < kHeads; ++gi) {
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + gi * hd + cv * E);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qq = qv[e4];
            a[gi] = fmaf(qq.x, x[4 * e4], a[gi]);
            a[gi] = fmaf(qq.y, x[4 * e4 + 1], a[gi]);
            a[gi] = fmaf(qq.z, x[4 * e4 + 2], a[gi]);
            a[gi] = fmaf(qq.w, x[4 * e4 + 3], a[gi]);
          }
        }
      }
      const int slot = it * kChunk + r;
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi) {
        a[gi] += __shfl_xor_sync(0xffffffffu, a[gi], 1);
        if (half == 0 && slot < n_slots)
          s_s[gi * span + slot] =
              sp.valid(slot) ? (quantized ? a[gi] * sk_s[slot] : a[gi])
                          : -CUDART_INF_F;
      }
      continue;
    }
    if (it == n_chunks) {
      // one softmax over the span's scores, one warp a head: p = exp2(s -
      // m), l sums the unscaled p, and p * sv goes on to P.V for int8
      if (warp < ng) {
        float* sr = s_s + warp * span;
        float mx = -CUDART_INF_F;
        for (int i = lane; i < n_slots; i += 32) mx = fmaxf(mx, sr[i]);
        mx = fmaxf(warp_max(mx), kNegInf);
        float sum = 0.f;
        for (int i = lane; i < n_slots; i += 32) {
          const float p = exp2f(sr[i] - mx);
          sum += p;
          sr[i] = quantized ? p * sv_s[i] : p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          m_s[warp] = mx;
          l_s[warp] = sum;
        }
      }
      __syncthreads();
    }
    if (ss < n_ss) {
      const int c0 = (it - n_chunks) * kChunk;
      for (int r = ss; r < kChunk && c0 + r < n_slots; r += n_ss) {
        float x[E];
        widen(*reinterpret_cast<const uint4*>(st + r * stride + cv_pv * 16), x,
              TP());
#pragma unroll
        for (int gi = 0; gi < kHeads; ++gi) {
          const float p = s_s[gi * span + c0 + r];
#pragma unroll
          for (int e = 0; e < E; ++e) o[gi][e] = fmaf(p, x[e], o[gi][e]);
        }
      }
    }
  }

  // the P.V partial sums of the n_ss slot classes, added in class order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (ss < n_ss) {
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
      for (int e = 0; e < E; ++e)
        red[(ss * kHeads + gi) * hd + cv_pv * E + e] = o[gi][e];
  }
  __syncthreads();
  const int n_splits = gridDim.x;
  for (int i = tid; i < ng * hd; i += kThreads) {
    const int gi = i / hd, d = i - gi * hd;
    float acc = 0.f;
    for (int c = 0; c < n_ss; ++c) acc += red[(c * kHeads + gi) * hd + d];
    const long long h = (long long)kvh * group + g0 + gi;
    float* dst = part + (((long long)b * H + h) * n_splits + split) * (hd + 2);
    dst[d] = acc;
    if (d == 0) {
      dst[hd] = m_s[gi];
      dst[hd + 1] = l_s[gi];
    }
  }
}

// Combine pass.  grid (H, B).  Merges the partials of sequence b's live
// splits for query head h in split order: with M the largest m, out =
// sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s (divided by 1 where the
// sum is 0: a sequence with no live page gets out = 0).
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ positions,
    TQ* __restrict__ out, int H, int hd, int page, int max_pages, int window,
    int span_pages, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  int first_live, n_live;
  live_pages(positions[b], page, max_pages, window, first_live, n_live);
  const int s_lo = first_live / span_pages;
  const int s_hi = first_live < n_live ? (n_live - 1) / span_pages : s_lo - 1;
  const float* pp = part + ((long long)b * H + h) * n_splits * (hd + 2);
  float mx = kNegInf;
  for (int s = s_lo; s <= s_hi; ++s) mx = fmaxf(mx, pp[s * (hd + 2) + hd]);
  TQ* og = out + ((long long)b * H + h) * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f, l = 0.f;
    for (int s = s_lo; s <= s_hi; ++s) {
      const float* ps = pp + s * (hd + 2);
      const float w = exp2f(ps[hd] - mx);
      acc = fmaf(w, ps[d], acc);
      l = fmaf(w, ps[hd + 1], l);
    }
    og[d] = from_float<TQ>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const Layout& lay, const int* tables,
           const int* positions, float* part, void* out, int B, int H,
           int Hkv, int hd, int page, int max_pages, long long n_pool_pages,
           long long page_base, int window, int span_pages,
           cudaStream_t stream) {
  const int n_splits = (max_pages + span_pages - 1) / span_pages;
  const int n_hb = (H / Hkv + kHeads - 1) / kHeads;
  const SplitSmem L(hd, (int)sizeof(TP), span_pages * page, span_pages);
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<TQ, TP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
  }
  paged_split_kernel<TQ, TP>
      <<<dim3(n_splits, Hkv * n_hb, B), kThreads, L.total, stream>>>(
          static_cast<const TQ*>(q), lay, tables, positions, part, H, Hkv, hd,
          page, max_pages, n_pool_pages, page_base, window, span_pages);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<TQ><<<dim3(H, B), kThreads, 0, stream>>>(
      part, positions, static_cast<TQ*>(out), H, hd, page, max_pages, window,
      span_pages, n_splits);
  return (int)cudaGetLastError();
}

// q_dtype: 0 = float32, 1 = bfloat16, 3 = float16 (q and out).  pool_dtype:
// 0, 1 and 3 the same (and then equal to q_dtype), 2 = int8 (and then sk, sv
// are given).
int dispatch(const void* q, const Layout& lay, const int* tables,
             const int* positions, void* part, void* out, int B, int H,
             int Hkv, int hd, int page, int max_pages, long long n_pool_pages,
             long long page_base, int window, int span_pages, int q_dtype,
             int pool_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = lay.sk != nullptr && lay.sv != nullptr;
  if ((pool_dtype == 2) != scaled) return (int)cudaErrorInvalidValue;
  if (span_pages <= 0 || page <= 0 || max_pages <= 0 || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define KF_LAUNCH(TQ, TP)                                                      \
  return launch<TQ, TP>(q, lay, tables, positions, p, out, B, H, Hkv, hd,      \
                        page, max_pages, n_pool_pages, page_base, window,      \
                        span_pages, s)
  if (q_dtype == 0 && pool_dtype == 0) KF_LAUNCH(float, float);
  if (q_dtype == 1 && pool_dtype == 1) KF_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && pool_dtype == 2) KF_LAUNCH(float, int8_t);
  if (q_dtype == 1 && pool_dtype == 2) KF_LAUNCH(__nv_bfloat16, int8_t);
  if (q_dtype == 3 && pool_dtype == 3) KF_LAUNCH(__half, __half);
  if (q_dtype == 3 && pool_dtype == 2) KF_LAUNCH(__half, int8_t);
#undef KF_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes), one per TPU entry point; both
// take the layout as pointers and strides (see struct Layout; sk = sv = null
// for fp pools) and run the same two device functions.  window <= 0 means
// no window.  part: fp32 scratch of B x H x n_splits x (hd + 2) values,
// n_splits = ceil(max_pages / span_pages).  They return cudaGetLastError()
// after the launches (0 on success).  The caller checks shapes, dtypes,
// contiguity and the 16-byte alignment of every k/v vector.
#define KF_PAGED_ENTRY(NAME)                                                  \
  extern "C" int NAME(                                                        \
      const void* q, const void* k, const void* v, long long row_stride,      \
      const void* sk, const void* sv, long long s_page, long long s_slot,     \
      long long s_head, const int* tables, const int* positions, void* part,  \
      void* out, int B, int H, int Hkv, int hd, int page, int max_pages,      \
      long long n_pool_pages, long long page_base, int window,                \
      int span_pages, int q_dtype, int pool_dtype, void* stream) {            \
    const Layout lay{k,      v,      row_stride,                              \
                     static_cast<const float*>(sk),                           \
                     static_cast<const float*>(sv),                           \
                     s_page, s_slot, s_head};                                 \
    return dispatch(q, lay, tables, positions, part, out, B, H, Hkv, hd,      \
                    page, max_pages, n_pool_pages, page_base, window,         \
                    span_pages, q_dtype, pool_dtype, stream);                 \
  }

// fused or split pools, every scale layout (the TPU's manual-DMA kernel)
KF_PAGED_ENTRY(kf_paged_decode_attention_dma)
// split pools with a slot-major scale pair (the TPU's BlockSpec kernel)
KF_PAGED_ENTRY(kf_paged_decode_attention)
#undef KF_PAGED_ENTRY
