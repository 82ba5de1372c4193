// The 64 x 64 fp32 attention tile shared by the flash attention kernels at
// head dim 256 (K1/K2, flash_attention.cu; at 64 and 128 fp32 runs the
// split-TF32 wgmma bodies) and the ring-attention hop kernels (K12,
// ring_hop.cu): staging a tile of rows into shared memory as fp32, the score
// product q.k over a head dim and the second product P.v, with the block
// layout both use (256 threads; thread (ty, tx) = (threadIdx.x / 16,
// threadIdx.x % 16) owns score rows ty + 16 i and columns tx + 16 j), and
// the shared-memory budget of a forward (Q | K | V | P) and a backward
// (four tiles | P, or three at head dim 256: kBwdShared) block.
// runtime/_kernels.py hashes this header into the name of every library,
// so an edit rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // q rows and kv rows per tile
constexpr int kTLD = kTile + 4;  // row stride of the P / dS tile (floats)
constexpr float kNegInf = -1e30f;
constexpr size_t kSmemLimit = 232448;  // shared memory a block can use

// A backward block keeps two resident tiles and two streamed ones (q, k,
// v, dO: 64 x (HD + 4) fp32 each) beside P.  At head dim 256 four such
// tiles and P take 283,648 bytes, past kSmemLimit, so there the two
// streamed tiles take turns in one (217,088 bytes): each is loaded for the
// products that read it, and the one read twice (k in dq, q in dk/dv) is
// loaded again.  Up to head dim 128 the four tiles stay.
template <int HD> constexpr bool kBwdShared = HD > 128;

__device__ __forceinline__ void store16(uint4 raw, float* dst, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}

// max / sum over the 16 lanes that share a row group (same ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [row0, row0 + 64) of a (n_rows, HD) matrix into shared memory
// as fp32 with row stride HD + 4; rows at or past n_rows become zeros.  A
// thread issues up to 8 of its 16-byte loads (all of them up to head dim
// 128) before it stores any: at head dim 256 its 16 would hold 64
// registers beside the accumulators.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int E = 16 / sizeof(T);
  constexpr int VPR = HD / E;  // 16-byte vectors per row
  constexpr int PER = kTile * VPR / kThreads;
  constexpr int BATCH = PER < 8 ? PER : 8;  // loads in flight
  constexpr int LD = HD + 4;
#pragma unroll
  for (int u0 = 0; u0 < PER; u0 += BATCH) {
    uint4 raw[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int r = i / VPR;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < n_rows)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * HD + (i % VPR) * E));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      store16(raw[u], dst + (i / VPR) * LD + (i % VPR) * E, T());
    }
  }
}

// s[i][j] = A[ty + 16 i, :] . B[tx + 16 j, :] over HD, both tiles in shared
// memory with row stride HD + 4.
template <int HD>
__device__ __forceinline__ void tile_scores(const float* __restrict__ A,
                                            const float* __restrict__ B,
                                            int ty, int tx, float (&s)[4][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][c] += sum_kk Tm[ty + 16 i, kk] * C[kk, col(c)], with Tm a 64 x 64
// tile (row stride kTLD) and C a 64 x HD tile (row stride HD + 4).  Thread
// tx owns columns 64 * (c / 4) + 4 * tx + (c % 4).
template <int HD>
__device__ __forceinline__ void tile_accum(const float* __restrict__ Tm,
                                           const float* __restrict__ C, int ty,
                                           int tx, float (&acc)[4][HD / 16]) {
  constexpr int LD = HD + 4;
  constexpr int NV = HD / 64;
#pragma unroll 2
  for (int kk = 0; kk < kTile; kk += 4) {
    float t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 tv =
          *reinterpret_cast<const float4*>(Tm + (ty + 16 * i) * kTLD + kk);
      t[i][0] = tv.x;
      t[i][1] = tv.y;
      t[i][2] = tv.z;
      t[i][3] = tv.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float4 cv = *reinterpret_cast<const float4*>(
            C + (kk + u) * LD + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] = fmaf(t[i][u], cv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(t[i][u], cv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(t[i][u], cv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(t[i][u], cv.w, acc[i][4 * c + 3]);
        }
      }
  }
}

template <int HD> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (HD + 4) + kTile * kTLD);
}
template <int HD> constexpr size_t bwd_smem() {
  return sizeof(float) *
         ((kBwdShared<HD> ? 3 : 4) * kTile * (HD + 4) + kTile * kTLD);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
