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
// far past the card's ~295), so the tensor cores' rate, which only wgmma
// reaches, and keeping them fed.  Three device bodies, chosen from the
// input type and the shape before the launch (ops/pallas_kernels/
// matmul.route states the rule):
//   * bf16 / fp16 with k % 8 == 0 and n % 8 == 0 and 16-byte aligned a and
//     b (every row then starts on 16 bytes, as TMA needs; any m): wgmma fed
//     by TMA.  A block of three warpgroups owns a 128 x BN output tile (BN
//     = 64, 128 or 256: the launch's choice, runtime/autotune.py sweeps
//     them).  Warpgroup 0 is the producer: one thread keeps a ring of
//     stages full, each a 128 x 64 box of a (K-major) and BN / 64 boxes of
//     64 x 64 of b (MN-major: b is read in place, as wgmma's transpose-B
//     operand), 128-byte swizzled, signalled on a full barrier per stage;
//     setmaxnreg gives it 40 registers.  Warpgroups 1 and 2 each run
//     wgmma m64nBNk16 over 64 rows of the tile (four k16 steps a stage),
//     fp32 accumulators in registers (232 registers a thread), and hand a
//     stage back on its empty barrier once the wgmma that read it has
//     completed (one group stays in flight).  TMA zero-fills the boxes
//     past the edges, so ragged m, n and k need no padding.  The epilogue
//     runs on the accumulator registers and stores the masked tile;
//   * bf16 / fp16 otherwise (a row stride TMA cannot take): mma.sync
//     m16n8k16 with fp32 accumulators, one fixed 128 x 64 tile (8 warps as
//     2 x 4, a warp 64 x 16), k steps of 32 staged in one shared buffer
//     with 16-byte loads;
//   * fp32 and int8: CUDA-core FMA.  A block of 256 threads owns a
//     128 x 128 tile, a thread 8 x 8 of it from registers, over k steps of
//     8 staged in shared memory (a transposed).
// The TPU kernel's (2048, 512, 2048) VMEM blocks and its sequential k grid
// do not carry over: the k loop runs inside the block, and the blocks of
// the output tile grid run at once.
// Left for later: a persistent grid (one tile's epilogue overlapping the
// next one's loads), TMA stores of the output, clusters with multicast
// loads, and a tensor-core path for fp32 (TF32 is not the contract) and
// int8.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// the epilogue on two adjacent columns, called (not inlined) from the wgmma
// body's unrolled store loop, which would otherwise hold 64-128 inlined
// copies of it
__device__ __noinline__ float2 epilogue_pair(float v0, float v1, int row,
                                             int col, int n,
                                             const Epilogue& e) {
  return make_float2(apply_epilogue(v0, row, col, n, e),
                     apply_epilogue(v1, row, col + 1, n, e));
}

// two adjacent columns (col even, col + 1 < n when col < n: n % 8 == 0) of
// one row, the epilogue applied to each, stored as one 4- or 8-byte word;
// the output type is a template parameter, so the caller's unrolled loop
// over its accumulator registers holds no branch on it
template <int kCode>
__device__ __forceinline__ void finish2(void* out, int row, int col, int m,
                                        int n, float v0, float v1,
                                        const Epilogue& e) {
  if (row >= m || col >= n) return;
  const long long i = (long long)row * n + col;
  if (e.any) {
    const float2 v = epilogue_pair(v0, v1, row, col, n, e);
    v0 = v.x;
    v1 = v.y;
  }
  if (kCode == 6) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + i) =
        __floats2half2_rn(v0, v1);
  } else if (kCode == 7) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i) =
        __floats2bfloat162_rn(v0, v1);
  } else if (kCode == 8) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(v0, v1);
  } else {
    store(out, 4, i, v0);
    store(out, 4, i + 1, v1);
  }
}

// the m64nN accumulator of one consumer warpgroup stored from its
// registers: warp w of the group holds rows 16w + g and 16w + g + 8 of the
// 64, columns 8j + 2t and 8j + 2t + 1 of each 8-wide chunk j
template <int kCode, int N>
__device__ __forceinline__ void store_acc(void* out, int row, int col, int m,
                                          int n, const float (&acc)[N / 2],
                                          const Epilogue& e) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      finish2<kCode>(out, row + 8 * i, col + 8 * j, m, n, acc[4 * j + 2 * i],
                     acc[4 * j + 2 * i + 1], e);
}

// -- bf16 / fp16, other strides: mma.sync m16n8k16, fp32 accumulators -----

constexpr int kBK = 32;
constexpr int kAStride = kBK + 8;  // shared row strides, in 16-bit elements

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

// BM x BN output tile: a warp owns BM/2 x BN/4 of it, MI x NI mma tiles
template <bool kBf16, int BM, int BN>
__global__ void __launch_bounds__(kThreads) mma_gemm_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
    void* __restrict__ out, int out_code, int m, int n, int k, Epilogue e,
    bool a_vec, bool b_vec) {
  constexpr int MI = BM / 32, NI = BN / 32;
  constexpr int kBStride = BN + 8;
  constexpr int kBChunks = BN / 8;  // 8-element chunks in a row of b
  __shared__ __align__(16) uint16_t as[BM * kAStride];
  __shared__ __align__(16) uint16_t bs[kBK * kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // a tile: BM rows x 32 columns, 4 chunks of 8 a row
    for (int c = tid; c < BM * kBK / 8; c += kThreads) {
      const int r = c >> 2, kc = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) v = load8(a + (long long)(m0 + r) * k, k0 + kc, k, a_vec);
      *reinterpret_cast<uint4*>(as + r * kAStride + kc) = v;
    }
    // b tile: 32 rows x BN columns, BN / 8 chunks of 8 a row
    for (int c = tid; c < kBK * kBChunks; c += kThreads) {
      const int r = c / kBChunks, nc = (c % kBChunks) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k) v = load8(b + (long long)(k0 + r) * n, n0 + nc, n, b_vec);
      *reinterpret_cast<uint4*>(bs + r * kBStride + nc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint16_t* p =
            as + (wm * (BM / 2) + mi * 16 + g) * kAStride + kk + t4 * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint16_t* p =
            bs + (kk + t4 * 2) * kBStride + wn * (BN / 4) + ni * 8 + g;
        bf[ni][0] = p[0] | ((uint32_t)p[kBStride] << 16);
        bf[ni][1] = p[8 * kBStride] | ((uint32_t)p[9 * kBStride] << 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma16816<kBf16>(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * (BM / 2) + mi * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn * (BN / 4) + ni * 8 + t4 * 2 + (r & 1);
        finish(out, out_code, row, col, m, n, acc[mi][ni][r], e);
      }
}

constexpr int kMmaBM = 128, kMmaBN = 64;  // the body's one tile

template <bool kBf16, int BM, int BN>
int launch_mma(const uint16_t* a, const uint16_t* b, void* out, int out_code,
               int m, int n, int k, const Epilogue& e, bool a_vec, bool b_vec,
               cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mma_gemm_kernel<kBf16, BM, BN><<<grid, kThreads, 0, s>>>(
      a, b, out, out_code, m, n, k, e, a_vec, b_vec);
  return (int)cudaGetLastError();
}

// -- bf16 / fp16, k % 8 == 0, n % 8 == 0: wgmma fed by TMA --------------------

constexpr int kWgBM = 128;       // output rows of a block: 2 consumers x 64
constexpr int kWgBK = 64;        // k per stage: one 128-byte row of a's box
constexpr int kWgThreads = 384;  // producer warpgroup + two consumers

template <int BN>
struct WgTile {
  static constexpr int kABytes = kWgBM * kWgBK * 2;      // 16 KB
  static constexpr int kBBytes = kWgBK * BN * 2;         // BN / 64 boxes of 8 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = (192 * 1024) / kStageBytes;  // 4, 6 or 8
  static constexpr size_t kSmem =
      (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + 1024;
};

template <bool kBf16, int BN>
__global__ void __launch_bounds__(kWgThreads, 1) wgmma_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, void* __restrict__ out,
    int out_code, int m, int n, int k, Epilogue e) {
  using T = WgTile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::kStageBytes);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / 128;
  // grouped order: consecutive blocks walk 8 row tiles of a column band, so
  // the blocks in flight share a and b panels in L2
  const int tiles_m = (m + kWgBM - 1) / kWgBM, tiles_n = (n + BN - 1) / BN;
  const int per_group = 8 * tiles_n;
  const int first_m = (blockIdx.x / per_group) * 8;
  const int group_m = min(tiles_m - first_m, 8);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * kWgBM;
  const int n0 = (in_group / group_m) * BN;
  const int nk = (k + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect_tx
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        hopper::mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        uint8_t* st = smem + s * T::kStageBytes;
        hopper::mbar_expect_tx(&full[s], T::kStageBytes);
        hopper::tma_load_2d(st, &map_a, &full[s], kt * kWgBK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(st + T::kABytes + j * 8192, &map_b, &full[s],
                              n0 + 64 * j, kt * kWgBK);
      }
    }
  } else {  // consumers: rows 64 (wg - 1) .. of the tile
    hopper::regs_inc<232>();
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      hopper::mbar_wait(&full[s], (kt / S) & 1);
      const uint8_t* st = smem + s * T::kStageBytes;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // a: K-major, rows 64c.., k16 step = 32 bytes along the row;
        // b: MN-major, k16 step = 16 rows of 128 bytes, 64 columns a box
        const uint64_t da = hopper::desc_sw128(st + c * 8192 + kk * 32, 16, 1024);
        const uint64_t db =
            hopper::desc_sw128(st + T::kABytes + kk * 2048, 8192, 1024);
        hopper::wgmma_ss<kBf16, 1>(acc, da, db, 1);
      }
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      // the previous stage's products are done: hand it back
      hopper::wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0)
        hopper::mbar_arrive(&empty[(kt - 1) % S]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3;
    const int row = m0 + 64 * c + 16 * w + (lane >> 2);
    const int col = n0 + 2 * (lane & 3);
    switch (out_code) {
      case 6: store_acc<6, BN>(out, row, col, m, n, acc, e); break;
      case 7: store_acc<7, BN>(out, row, col, m, n, acc, e); break;
      case 8: store_acc<8, BN>(out, row, col, m, n, acc, e); break;
      default: store_acc<4, BN>(out, row, col, m, n, acc, e); break;
    }
  }
}

template <bool kBf16, int BN>
int launch_wgmma(const void* a, const void* b, void* out, int out_code, int m,
                 int n, int k, const Epilogue& e, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t dims_b[2] = {(uint64_t)n, (uint64_t)k};
  const uint64_t stride_a[1] = {(uint64_t)k * 2}, stride_b[1] = {(uint64_t)n * 2};
  const uint32_t box_a[2] = {kWgBK, kWgBM}, box_b[2] = {64, kWgBK};
  if (!hopper::make_map(&map_a, a, kBf16, 2, dims_a, stride_a, box_a) ||
      !hopper::make_map(&map_b, b, kBf16, 2, dims_b, stride_b, box_b))
    return (int)cudaErrorInvalidValue;
  const size_t smem = WgTile<BN>::kSmem;
  const cudaError_t err =
      hopper::allow_smem(wgmma_gemm_kernel<kBf16, BN>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((n + BN - 1) / BN) * ((m + kWgBM - 1) / kWgBM);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  wgmma_gemm_kernel<kBf16, BN><<<(unsigned)tiles, kWgThreads, smem, s>>>(
      map_a, map_b, out, out_code, m, n, k, e);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int launch_wgmma_tile(const void* a, const void* b, void* out, int out_code,
                      int m, int n, int k, const Epilogue& e, int bm, int bn,
                      cudaStream_t s) {
  if (bm != kWgBM) return (int)cudaErrorInvalidValue;
  if (bn == 256)
    return launch_wgmma<kBf16, 256>(a, b, out, out_code, m, n, k, e, s);
  if (bn == 128)
    return launch_wgmma<kBf16, 128>(a, b, out, out_code, m, n, k, e, s);
  if (bn == 64)
    return launch_wgmma<kBf16, 64>(a, b, out, out_code, m, n, k, e, s);
  return (int)cudaErrorInvalidValue;
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
// act: 0 none, 1 tanh-GELU, 2 SiLU, 3 ReLU.  body (bf16 / fp16 only): 1 the
// wgmma body, with output tile (bm, bn) = (128, 64 / 128 / 256), which
// needs k % 8 == 0, n % 8 == 0 and 16-byte aligned a and b; 0 the mma.sync
// body, tile (128, 64).  fp32 and int8 take body 0 and tile (128, 128).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments no body takes.
extern "C" int kf_matmul(const void* a, const void* b, const void* bias,
                         const void* residual, void* out, int in_code,
                         int out_code, int m, int k, int n, int act, int bm,
                         int bn, int body, void* stream) {
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
    if (body == 1) {
      const bool tma = k % 8 == 0 && n % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
      if (!tma) return (int)cudaErrorInvalidValue;
      if (in_code == 7)
        return launch_wgmma_tile<true>(a, b, out, out_code, m, n, k, e, bm, bn,
                                       s);
      return launch_wgmma_tile<false>(a, b, out, out_code, m, n, k, e, bm, bn,
                                      s);
    }
    if (body != 0 || bm != kMmaBM || bn != kMmaBN)
      return (int)cudaErrorInvalidValue;
    const bool a_vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const bool b_vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    const uint16_t* ap = static_cast<const uint16_t*>(a);
    const uint16_t* bp = static_cast<const uint16_t*>(b);
    if (in_code == 7)
      return launch_mma<true, kMmaBM, kMmaBN>(ap, bp, out, out_code, m, n, k,
                                              e, a_vec, b_vec, s);
    return launch_mma<false, kMmaBM, kMmaBN>(ap, bp, out, out_code, m, n, k, e,
                                             a_vec, b_vec, s);
  }
  if (body != 0 || bm != kSB || bn != kSB) return (int)cudaErrorInvalidValue;
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
