// int8 x int8 matmul with exact int32 accumulation and a fused rank-1
// dequantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   kfunca_tpu/ops/quant.py: matmul_q8 (body _q8_kernel).
//
// Contract (the same as the TPU kernel's):
//   a (m, k) int8 row-major, b (k, n) int8 row-major,
//   a_scale (m,) fp32, b_scale (n,) fp32
//   out[i, j] = (float(acc[i, j]) * a_scale[i]) * b_scale[j]   fp32 or bf16
// with acc the exact int32 sum over k (the caller checks k * 127^2 < 2^31).
// Any m, k, n: ragged edges are masked here, nothing is padded on the host.
//
// What bounds it: HBM bytes.  Its caller is weight-quantized decode:
// m = 8 activation rows against weights of 4096 x 4096 up to 4096 x 32000,
// about 2 operations per weight byte, far under what the card needs before
// arithmetic matters (and too few rows for the int8 tensor cores, which
// also want b k-major while the weights are stored n-major).  So b must
// stream from HBM once, at the card's rate, and everything else stays on
// chip.  The design, one launch a product:
//   * a block owns an output tile of 8 rows x 128 columns and a slice of k
//     (split-k: a skinny product has too few tiles for 132 SMs).  Its
//     slices are whole stages of 64 k rows, so no stage straddles two;
//   * a producer warp feeds a ring of 4 stages in shared memory.  A stage
//     holds b's 64 x 128 bytes and a's matching 8 x 64 bytes, brought by
//     two TMA loads (cp.async.bulk.tensor) that complete on the stage's
//     mbarrier; zeros past the tensors' edges.  Where TMA cannot take the
//     operands (n or k not a multiple of 16, a base not 16-byte aligned)
//     the producer warp copies the same tiles with ordinary loads;
//   * four consumer warps read the stage from shared memory, each 16 of
//     its k rows for all 128 columns: a lane loads one word (4 columns) of
//     4 rows, transposes the 4 x 4 bytes with __byte_perm so that each
//     register holds one column's four k values, and runs 8 rows x 4
//     columns of __dp4a against words of a that the warp reads from one
//     address (a broadcast).  Then it frees the stage for the producer;
//   * with the two blocks an SM that the host's split plan aims at (four
//     fit), 8 stages (70 KB) are in flight an SM, above the ~25 KB that
//     3.35 TB/s x ~1 us of latency over 132 SMs needs;
//   * the consumers' sums meet in shared memory.  With one slice the block
//     dequantizes and stores.  With more, it writes its int32 tile to a
//     scratch buffer, fences, and takes a ticket for the tile; the block
//     that takes the last ticket adds the slices' tiles in slice order,
//     dequantizes, stores and resets the ticket to 0 for the next launch.
//     Integer sums are exact in any order, so the output is bit-equal to
//     the plain version's and bitwise repeatable.
// The tickets are an int32 a tile that the caller zeroes once and that
// every launch leaves at zero; launches that share them must be ordered
// (one stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 8;        // rows of a (and out) per tile
constexpr int kCols = 128;      // columns of b (and out) per tile, 4 a lane
constexpr int kKt = 64;         // k rows a stage
constexpr int kStages = 4;      // depth of the ring
constexpr int kConsumers = 4;   // consumer warps, 16 k rows of a stage each
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kBTile = kKt * kCols;              // 8192 bytes
constexpr int kATile = kRows * kKt;              // 512 bytes
constexpr int kStage = kBTile + kATile;          // 8704, a multiple of 128
constexpr int kRed = kConsumers * kRows * kCols; // int32 partial sums
constexpr size_t kSmem = 128 + (size_t)kStages * kStage + kRed * 4 +
                         2 * kStages * sizeof(uint64_t) + 16;

static_assert(kStage % 128 == 0, "stages must stay 128-byte aligned");
static_assert(kKt == 16 * kConsumers, "each consumer takes 16 k rows");

__device__ __forceinline__ void store_out(float* out, long long i, float x) {
  out[i] = x;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long i,
                                          float x) {
  out[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn((float)acc, sa), sb);
}

__device__ __forceinline__ int4 add4(int4 x, int4 y) {
  return make_int4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// The producer warp's copy of one stage with ordinary loads (operands TMA
// cannot take): b rows kk .. kk + 63 of columns col0 .. col0 + 127, a rows
// row0 .. row0 + 7 of k values kk .. kk + 63; zeros past the edges.  `vec`
// says that n % 4 == 0 and b is 4-byte aligned (one word a lane and row).
__device__ __forceinline__ void copy_stage(uint8_t* bs, uint8_t* as,
                                           const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b,
                                           int kk, int col0, int row0, int m,
                                           int k, int n, bool vec, int lane) {
  const int col = col0 + 4 * lane;
  for (int r = 0; r < kKt; ++r) {
    uint32_t w = 0u;
    if (kk + r < k && col < n) {
      const int8_t* src = b + (long long)(kk + r) * n + col;
      if (vec) {
        w = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else {
        for (int c = 0; c < 4; ++c)
          if (col + c < n) w |= (uint32_t)(uint8_t)src[c] << (8 * c);
      }
    }
    *reinterpret_cast<uint32_t*>(bs + r * kCols + 4 * lane) = w;
  }
  const int i = lane >> 2, k0 = kk + 16 * (lane & 3);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row0 + i < m) {
    const int8_t* src = a + (long long)(row0 + i) * k;
    for (int c = 0; c < 16; ++c)
      if (k0 + c < k) w[c >> 2] |= (uint32_t)(uint8_t)src[k0 + c] << (8 * (c & 3));
  }
  *reinterpret_cast<uint4*>(as + i * kKt + 16 * (lane & 3)) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (ceil(n / 128), ceil(m / 8), split), block 160: warps 0-3 consume,
// warp 4 produces.  partial: (split, tiles, 8, 128) int32, tickets: one a
// tile (tile = blockIdx.y * gridDim.x + blockIdx.x); both unused when
// split == 1.
template <typename TOut, bool kTma>
__global__ void __launch_bounds__(kThreads, 4) q8_stream_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, const int8_t* __restrict__ a,
    const int8_t* __restrict__ b, const float* __restrict__ a_scale,
    const float* __restrict__ b_scale, TOut* __restrict__ out,
    int* __restrict__ partial, int* __restrict__ tickets, int m, int k, int n,
    int k_per_split, bool vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  uint8_t* ring = smem_raw + ((128 - (base & 127)) & 127);
  int* red = reinterpret_cast<int*>(ring + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kRed);
  uint64_t* empty = full + kStages;
  int* last = reinterpret_cast<int*>(empty + kStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * kCols, row0 = blockIdx.y * kRows;
  const int split = gridDim.z;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int nst = (k_end - k_begin + kKt - 1) / kKt;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], kTma ? 1 : 32);  // expect_tx, or each lane
      hopper::mbar_init(&empty[s], kConsumers);    // one arrival a consumer
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    if (kTma && lane != 0) return;
    for (int st = 0; st < nst; ++st) {
      const int slot = st % kStages;
      if (st >= kStages) hopper::mbar_wait(&empty[slot], (st / kStages - 1) & 1);
      uint8_t* bs = ring + slot * kStage;
      const int kk = k_begin + st * kKt;
      if (kTma) {
        hopper::mbar_expect_tx(&full[slot], kStage);
        hopper::tma_load_2d(bs, &map_b, &full[slot], col0, kk);
        hopper::tma_load_2d(bs + kBTile, &map_a, &full[slot], kk, row0);
      } else {
        copy_stage(bs, bs + kBTile, a, b, kk, col0, row0, m, k, n, vec, lane);
        __syncwarp();
        hopper::mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // consumer warp `warp`: k rows 16 warp .. 16 warp + 15 of every stage
  int acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  for (int st = 0; st < nst; ++st) {
    const int slot = st % kStages;
    hopper::mbar_wait(&full[slot], (st / kStages) & 1);
    const uint8_t* bs = ring + slot * kStage;
    const uint8_t* as = bs + kBTile;
    // word g of av[i]: a[row0 + i, 4 g .. 4 g + 3] of this warp's 16 rows
    uint4 av[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      av[i] = *reinterpret_cast<const uint4*>(as + i * kKt + 16 * warp);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint8_t* bp = bs + (16 * warp + 4 * g) * kCols + 4 * lane;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(bp + kCols);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(bp + 2 * kCols);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(bp + 3 * kCols);
      // 4 x 4 byte transpose: c[j] = column j's four k values
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      const int c0 = (int)__byte_perm(t0, t1, 0x5410);
      const int c1 = (int)__byte_perm(t0, t1, 0x7632);
      const int c2 = (int)__byte_perm(t2, t3, 0x5410);
      const int c3 = (int)__byte_perm(t2, t3, 0x7632);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int aw = (int)(g == 0 ? av[i].x : g == 1 ? av[i].y
                             : g == 2 ? av[i].z : av[i].w);
        acc[i][0] = __dp4a(aw, c0, acc[i][0]);
        acc[i][1] = __dp4a(aw, c1, acc[i][1]);
        acc[i][2] = __dp4a(aw, c2, acc[i][2]);
        acc[i][3] = __dp4a(aw, c3, acc[i][3]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot]);
  }

  // the consumers' sums meet in shared memory: red[warp][row][column]
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    *reinterpret_cast<int4*>(red + (warp * kRows + i) * kCols + 4 * lane) =
        make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  hopper::bar_sync(1, 32 * kConsumers);
  // thread tid: columns 4 q .. 4 q + 3 of rows i0, i0 + 1
  const int q = tid & 31, i0 = 2 * (tid >> 5);
  int4 sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      sum[r] = add4(sum[r], *reinterpret_cast<const int4*>(
                                red + (w * kRows + i0 + r) * kCols + 4 * q));
  }
  if (split > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const long long tiles = (long long)gridDim.x * gridDim.y;
    int4* mine = reinterpret_cast<int4*>(partial) +
                 (blockIdx.z * tiles + tile) * (kRows * kCols / 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) mine[(i0 + r) * (kCols / 4) + q] = sum[r];
    __threadfence();  // the tile is visible before the ticket is taken
    hopper::bar_sync(1, 32 * kConsumers);
    if (tid == 0) *last = atomicAdd(&tickets[tile], 1) == split - 1;
    hopper::bar_sync(1, 32 * kConsumers);
    if (!*last) return;
    __threadfence();
    const int4* all = reinterpret_cast<const int4*>(partial) +
                      tile * (kRows * kCols / 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] = make_int4(0, 0, 0, 0);
      for (int z = 0; z < split; ++z)
        sum[r] = add4(sum[r], __ldcg(all + z * tiles * (kRows * kCols / 4) +
                                     (i0 + r) * (kCols / 4) + q));
    }
    if (tid == 0) tickets[tile] = 0;  // ready for the next launch
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = row0 + i0 + r;
    if (gi >= m) continue;
    const float sa = a_scale[gi];
    const int v[4] = {sum[r].x, sum[r].y, sum[r].z, sum[r].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = col0 + 4 * q + c;
      if (gj < n) store_out(out, (long long)gi * n + gj, dequant(v[c], sa, b_scale[gj]));
    }
  }
}

// a row-major int8 matrix (rows x cols) as a TMA map read in boxes of
// box_cols x box_rows bytes, no swizzle, zeros past the edges
bool make_map_u8(CUtensorMap* map, const void* base, int rows, int cols,
                 int box_cols, int box_rows) {
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t one[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TOut, bool kTma>
int launch(const int8_t* a, const int8_t* b, const float* a_scale,
           const float* b_scale, void* out, int* partial, int* tickets,
           int ticket_count, int m, int k, int n, int split, int k_per_split,
           cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows, split);
  if (split > 1 &&
      (partial == nullptr || tickets == nullptr ||
       (long long)grid.x * grid.y > ticket_count))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a{}, map_b{};
  if (kTma && (!make_map_u8(&map_a, a, m, k, kKt, kRows) ||
               !make_map_u8(&map_b, b, k, n, kCols, kKt)))
    return (int)cudaErrorInvalidValue;
  auto kernel = q8_stream_kernel<TOut, kTma>;
  // the attribute belongs to the current device's context: set it on
  // every launch, as the other sources do
  const cudaError_t e = hopper::allow_smem(kernel, kSmem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  kernel<<<grid, kThreads, kSmem, stream>>>(
      map_a, map_b, a, b, a_scale, b_scale, static_cast<TOut*>(out), partial,
      tickets, m, k, n, k_per_split, vec);
  return (int)cudaGetLastError();
}

template <typename TOut>
int dispatch(const int8_t* a, const int8_t* b, const float* a_scale,
             const float* b_scale, void* out, int* partial, int* tickets,
             int ticket_count, int m, int k, int n, int split,
             int k_per_split, cudaStream_t s) {
  const bool tma = n % 16 == 0 && k > 0 && k % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (tma)
    return launch<TOut, true>(a, b, a_scale, b_scale, out, partial, tickets,
                              ticket_count, m, k, n, split, k_per_split, s);
  return launch<TOut, false>(a, b, a_scale, b_scale, out, partial, tickets,
                             ticket_count, m, k, n, split, k_per_split, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  out_dtype: 0 = float32,
// 1 = bfloat16.  The caller's plan: `split` slices of k_per_split k rows (a
// multiple of 64; split = ceil(k / k_per_split), and 1 when k = 0).  With split > 1,
// `partial` is a caller-allocated (split, ceil(m / 8) * ceil(n / 128), 8,
// 128) int32 scratch buffer and `tickets` at least ceil(m / 8) * ceil(n /
// 128) int32 that are zero (every launch leaves them so).  One launch;
// returns cudaGetLastError() after it (0 on success).  The caller checks
// shapes, dtypes, contiguity and that k cannot overflow the accumulator.
extern "C" int kf_matmul_q8(const void* a, const void* b, const void* a_scale,
                            const void* b_scale, void* out, void* partial,
                            void* tickets, int ticket_count, int m, int k,
                            int n, int split, int k_per_split, int out_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // k = 0 is one slice with no stage: the sums stay 0 and are dequantized
  if (m <= 0 || k < 0 || n <= 0 || split < 1 || k_per_split <= 0 ||
      k_per_split % kKt != 0 ||
      (k == 0 ? split != 1
              : (long long)(split - 1) * k_per_split >= k ||
                    (long long)split * k_per_split < k))
    return (int)cudaErrorInvalidValue;
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  int* pp = static_cast<int*>(partial);
  int* tp = static_cast<int*>(tickets);
  if (out_dtype == 0)
    return dispatch<float>(ap, bp, sa, sb, out, pp, tp, ticket_count, m, k, n,
                           split, k_per_split, s);
  if (out_dtype == 1)
    return dispatch<__nv_bfloat16>(ap, bp, sa, sb, out, pp, tp, ticket_count,
                                   m, k, n, split, k_per_split, s);
  return (int)cudaErrorInvalidValue;
}
