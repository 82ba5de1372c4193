// Causal flash attention for Hopper (sm_90a): forward with per-row
// logsumexp (K1) and backward dq / dk / dv (K2), with grouped kv heads (GQA)
// and an optional sliding window.
//
// Replaces the TPU kernels of
//   kfunca_tpu/ops/pallas_kernels/flash_attention.py:
//     flash_attention_fwd_stats / flash_attention_forward (body _fwd_kernel)
//     flash_attention_backward (body _fused_bwd_kernel)
//
// Contract:
//   q, g, out, dq (B, H, Sq, hd); k, v, dk, dv (B, Hkv, Skv, hd); all
//   contiguous, one dtype (fp32 or bf16); hd is 64 or 128 here (the Python
//   wrapper zero-pads other head dims and passes the scale of the true one).
//   scores = scale * q.k; row i attends column j when j <= i, j < Skv and,
//   with a window, j > i - window (top-left aligned causal mask).  Query
//   head h reads kv head h / (H / Hkv).
//   Softmax state (running max, running sum, accumulator) is fp32.  Masked
//   scores count as the finite -1e30 for the running max and contribute an
//   explicit 0 to the sums, so a row that sees no valid column ends with
//   l == 0: it divides by 1 (out = 0) and gets lse = 0, never -inf.  The
//   backward recomputes P = exp(scale * q.k - lse) with the same explicit 0
//   on masked pairs, so such rows, and kv rows that no q row reads, get
//   exact-zero gradients.  lse = m + log(l) is the natural logarithm.
//   fp32 inputs run in plain fp32 FFMA (never TF32).  bf16 inputs run
//   every product on the tensor cores from the bf16 tiles with fp32
//   accumulators, and round P (and, backward, dS) to bf16 before the
//   second products, as the TPU kernel does (_mxu_in); the forward's l sums
//   the fp32 P before that rounding, as the TPU kernel's does.  out, dq,
//   dk, dv are rounded once on the way out.
//
// What bounds it: operations.  At the training shape (B=1, H=32, Hkv=8,
// S=8192, hd=128, window 4096) the forward does 4*hd flops per unmasked
// (row, column) pair and moves ~0.17 GB: thousands of flops per byte,
// against the ~295 flop/byte where a Hopper card's tensor cores, not its
// memory, become the limit.  The backward does 10*hd per pair (its two
// kernels recompute S and dP, 14*hd).
//
// What the designs do about that:
//   * every body visits only live tiles: tiles above the diagonal or wholly
//     behind the window are never loaded or multiplied (the work is
//     O(S * window)), and only tiles that cross the diagonal, the window's
//     edge or a sequence's end test each pair;
//   * the backward is two kernels that each own what they write (dq per q
//     tile; dk, dv per kv tile with the GQA group summed in registers), so
//     there are no atomics, no per-head partials in memory, and the
//     gradients are bitwise repeatable; a small pre-pass computes
//     delta = rowsum(dO * O);
//   * fp32 inputs (K1 and K2): 64 x 64 fp32 tiles (attention_tile.cuh,
//     shared with K12): q, k, v (and dO) tiles in shared memory as fp32
//     with rows padded by 4 floats; each of the 256 threads keeps a 4 x 4
//     block of the score tile and a 4 x (hd/16) block of the output tile in
//     registers; the ceiling is the 67 TFLOP/s fp32 pipe;
//   * bf16 inputs (K1 and K2): wgmma, one thread of a producer issuing TMA
//     loads of 128-byte swizzled boxes (hopper.cuh) into a ring of 2 (K2)
//     or 3 (K1) stages, fp32 accumulators in the consumers' registers;
//     blocks of a producer warpgroup (setmaxnreg leaves it 24 registers)
//     and two consumer warpgroups (240).  The K1 kernel keeps 128 q rows
//     resident and streams 64-row k and v tiles over the live range; each
//     consumer runs S = Q.K^T for its 64 rows, the online softmax in
//     registers in the exp2 domain (a row's max and sum over the four
//     lanes of a quad) and O += P.V with P as the register A operand and v
//     read MN-major (transpose-B).  The dk/dv kernel keeps 64 kv rows of k
//     and v resident and streams 64-row q and dO tiles (with their lse and
//     delta) over the group's heads; one consumer computes the transposed
//     tile S^T = K.Q^T, P^T and dV += P^T.dO, the other dP^T = V.dO^T,
//     dS^T (with the first's P^T, passed through shared memory) and
//     dK += dS^T.Q: P^T and dS^T are the register A operand (the
//     accumulator layout of a 64-row wgmma is its A fragment layout), dO
//     and q are read MN-major (transpose-B).  The dq
//     kernel keeps 128 q rows of q and dO resident, streams 64-row k and v
//     tiles, and computes dQ += dS.K the same way.
// Left for later: overlapping one tile's softmax with the next tile's
// products (two score buffers or accumulator sets a consumer, FA3's
// intra-warpgroup pipelining), a persistent grid, fusing the dq pass into
// the dk/dv pass, and moving K12 (ring_hop.cu, still on the fp32 tile) onto
// the K1 / K2 wgmma bodies.

#include <math_constants.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace {

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ bool attends(int row, int col, int Sq, int Skv,
                                        int window) {
  return col <= row && col < Skv && row < Sq &&
         (window <= 0 || col > row - window);
}

// rows [row0, row0 + 64) of an (n_rows, HD) output from the per-thread
// accumulators, scaled per row
template <typename T, int HD>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, int row0,
                                           int n_rows, int ty, int tx,
                                           const float (&acc)[4][HD / 16],
                                           const float (&mul)[4]) {
  constexpr int NV = HD / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c)
      store4(dst + (long long)row * HD + c * 64 + tx * 4,
             acc[i][4 * c + 0] * mul[i], acc[i][4 * c + 1] * mul[i],
             acc[i][4 * c + 2] * mul[i], acc[i][4 * c + 3] * mul[i]);
  }
}

// first and last kv tile a q tile starting at row0 reads (last < first: none)
__device__ __forceinline__ void kv_tile_range(int row0, int Sq, int Skv,
                                              int window, int& first,
                                              int& last) {
  const int row_last = min(row0 + kTile - 1, Sq - 1);
  last = min(row_last, Skv - 1) / kTile;
  first = 0;
  if (window > 0 && row0 - window + 1 > 0) first = (row0 - window + 1) / kTile;
}

// ---------------------------------------------------------------------------
// K1: forward.  grid (q tiles, H, B); the heaviest (last) q tiles start first.
// Shared memory (fp32): Q | K | V (64 x (HD+4) each) | P (64 x 68).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int Sq,
    int Skv, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = HD + 4;
  float* Q_s = smem;
  float* K_s = Q_s + kTile * LD;
  float* V_s = K_s + kTile * LD;
  float* P_s = V_s + kTile * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qh = q + ((long long)b * H + h) * Sq * HD;
  const T* kh = k + ((long long)b * Hkv + kvh) * Skv * HD;
  const T* vh = v + ((long long)b * Hkv + kvh) * Skv * HD;
  load_tile<T, HD>(Q_s, qh, row0, Sq);

  float m[4], l[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  int kt_first, kt_last;
  kv_tile_range(row0, Sq, Skv, window, kt_first, kt_last);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(K_s, kh, col0, Skv);
    load_tile<T, HD>(V_s, vh, col0, Skv);
    __syncthreads();

    float s[4][4];
    tile_scores<HD>(Q_s, K_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = attends(row, col0 + tx + 16 * j, Sq, Skv, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        P_s[(ty + 16 * i) * kTLD + tx + 16 * j] = p;
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows ty + 16 i are written and read by this warp only
    tile_accum<HD>(P_s, V_s, ty, tx, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  store_tile<T, HD>(out + ((long long)b * H + h) * Sq * HD, row0, Sq, ty, tx,
                    acc, inv);
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row < Sq)
        lse[((long long)b * H + h) * Sq + row] =
            l[i] == 0.f ? 0.f : m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2, pre-pass: delta[row] = sum_d g[row, d] * out[row, d]; one warp per row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void flash_delta_kernel(const T* __restrict__ g,
                                   const T* __restrict__ out,
                                   float* __restrict__ delta,
                                   long long n_rows, int hd) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float a = 0.f;
  for (int d = lane; d < hd; d += 32)
    a = fmaf(to_float(g[row * hd + d]), to_float(out[row * hd + d]), a);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (lane == 0) delta[row] = a;
}

// ---------------------------------------------------------------------------
// K2, dq.  grid (q tiles, H, B).  Shared: Q | dO | K | V | dS.
// dq[row] = scale * sum_col dS[row, col] k[col],
// dS = P * (dO.v - delta), P = exp(scale q.k - lse) on attended pairs.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv,
    int Sq, int Skv, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = HD + 4;
  float* Q_s = smem;
  float* G_s = Q_s + kTile * LD;
  float* K_s = G_s + kTile * LD;
  float* V_s = K_s + kTile * LD;
  float* P_s = V_s + kTile * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long qoff = ((long long)b * H + h) * Sq;
  const T* kh = k + ((long long)b * Hkv + kvh) * Skv * HD;
  const T* vh = v + ((long long)b * Hkv + kvh) * Skv * HD;
  load_tile<T, HD>(Q_s, q + qoff * HD, row0, Sq);
  load_tile<T, HD>(G_s, g + qoff * HD, row0, Sq);

  float lse_r[4], delta_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[qoff + row] : 0.f;
    delta_r[i] = row < Sq ? delta[qoff + row] : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  int kt_first, kt_last;
  kv_tile_range(row0, Sq, Skv, window, kt_first, kt_last);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();
    load_tile<T, HD>(K_s, kh, col0, Skv);
    load_tile<T, HD>(V_s, vh, col0, Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_scores<HD>(Q_s, K_s, ty, tx, s);
    tile_scores<HD>(G_s, V_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = attends(row, col0 + tx + 16 * j, Sq, Skv, window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        P_s[(ty + 16 * i) * kTLD + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncwarp();
    tile_accum<HD>(P_s, K_s, ty, tx, acc);
  }

  float mul[4] = {scale, scale, scale, scale};
  store_tile<T, HD>(dq + qoff * HD, row0, Sq, ty, tx, acc, mul);
}

// ---------------------------------------------------------------------------
// K2, dk and dv.  grid (kv tiles, Hkv, B).  Shared: K | V | Q | dO | P^T.
// The block walks the q heads of its GQA group and the q tiles that read its
// kv tile (from the diagonal to the window's end), keeping the transposed
// score tile (kv rows x q rows), so that
//   dv[col] += sum_row P[row, col] dO[row],  dk[col] += sum_row dS[row, col] q[row]
// are the same second product as the forward's, summed over the group in
// registers.  A kv tile that no q row reads writes zeros.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Hkv, int Sq, int Skv, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = HD + 4;
  float* K_s = smem;
  float* V_s = K_s + kTile * LD;
  float* Q_s = V_s + kTile * LD;
  float* G_s = Q_s + kTile * LD;
  float* P_s = G_s + kTile * LD;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int col0 = kt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long kvoff = ((long long)b * Hkv + kvh) * Skv;
  load_tile<T, HD>(K_s, k + kvoff * HD, col0, Skv);
  load_tile<T, HD>(V_s, v + kvoff * HD, col0, Skv);

  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // q tiles holding a row that attends a column of this kv tile
  const int qt_first = kt;  // rows >= col0 (q and kv tiles are equally tall)
  int qt_last = (Sq - 1) / kTile;
  if (window > 0) {
    const long long r = (long long)col0 + kTile - 1 + window - 1;
    if (r / kTile < qt_last) qt_last = (int)(r / kTile);
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long long qoff = ((long long)b * H + h) * Sq;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int row0 = qt * kTile;
      __syncthreads();
      load_tile<T, HD>(Q_s, q + qoff * HD, row0, Sq);
      load_tile<T, HD>(G_s, g + qoff * HD, row0, Sq);
      float lse_c[4], delta_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + tx + 16 * j;
        lse_c[j] = row < Sq ? lse[qoff + row] : 0.f;
        delta_c[j] = row < Sq ? delta[qoff + row] : 0.f;
      }
      __syncthreads();

      // transposed tiles: index [i][j] is kv row ty + 16 i, q row tx + 16 j
      float st[4][4], dpt[4][4];
      tile_scores<HD>(K_s, Q_s, ty, tx, st);
      tile_scores<HD>(V_s, G_s, ty, tx, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = attends(row0 + tx + 16 * j, col0 + ty + 16 * i, Sq,
                                  Skv, window);
          const float p = ok ? expf(st[i][j] * scale - lse_c[j]) : 0.f;
          st[i][j] = p;
          P_s[(ty + 16 * i) * kTLD + tx + 16 * j] = p;
        }
      __syncwarp();
      tile_accum<HD>(P_s, G_s, ty, tx, dv_acc);
      __syncwarp();  // every lane has read P before dS overwrites it
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          P_s[(ty + 16 * i) * kTLD + tx + 16 * j] =
              st[i][j] * (dpt[i][j] - delta_c[j]);
      __syncwarp();
      tile_accum<HD>(P_s, Q_s, ty, tx, dk_acc);
    }
  }

  float one[4] = {1.f, 1.f, 1.f, 1.f};
  float mul[4] = {scale, scale, scale, scale};
  store_tile<T, HD>(dv + kvoff * HD, col0, Skv, ty, tx, dv_acc, one);
  store_tile<T, HD>(dk + kvoff * HD, col0, Skv, ty, tx, dk_acc, mul);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int Hkv, int Sq, int Skv, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  const cudaError_t e = allow_smem(flash_fwd_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Hkv, Sq, Skv,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               const void* out, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem<HD>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dkv_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;

  const long long n_rows = (long long)B * H * Sq;
  const int rows_per_block = kThreads / 32;
  flash_delta_kernel<T>
      <<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads,
         0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(out),
                      delta, n_rows, HD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((Sq + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), H, Hkv, Sq, Skv, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kTile - 1) / kTile, Hkv, B);
  flash_bwd_dkv_kernel<T, HD><<<grid_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Skv, window,
      scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K2, bf16: the wgmma bodies.  Blocks of three warpgroups: warpgroup 0 is
// the producer (one thread issues the TMA loads; setmaxnreg leaves it 24
// registers), warpgroups 1 and 2 are consumers of 64 rows each (240
// registers).  Tiles are 128-byte swizzled boxes 64 columns wide
// (hopper.cuh); hd / 64 boxes make a row of a tile.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;
constexpr int kBlockRows = 128;  // resident q rows of a dq block: 2 x 64
constexpr int kStreamRows = 64;  // rows of a k / v tile streamed by dq
constexpr int kQRows = 64;       // rows of a q / dO tile streamed by dk/dv
constexpr int kKvRows = 64;      // resident kv rows of a dk/dv block
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// pre-pass: lse and delta = rowsum(dO * out) into (B*H, Sq_pad) arrays
// padded with zeros to whole 64-row tiles (the dk/dv producer copies a
// tile's 256 bytes of each with one bulk copy); one warp per row
__global__ void flash_stats_kernel(const __nv_bfloat16* __restrict__ g,
                                   const __nv_bfloat16* __restrict__ out,
                                   const float* __restrict__ lse,
                                   float* __restrict__ lse_p,
                                   float* __restrict__ delta_p, int Sq,
                                   int Sq_pad, long long n_rows, int hd) {
  const long long r =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const long long bh = r / Sq_pad;
  const int i = (int)(r % Sq_pad);
  const int lane = threadIdx.x & 31;
  float a = 0.f;
  if (i < Sq) {
    const long long row = bh * Sq + i;
    for (int d = lane; d < hd; d += 32)
      a = fmaf(__bfloat162float(g[row * hd + d]),
               __bfloat162float(out[row * hd + d]), a);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (lane == 0) {
    delta_p[r] = a;
    lse_p[r] = i < Sq ? lse[bh * Sq + i] : 0.f;
  }
}

// descriptors of a tile of boxes (each `rows` x 128 bytes), from the
// descriptor of its first box at the wanted row: the K-major view at k16
// step kk (hd / 16 steps; 4 a box), and the MN-major view at k16 step kk
// (16 rows a step) over all hd columns
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int row) {
  return hopper::desc_sw128(tile + row * 128, 16, 1024);
}

__device__ __forceinline__ uint64_t kmajor(uint64_t base, int rows, int kk) {
  return hopper::desc_add(base, (kk >> 2) * rows * 128 + (kk & 3) * 32);
}

__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile,
                                                 int rows) {
  return hopper::desc_sw128(tile, rows * 128, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(uint64_t base, int kk) {
  return hopper::desc_add(base, kk * 2048);
}

// the A fragments (m64k16, bf16) of the k16 slices of a 64 x (16 K)
// accumulator: slice j is the accumulator's 8-wide chunks 2j and 2j + 1
template <int K>
__device__ __forceinline__ void to_frags(const float (&x)[8 * K],
                                         uint32_t (&f)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[j][r] = hopper::pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
}

// rows `row` and row + 8 of an (n_rows, HD) bf16 output from an m64nHD
// accumulator (chunk j holds columns 8j + 2t, 8j + 2t + 1), row `row`
// times mul0 and row + 8 times mul1
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst,
                                          int row, int n_rows, int t,
                                          const float (&acc)[HD / 2],
                                          float mul0, float mul1) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= n_rows) continue;
    const float mul = i == 0 ? mul0 : mul1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * HD + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul,
                                acc[4 * j + 2 * i + 1] * mul);
  }
}

template <int HD>
struct WgBwdSmem {
  // the dq kernel: q and dO resident (128 rows), k and v streamed (64)
  static constexpr int kBlockTile = kBlockRows * HD * 2;    // bytes
  static constexpr int kStreamTile = kStreamRows * HD * 2;
  static constexpr size_t kDqBytes =
      2 * kBlockTile + kStages * 2 * kStreamTile + 64 + 1024;
  // the dk/dv kernel: k and v resident (64 rows), q and dO streamed (64),
  // with the tile's lse and delta (2 x 64 floats a stage), and P^T passed
  // from consumer A to consumer B (fp32, 64 x 64 a stage)
  static constexpr int kKvTile = kKvRows * HD * 2;
  static constexpr int kQTile = kQRows * HD * 2;
  static constexpr int kPTile = kKvRows * kQRows * 4;
  static constexpr size_t kDkvBytes = 2 * kKvTile + kStages * 2 * kQTile +
                                      kStages * kPTile +
                                      kStages * 2 * kQRows * 4 + 64 + 1024;
};

// K2, bf16, dk and dv.  grid (kv tiles of 64 rows, Hkv, B).  K and V stay
// resident; q and dO tiles of 64 rows stream through the ring over the GQA
// group's heads and the q tiles that read this kv tile.  Both consumers
// work on the block's 64 kv rows and keep transposed tiles (kv rows x q
// rows), one product pair each:
//   A: S^T = K.Q^T, P^T = exp(scale S^T - lse); P^T to shared memory (fp32,
//      for B) and, rounded to bf16, the register A operand of dV += P^T.dO;
//   B: dP^T = V.dO^T, dS^T = P^T (dP^T - delta) with A's P^T; rounded to
//      bf16, the register A operand of dK += dS^T.Q
// (K-major q, dO for the scores, MN-major dO, q through transpose-B for
// the second products).  A consumer holds one hd-wide accumulator beside
// one score tile: with both dK and dV in each consumer's registers, ptxas
// spilled them and serialized the wgmma at hd 128.  A's P^T for stage s
// goes through named barrier 1 + s: A arrives after its stores, B waits
// before its loads; A writes the stage's P^T again only after the
// producer refilled the stage, which waits for B's release of it.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int Hkv, int Sq, int Skv, int Sq_pad, int window, float scale) {
  using L = WgBwdSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* K_s = smem;
  uint8_t* V_s = K_s + L::kKvTile;
  uint8_t* ring = V_s + L::kKvTile;  // stage s: q tile, dO tile
  float* P_s = reinterpret_cast<float*>(ring + kStages * 2 * L::kQTile);
  float* stats = P_s + kStages * kKvRows * kQRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + kStages * 2 * kQRows);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int col0 = kt * kKvRows;
  const int wg = threadIdx.x / 128;
  // q tiles holding a row that attends a column of this kv tile: rows from
  // col0 (causal) to the tile's last column + window - 1
  const int qt_first = col0 / kQRows;
  int qt_last = (Sq - 1) / kQRows;
  if (window > 0) {
    const long long r =
        (long long)min(col0 + kKvRows - 1, Skv - 1) + window - 1;
    if (r / kQRows < qt_last) qt_last = (int)(r / kQRows);
  }
  const int n_qt = qt_last >= qt_first ? qt_last - qt_first + 1 : 0;
  const int n_iter = group * n_qt;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      const int bkv = b * Hkv + kvh;
      hopper::mbar_expect_tx(kv_full, 2 * L::kKvTile);
      for (int j = 0; j < HD / 64; ++j) {
        hopper::tma_load_3d(K_s + j * kKvRows * 128, &map_k, kv_full, 64 * j,
                            col0, bkv);
        hopper::tma_load_3d(V_s + j * kKvRows * 128, &map_v, kv_full, 64 * j,
                            col0, bkv);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int bh = b * H + kvh * group + it / n_qt;
        const int row0 = (qt_first + it % n_qt) * kQRows;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* Q_t = ring + s * 2 * L::kQTile;
        uint8_t* G_t = Q_t + L::kQTile;
        hopper::mbar_expect_tx(&full[s], 2 * L::kQTile + 2 * kQRows * 4);
        for (int j = 0; j < HD / 64; ++j) {
          hopper::tma_load_3d(Q_t + j * kQRows * 128, &map_q, &full[s],
                              64 * j, row0, bh);
          hopper::tma_load_3d(G_t + j * kQRows * 128, &map_g, &full[s],
                              64 * j, row0, bh);
        }
        const long long off = (long long)bh * Sq_pad + row0;
        hopper::bulk_load(stats + s * 2 * kQRows, lse_p + off, kQRows * 4,
                          &full[s]);
        hopper::bulk_load(stats + s * 2 * kQRows + kQRows, delta_p + off,
                          kQRows * 4, &full[s]);
      }
    }
  } else {  // consumers: A (wg 1) and B (wg 2)
    hopper::regs_inc<240>();
    const bool is_a = wg == 1;
    const int tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int kr = col0 + 16 * w + g;  // kv rows kr and kr + 8
    const float sl2 = scale * kLog2e;
    const uint64_t kv_desc = kmajor_desc(is_a ? K_s : V_s, 0);
    float acc[HD / 2];  // A: dV, B: dK
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int row0 = (qt_first + it % n_qt) * kQRows;
      const uint8_t* Q_t = ring + s * 2 * L::kQTile;
      const uint8_t* G_t = Q_t + L::kQTile;
      const float* lse_t = stats + s * 2 * kQRows;
      const float* delta_t = lse_t + kQRows;
      // the stage's P^T, in the accumulator's register order: A's and B's
      // thread tid hold the same (kv row, q row) pairs, and float4 v of
      // thread tid sits at P_t[v * 128 + tid] (a warp's 16-byte accesses
      // fall on consecutive addresses)
      float4* P_t = reinterpret_cast<float4*>(P_s + s * kKvRows * kQRows) + tid;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);

      float x[kQRows / 2];  // A: S^T, then P^T; B: dP^T, then dS^T
      hopper::wgmma_fence();
      const uint64_t qg_desc = kmajor_desc(is_a ? Q_t : G_t, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<true, 0>(x, kmajor(kv_desc, kKvRows, kk),
                                  kmajor(qg_desc, kQRows, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);

      if (is_a) {
        // masks: only tiles that cross the diagonal, the window's edge or
        // an end of the sequences test each pair
        const bool edge = !(col0 + kKvRows - 1 <= row0 &&
                            col0 + kKvRows - 1 < Skv &&
                            row0 + kQRows - 1 < Sq &&
                            (window <= 0 ||
                             col0 > row0 + kQRows - 1 - window));
#pragma unroll
        for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = 8 * j + 2 * t + e;  // q row within the tile
            const float l2 = lse_t[qc] * kLog2e;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int y = 4 * j + 2 * i + e;
              const bool ok =
                  !edge || attends(row0 + qc, kr + 8 * i, Sq, Skv, window);
              x[y] = ok ? exp2f(fmaf(x[y], sl2, -l2)) : 0.f;
            }
          }
#pragma unroll
        for (int v = 0; v < kQRows / 8; ++v)
          P_t[v * 128] = make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2],
                                     x[4 * v + 3]);
        hopper::bar_arrive(1 + s, 256);
      } else {
        hopper::bar_sync(1 + s, 256);
#pragma unroll
        for (int v = 0; v < kQRows / 8; ++v) {
          const float4 p = P_t[v * 128];
          const float dl0 = delta_t[8 * v + 2 * t];
          const float dl1 = delta_t[8 * v + 2 * t + 1];
          x[4 * v] = p.x * (x[4 * v] - dl0);
          x[4 * v + 1] = p.y * (x[4 * v + 1] - dl1);
          x[4 * v + 2] = p.z * (x[4 * v + 2] - dl0);
          x[4 * v + 3] = p.w * (x[4 * v + 3] - dl1);
        }
      }
      uint32_t f[kQRows / 16][4];
      to_frags<kQRows / 16>(x, f);

      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      const uint64_t mn = mnmajor_desc(is_a ? G_t : Q_t, kQRows);
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk)
        hopper::wgmma_rs<1>(acc, f[kk], mnmajor(mn, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
    }

    const long long kvoff = ((long long)b * Hkv + kvh) * Skv;
    const float mul = is_a ? 1.f : scale;
    store_acc<HD>((is_a ? dv : dk) + kvoff * HD, kr, Skv, t, acc, mul, mul);
  }
}

// K2, bf16, dq.  grid (q tiles of 128 rows, H, B), the heaviest (last) q
// tiles first.  Q and dO stay resident; k and v tiles of 64 rows stream
// through the ring over the live kv tiles.  Consumer c owns q rows 64c..:
//   S = Q.K^T, dP = dO.V^T (K-major), P = exp(scale S - lse),
//   dS = P (dP - delta) rounded to bf16 as A fragments,
//   dQ += dS.K (MN-major k, transpose-B).
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Sq, int Skv,
    int Sq_pad, int window, float scale) {
  using L = WgBwdSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* Q_s = smem;
  uint8_t* G_s = Q_s + L::kBlockTile;
  uint8_t* ring = G_s + L::kBlockTile;  // stage s: k tile, v tile
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + kStages * 2 * L::kStreamTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = qt * kBlockRows;
  const int wg = threadIdx.x / 128;
  // kv tiles with a column that a row of this q tile attends: columns from
  // row0 - window + 1 (or 0) to the tile's last row (and below Skv)
  const int col_hi = min(min(row0 + kBlockRows - 1, Sq - 1), Skv - 1);
  const int col_lo = window > 0 ? max(row0 - window + 1, 0) : 0;
  const int kt_first = col_lo / kStreamRows;
  const int n_iter = col_lo <= col_hi ? col_hi / kStreamRows - kt_first + 1 : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      const int bh = b * H + h, bkv = b * Hkv + kvh;
      hopper::mbar_expect_tx(q_full, 2 * L::kBlockTile);
      for (int j = 0; j < HD / 64; ++j) {
        hopper::tma_load_3d(Q_s + j * kBlockRows * 128, &map_q, q_full,
                            64 * j, row0, bh);
        hopper::tma_load_3d(G_s + j * kBlockRows * 128, &map_g, q_full,
                            64 * j, row0, bh);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        const int c0 = (kt_first + it) * kStreamRows;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* K_t = ring + s * 2 * L::kStreamTile;
        uint8_t* V_t = K_t + L::kStreamTile;
        hopper::mbar_expect_tx(&full[s], 2 * L::kStreamTile);
        for (int j = 0; j < HD / 64; ++j) {
          hopper::tma_load_3d(K_t + j * kStreamRows * 128, &map_k, &full[s],
                              64 * j, c0, bkv);
          hopper::tma_load_3d(V_t + j * kStreamRows * 128, &map_v, &full[s],
                              64 * j, c0, bkv);
        }
      }
    }
  } else {  // consumers
    hopper::regs_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q_lo = row0 + 64 * c;
    const int qr = q_lo + 16 * w + g;  // q rows qr and qr + 8
    const long long bh = (long long)b * H + h;
    const float sl2 = scale * kLog2e;
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = qr + 8 * i < Sq;
      l2[i] = in ? lse_p[bh * Sq_pad + qr + 8 * i] * kLog2e : 0.f;
      dl[i] = in ? delta_p[bh * Sq_pad + qr + 8 * i] : 0.f;
    }
    const uint64_t q_desc = kmajor_desc(Q_s, 64 * c);
    const uint64_t g_desc = kmajor_desc(G_s, 64 * c);
    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
    hopper::mbar_wait(q_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kStages;
      const int c0 = (kt_first + it) * kStreamRows;
      const uint8_t* K_t = ring + s * 2 * L::kStreamTile;
      const uint8_t* V_t = K_t + L::kStreamTile;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);

      float sc[32], dp[32];
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      const uint64_t k_desc = kmajor_desc(K_t, 0);
      const uint64_t v_desc = kmajor_desc(V_t, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<true, 0>(sc, kmajor(q_desc, kBlockRows, kk),
                                  kmajor(k_desc, kStreamRows, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<true, 0>(dp, kmajor(g_desc, kBlockRows, kk),
                                  kmajor(v_desc, kStreamRows, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      const bool edge = !(c0 + kStreamRows - 1 <= q_lo &&
                          c0 + kStreamRows - 1 < Skv && q_lo + 63 < Sq &&
                          (window <= 0 || c0 > q_lo + 63 - window));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * t + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i + e;
            const bool ok = !edge || attends(qr + 8 * i, col, Sq, Skv, window);
            const float p = ok ? exp2f(fmaf(sc[x], sl2, -l2[i])) : 0.f;
            dp[x] = p * (dp[x] - dl[i]);
          }
        }
      uint32_t df[4][4];
      to_frags<4>(dp, df);

      hopper::fence_regs(dq_acc);
      hopper::wgmma_fence();
      const uint64_t k_mn = mnmajor_desc(K_t, kStreamRows);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<1>(dq_acc, df[kk], mnmajor(k_mn, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq_acc);
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
    }

    store_acc<HD>(dq + bh * Sq * HD, qr, Sq, t, dq_acc, scale, scale);
  }
}

// K1, bf16: the wgmma forward.  Shared memory: Q (128 rows) | the ring of
// kFwdStages stages of a k tile and a v tile (64 rows each) | barriers.
constexpr int kFwdStages = 3;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct WgFwdSmem {
  static constexpr int kQTile = kBlockRows * HD * 2;  // bytes
  static constexpr int kKvTile = kStreamRows * HD * 2;
  static constexpr size_t kBytes = kQTile + kFwdStages * 2 * kKvTile +
                                   (1 + 2 * kFwdStages) * 8 + 1024;
};

// K1, bf16.  grid (q tiles of 128 rows, H, B), the heaviest (last) q tiles
// first.  Q stays resident; k and v tiles of 64 rows stream through the
// ring over the live kv tiles (the dq kernel's range).  Consumer c owns q
// rows 64c..; its thread holds rows qr and qr + 8 of the 64 and, per tile:
//   S = Q.K^T (K-major, hd/16 steps); masked pairs (edge tiles only) set
//   to -inf, so that they raise no running max and their p is exactly 0;
//   the row max over the quad (lanes 4g..4g+3), m' = max(m, scale log2e
//   max S), p = exp2(scale log2e S - m'), O *= exp2(m - m'); l sums the
//   thread's fp32 p (the quad's partial sums are added at the end, since
//   their rescaling factors agree); P rounded to bf16 as A fragments, and
//   O += P.V (MN-major v, transpose-B).
// A tile that holds no pair of a consumer's rows (above its diagonal,
// behind its window, or past Sq) is released without a product.  m starts
// at the finite -1e30, so exp2(m - m') never meets inf - inf.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int Hkv,
    int Sq, int Skv, int window, float scale) {
  using L = WgFwdSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* Q_s = smem;
  uint8_t* ring = Q_s + L::kQTile;  // stage s: k tile, v tile
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + kFwdStages * 2 * L::kKvTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kFwdStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = qt * kBlockRows;
  const int wg = threadIdx.x / 128;
  const int col_hi = min(min(row0 + kBlockRows - 1, Sq - 1), Skv - 1);
  const int col_lo = window > 0 ? max(row0 - window + 1, 0) : 0;
  const int kt_first = col_lo / kStreamRows;
  const int n_iter = col_lo <= col_hi ? col_hi / kStreamRows - kt_first + 1 : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      const int bh = b * H + h, bkv = b * Hkv + kvh;
      hopper::mbar_expect_tx(q_full, L::kQTile);
      for (int j = 0; j < HD / 64; ++j)
        hopper::tma_load_3d(Q_s + j * kBlockRows * 128, &map_q, q_full,
                            64 * j, row0, bh);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kFwdStages;
        const int c0 = (kt_first + it) * kStreamRows;
        hopper::mbar_wait(&empty[s], ((it / kFwdStages) & 1) ^ 1);
        uint8_t* K_t = ring + s * 2 * L::kKvTile;
        uint8_t* V_t = K_t + L::kKvTile;
        hopper::mbar_expect_tx(&full[s], 2 * L::kKvTile);
        for (int j = 0; j < HD / 64; ++j) {
          hopper::tma_load_3d(K_t + j * kStreamRows * 128, &map_k, &full[s],
                              64 * j, c0, bkv);
          hopper::tma_load_3d(V_t + j * kStreamRows * 128, &map_v, &full[s],
                              64 * j, c0, bkv);
        }
      }
    }
  } else {  // consumers
    hopper::regs_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q_lo = row0 + 64 * c;
    const int qr = q_lo + 16 * w + g;  // q rows qr and qr + 8
    const long long bh = (long long)b * H + h;
    const float sl2 = scale * kLog2e;
    const uint64_t q_desc = kmajor_desc(Q_s, 64 * c);
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    hopper::mbar_wait(q_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kFwdStages;
      const int c0 = (kt_first + it) * kStreamRows;
      const uint8_t* K_t = ring + s * 2 * L::kKvTile;
      const uint8_t* V_t = K_t + L::kKvTile;
      hopper::mbar_wait(&full[s], (it / kFwdStages) & 1);
      const bool dead = q_lo >= Sq || c0 > q_lo + 63 ||
                        (window > 0 && c0 + kStreamRows - 1 <= q_lo - window);
      if (!dead) {
        float sc[32];
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
        const uint64_t k_desc = kmajor_desc(K_t, 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::wgmma_ss<true, 0>(sc, kmajor(q_desc, kBlockRows, kk),
                                    kmajor(k_desc, kStreamRows, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);

        const bool edge = !(c0 + kStreamRows - 1 <= q_lo &&
                            c0 + kStreamRows - 1 < Skv && q_lo + 63 < Sq &&
                            (window <= 0 || c0 > q_lo + 63 - window));
        if (edge) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // the row's attended columns are [lo, hi] (none for a row past
            // Sq); col < Skv is in hi
            const int row = qr + 8 * i;
            const int hi = row < Sq ? min(row, Skv - 1) : -1;
            const int lo = window > 0 ? row - window + 1 : 0;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = c0 + 8 * j + 2 * t + e;
                if (col > hi || col < lo) sc[4 * j + 2 * i + e] = -CUDART_INF_F;
              }
          }
        }
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              mx[i] = fmaxf(mx[i], sc[4 * j + 2 * i + e]);
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i] * sl2);
          alpha[i] = exp2f(m[i] - m_new);
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int x = 4 * j + 2 * i + e;
              sc[x] = exp2f(fmaf(sc[x], sl2, -m[i]));
              rs[i] += sc[x];
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], alpha[i], rs[i]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            o[4 * j + e] *= alpha[0];
            o[4 * j + 2 + e] *= alpha[1];
          }
        uint32_t pf[4][4];
        to_frags<4>(sc, pf);

        hopper::fence_regs(o);
        hopper::wgmma_fence();
        const uint64_t v_mn = mnmajor_desc(V_t, kStreamRows);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<1>(o, pf[kk], mnmajor(v_mn, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
      }
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    store_acc<HD>(out + bh * Sq * HD, qr, Sq, t, o,
                  1.f / (l[0] == 0.f ? 1.f : l[0]),
                  1.f / (l[1] == 0.f ? 1.f : l[1]));
    if (lse != nullptr && t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (qr + 8 * i < Sq)
          lse[bh * Sq + qr + 8 * i] =
              l[i] == 0.f ? 0.f : fmaf(m[i], kLn2, logf(l[i]));
    }
  }
}

// the (B*H or B*Hkv, S, HD) bf16 tensor at p as a 3-D map read in boxes of
// 64 columns x `rows` rows
template <int HD>
bool attn_map(CUtensorMap* map, const void* p, int bh, int s, int rows) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)s, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)s * HD * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return hopper::make_map(map, p, true, 3, dims, strides, box);
}

template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* g, const void* out, const float* lse,
                     float* scratch, void* dq, void* dk, void* dv, int B,
                     int H, int Hkv, int Sq, int Skv, int window, float scale,
                     cudaStream_t stream) {
  const int Sq_pad = (Sq + kStreamRows - 1) / kStreamRows * kStreamRows;
  const long long n_pad = (long long)B * H * Sq_pad;
  float* lse_p = scratch;
  float* delta_p = scratch + n_pad;
  // dq kernel: q, dO resident (128 rows), k, v streamed (64 rows);
  // dk/dv kernel: k, v resident, q, dO streamed
  CUtensorMap dq_q, dq_g, dq_k, dq_v, kv_q, kv_g, kv_k, kv_v;
  if (!attn_map<HD>(&dq_q, q, B * H, Sq, kBlockRows) ||
      !attn_map<HD>(&dq_g, g, B * H, Sq, kBlockRows) ||
      !attn_map<HD>(&dq_k, k, B * Hkv, Skv, kStreamRows) ||
      !attn_map<HD>(&dq_v, v, B * Hkv, Skv, kStreamRows) ||
      !attn_map<HD>(&kv_q, q, B * H, Sq, kQRows) ||
      !attn_map<HD>(&kv_g, g, B * H, Sq, kQRows) ||
      !attn_map<HD>(&kv_k, k, B * Hkv, Skv, kKvRows) ||
      !attn_map<HD>(&kv_v, v, B * Hkv, Skv, kKvRows))
    return (int)cudaErrorInvalidValue;
  using L = WgBwdSmem<HD>;
  cudaError_t e = hopper::allow_smem(flash_bwd_dq_wgmma<HD>, L::kDqBytes);
  if (e != cudaSuccess) return (int)e;
  e = hopper::allow_smem(flash_bwd_dkv_wgmma<HD>, L::kDkvBytes);
  if (e != cudaSuccess) return (int)e;

  const int rows_per_block = kThreads / 32;
  flash_stats_kernel<<<(unsigned)((n_pad + rows_per_block - 1) /
                                  rows_per_block),
                       kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(out), lse, lse_p, delta_p, Sq, Sq_pad,
      n_pad, HD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((Sq + kBlockRows - 1) / kBlockRows, H, B);
  flash_bwd_dq_wgmma<HD><<<grid_q, kWgThreads, L::kDqBytes, stream>>>(
      dq_q, dq_k, dq_v, dq_g, lse_p, delta_p,
      static_cast<__nv_bfloat16*>(dq), H, Hkv, Sq, Skv, Sq_pad, window,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kKvRows - 1) / kKvRows, Hkv, B);
  flash_bwd_dkv_wgmma<HD><<<grid_kv, kWgThreads, L::kDkvBytes, stream>>>(
      kv_q, kv_k, kv_v, kv_g, lse_p, delta_p,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Hkv, Sq, Skv, Sq_pad, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int Hkv, int Sq, int Skv,
                     int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!attn_map<HD>(&mq, q, B * H, Sq, kBlockRows) ||
      !attn_map<HD>(&mk, k, B * Hkv, Skv, kStreamRows) ||
      !attn_map<HD>(&mv, v, B * Hkv, Skv, kStreamRows))
    return (int)cudaErrorInvalidValue;
  using L = WgFwdSmem<HD>;
  const cudaError_t e = hopper::allow_smem(flash_fwd_wgmma<HD>, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlockRows - 1) / kBlockRows, H, B);
  flash_fwd_wgmma<HD><<<grid, kWgThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, H, Hkv, Sq, Skv,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 for every tensor but lse and delta (float32).  hd must be 64
// or 128; window <= 0 means no window; scale multiplies q.k.  Each returns
// cudaGetLastError() after its launches (0 on success).  The caller checks
// shapes, dtypes and contiguity and allocates every output and the (B, H,
// Sq) float32 delta scratch.

// out (B, H, Sq, hd); lse (B, H, Sq) float32, or NULL to skip the statistic;
// q, k, v 16-byte aligned for bf16 (TMA)
extern "C" int kf_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int Hkv, int Sq, int Skv,
                                      int hd, int window, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 128)
    return launch_fwd_wgmma<128>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
                                 scale, s);
  if (dtype == 1 && hd == 64)
    return launch_fwd_wgmma<64>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
                                scale, s);
  if (dtype == 0 && hd == 128)
    return launch_fwd<float, 128>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
                                  scale, s);
  if (dtype == 0 && hd == 64)
    return launch_fwd<float, 64>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

// dq (B, H, Sq, hd); dk, dv (B, Hkv, Skv, hd); three launches: delta, dq,
// dk/dv.  delta: fp32 scratch of 2 x B x H x roundup(Sq, 64) values (the
// fp32 body uses its first B x H x Sq; the bf16 body holds lse and delta
// there, padded to whole 64-row tiles); q, k, v, g 16-byte aligned for bf16
// (TMA)
extern "C" int kf_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* g,
                                      const void* out, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int B, int H, int Hkv, int Sq,
                                      int Skv, int hd, int window, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 128)
    return launch_bwd_wgmma<128>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv,
                                 Sq, Skv, window, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_bwd_wgmma<64>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv,
                                Sq, Skv, window, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd<float, 128>(q, k, v, g, out, l, dl, dq, dk, dv, B, H,
                                  Hkv, Sq, Skv, window, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv,
                                 Sq, Skv, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
