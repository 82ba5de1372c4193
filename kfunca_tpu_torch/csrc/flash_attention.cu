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
//   contiguous, one dtype (fp32 or bf16); hd is 64, 128 or 256 here (the
//   Python wrapper zero-pads other head dims up to 256 and passes the scale
//   of the true one; 256 is wgmma's largest N, the width of O += P.V).
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
//     registers; the ceiling is the 67 TFLOP/s fp32 pipe; at hd 256 the
//     backward's two streamed tiles share one (attention_tile.cuh,
//     kBwdShared), so that its block fits the 227 KB;
//   * bf16 inputs (K1 and K2): wgmma (the bodies in attention_wgmma.cuh,
//     shared with K12's bf16 hop), one thread of a producer issuing TMA
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
//   * the streamed rows and the rings' depths above are the defaults (K12's
//     too); the bf16 bodies are also built for the other tiles that
//     runtime/autotune.py sweeps (fwd_tile, bwd_tile below), chosen at
//     launch by the wrapper; a tile changes the order of the fp32 sums,
//     not the arithmetic.
// Left for later: overlapping one tile's softmax with the next tile's
// products (two score buffers or accumulator sets a consumer, FA3's
// intra-warpgroup pipelining), a persistent grid, and fusing the dq pass
// into the dk/dv pass; each would reach K12's bf16 hop through the shared
// bodies as well.

#include "attention_wgmma.cuh"

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
  float* V_s = kBwdShared<HD> ? K_s : K_s + kTile * LD;  // k, v take turns
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
    float s[4][4], dp[4][4];
    __syncthreads();
    if constexpr (kBwdShared<HD>) {  // v first, then k, which dS.K reads
      load_tile<T, HD>(V_s, vh, col0, Skv);
      __syncthreads();
      tile_scores<HD>(G_s, V_s, ty, tx, dp);
      __syncthreads();
      load_tile<T, HD>(K_s, kh, col0, Skv);
      __syncthreads();
      tile_scores<HD>(Q_s, K_s, ty, tx, s);
    } else {
      load_tile<T, HD>(K_s, kh, col0, Skv);
      load_tile<T, HD>(V_s, vh, col0, Skv);
      __syncthreads();
      tile_scores<HD>(Q_s, K_s, ty, tx, s);
      tile_scores<HD>(G_s, V_s, ty, tx, dp);
    }
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
  float* G_s = kBwdShared<HD> ? Q_s : Q_s + kTile * LD;  // q, dO take turns
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
      if constexpr (!kBwdShared<HD>)
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
      if constexpr (kBwdShared<HD>) {  // dO over q; q again for dK below
        __syncthreads();
        load_tile<T, HD>(G_s, g + qoff * HD, row0, Sq);
        __syncthreads();
      }
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
      if constexpr (kBwdShared<HD>) {
        __syncthreads();  // every warp has read dO
        load_tile<T, HD>(Q_s, q + qoff * HD, row0, Sq);
        __syncthreads();
      }
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
  static_assert(fwd_smem<HD>() <= kSmemLimit, "K1's fp32 block");
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
  static_assert(bwd_smem<HD>() <= kSmemLimit, "K2's fp32 blocks");
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
// K1 and K2, bf16: the wgmma bodies (attention_wgmma.cuh, shared with K12),
// with kHop = false.
// ---------------------------------------------------------------------------

// K2's pre-pass: lse and delta = rowsum(dO * out) into (B*H, Sq_pad) arrays
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

// SR: the k / v rows the dq kernel streams; QR: the q / dO rows the dk/dv
// kernel streams; ST: both rings' depth
template <int HD, int SR, int QR, int ST>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* g, const void* out, const float* lse,
                     float* scratch, void* dq, void* dk, void* dv, int B,
                     int H, int Hkv, int Sq, int Skv, int window, float scale,
                     cudaStream_t stream) {
  const int Sq_pad = (Sq + kStreamRows - 1) / kStreamRows * kStreamRows;
  const long long n_pad = (long long)B * H * Sq_pad;
  float* lse_p = scratch;
  float* delta_p = scratch + n_pad;
  // dq kernel: q, dO resident (128 rows), k, v streamed (SR rows);
  // dk/dv kernel: k, v resident, q, dO streamed (QR rows)
  CUtensorMap dq_q, dq_g, dq_k, dq_v, kv_q, kv_g, kv_k, kv_v;
  if (!attn_map<HD>(&dq_q, q, B * H, Sq, kBlockRows) ||
      !attn_map<HD>(&dq_g, g, B * H, Sq, kBlockRows) ||
      !attn_map<HD>(&dq_k, k, B * Hkv, Skv, SR) ||
      !attn_map<HD>(&dq_v, v, B * Hkv, Skv, SR) ||
      !attn_map<HD>(&kv_q, q, B * H, Sq, QR) ||
      !attn_map<HD>(&kv_g, g, B * H, Sq, QR) ||
      !attn_map<HD>(&kv_k, k, B * Hkv, Skv, kKvRows) ||
      !attn_map<HD>(&kv_v, v, B * Hkv, Skv, kKvRows))
    return (int)cudaErrorInvalidValue;
  using L = WgBwdSmem<HD, SR, QR, ST>;
  static_assert(L::kDqBytes <= kSmemLimit && L::kDkvBytes <= kSmemLimit,
                "K2's tile fits a block's shared memory");
  const auto dq_kernel = flash_bwd_dq_wgmma<HD, false, SR, ST>;
  const auto dkv_kernel = flash_bwd_dkv_wgmma<HD, false, QR, ST>;
  cudaError_t e = hopper::allow_smem(dq_kernel, L::kDqBytes);
  if (e != cudaSuccess) return (int)e;
  e = hopper::allow_smem(dkv_kernel, L::kDkvBytes);
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
  dq_kernel<<<grid_q, kWgThreads, L::kDqBytes, stream>>>(
      dq_q, dq_k, dq_v, dq_g, lse_p, delta_p,
      static_cast<__nv_bfloat16*>(dq), H, Hkv, Sq, Skv, Sq_pad, window, 0,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kKvRows - 1) / kKvRows, Hkv, B);
  dkv_kernel<<<grid_kv, kWgThreads, L::kDkvBytes, stream>>>(
      kv_q, kv_k, kv_v, kv_g, lse_p, delta_p,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Hkv, Sq, Skv, Sq_pad, window, 0, scale);
  return (int)cudaGetLastError();
}

// SR: the k / v rows a stage streams; ST: the ring's depth
template <int HD, int SR, int ST>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int Hkv, int Sq, int Skv,
                     int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!attn_map<HD>(&mq, q, B * H, Sq, kBlockRows) ||
      !attn_map<HD>(&mk, k, B * Hkv, Skv, SR) ||
      !attn_map<HD>(&mv, v, B * Hkv, Skv, SR))
    return (int)cudaErrorInvalidValue;
  using L = WgFwdSmem<HD, SR, ST>;
  static_assert(L::kBytes <= kSmemLimit,
                "K1's tile fits a block's shared memory");
  const auto kernel = flash_fwd_wgmma<HD, false, SR, ST>;
  const cudaError_t e = hopper::allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlockRows - 1) / kBlockRows, H, B);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, nullptr, nullptr,
      nullptr, H, Hkv, Sq, Skv, window, 0, scale);
  return (int)cudaGetLastError();
}

// The bf16 tiles built for runtime/autotune.py's sweeps
// (ops/pallas_kernels/flash_attention.fwd_tiles, bwd_tiles); the first of
// each is the default.  A tile outside these is refused.
//   forward (kv rows a stage, stages): (64, 3) (64, 2), and at hd 64
//     (128, 2) (at hd 128 ptxas spills its consumers' 128-column score
//     tile beside the 128-column accumulator); at hd 256 (64, 2);
//   backward (dq's kv rows, dk/dv's q rows, stages): (64, 64, 2)
//     (32, 32, 2) (64, 64, 3); at hd 256 (32, 32, 2).
// Only tiles that won or tied at some shape on the card are kept: (64, 4)
// and (32, 4) forward and (32, 64, 2), (64, 32, 2) backward lost at every
// shape swept, and at hd 256 forward (32, 3) and backward (32, 64, 2)
// lost at Gemma-2B's attention.  At hd 256 a block fits 227 KB of shared
// memory only with these narrower tiles (the launchers assert the fit):
// (64, 2) forward 193 KB, (32, 32, 2) backward 193 KB (dq) and 146 KB
// (dk/dv).  chip_smoke.py prints ptxas's registers and spills of each.
// The fp32 bodies have one tile.
template <int HD>
int fwd_tile(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int Hkv, int Sq, int Skv, int window,
             float scale, int rows, int stages, cudaStream_t s) {
#define KF_FWD(R, ST)                                                        \
  if (rows == R && stages == ST)                                             \
    return launch_fwd_wgmma<HD, R, ST>(q, k, v, out, lse, B, H, Hkv, Sq, Skv, \
                                       window, scale, s);
  if constexpr (HD == 256) {
    KF_FWD(64, 2)
  } else {
    KF_FWD(64, 3) KF_FWD(64, 2)
    if constexpr (HD == 64) {  // at hd 128 its consumers would spill
      KF_FWD(128, 2)
    }
  }
#undef KF_FWD
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int bwd_tile(const void* q, const void* k, const void* v, const void* g,
             const void* out, const float* lse, float* scratch, void* dq,
             void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv,
             int window, float scale, int rows, int q_rows, int stages,
             cudaStream_t s) {
#define KF_BWD(R, QR, ST)                                                   \
  if (rows == R && q_rows == QR && stages == ST)                            \
    return launch_bwd_wgmma<HD, R, QR, ST>(q, k, v, g, out, lse, scratch,   \
                                           dq, dk, dv, B, H, Hkv, Sq, Skv,  \
                                           window, scale, s);
  if constexpr (HD == 256) {
    KF_BWD(32, 32, 2)
  } else {
    KF_BWD(64, 64, 2) KF_BWD(32, 32, 2) KF_BWD(64, 64, 3)
  }
#undef KF_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 for every tensor but lse and delta (float32).  hd must be 64,
// 128 or 256; window <= 0 means no window; scale multiplies q.k.  Each returns
// cudaGetLastError() after its launches (0 on success).  The caller checks
// shapes, dtypes and contiguity and allocates every output and the (B, H,
// Sq) float32 delta scratch.  The bf16 bodies launch the tile named by
// rows, stages (and q_rows) from the tables above; fp32 ignores them.

// out (B, H, Sq, hd); lse (B, H, Sq) float32, or NULL to skip the statistic;
// q, k, v 16-byte aligned for bf16 (TMA)
extern "C" int kf_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int Hkv, int Sq, int Skv,
                                      int hd, int window, float scale,
                                      int dtype, int rows, int stages,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 256)
    return fwd_tile<256>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window, scale,
                         rows, stages, s);
  if (dtype == 1 && hd == 128)
    return fwd_tile<128>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window, scale,
                         rows, stages, s);
  if (dtype == 1 && hd == 64)
    return fwd_tile<64>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window, scale,
                        rows, stages, s);
  if (dtype == 0 && hd == 256)
    return launch_fwd<float, 256>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
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
                                      int dtype, int rows, int q_rows,
                                      int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (B <= 0 || H <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 256)
    return bwd_tile<256>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv, Sq,
                         Skv, window, scale, rows, q_rows, stages, s);
  if (dtype == 1 && hd == 128)
    return bwd_tile<128>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv, Sq,
                         Skv, window, scale, rows, q_rows, stages, s);
  if (dtype == 1 && hd == 64)
    return bwd_tile<64>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv, Sq,
                        Skv, window, scale, rows, q_rows, stages, s);
  if (dtype == 0 && hd == 256)
    return launch_bwd<float, 256>(q, k, v, g, out, l, dl, dq, dk, dv, B, H,
                                  Hkv, Sq, Skv, window, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd<float, 128>(q, k, v, g, out, l, dl, dq, dk, dv, B, H,
                                  Hkv, Sq, Skv, window, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv,
                                 Sq, Skv, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
