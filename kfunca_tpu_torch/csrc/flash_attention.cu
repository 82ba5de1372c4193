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
//   fp32 inputs at hd 64 and 128 run every product on the tensor cores as
//   split TF32 (three TF32 products a_hi.b_lo + a_lo.b_hi + a_hi.b_hi,
//   hi = rna(x), lo = rna(x - hi), fp32 accumulators; the counterpart of
//   the TPU kernel's Precision.HIGHEST), which holds fp32 accuracy: each
//   output stands within 1/64 of the error a single TF32 pass (the plain
//   version with TF32 allowed) makes against float64 (chip_smoke.py phase
//   93, tests/test_torch_flash_fp32.py on an emulation); at hd 256 they run
//   in plain fp32 FFMA.  bf16 inputs run
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
//   * fp32 inputs at hd 64 and 128 (K1 and K2): the split-TF32 wgmma
//     bodies below (flash_fwd_tf32, flash_bwd_dq_tf32, flash_bwd_dkv_tf32),
//     at three TF32 passes a product, a ceiling of 495 / 3 TFLOP/s;
//   * fp32 inputs at hd 256: 64 x 64 fp32 tiles (attention_tile.cuh,
//     shared with K12's fp32 hop): q, k, v (and dO) tiles in shared memory
//     as fp32 with rows padded by 4 floats; each of the 256 threads keeps a
//     4 x 4 block of the score tile and a 4 x 16 block of the output tile
//     in registers; the ceiling is the 67 TFLOP/s fp32 pipe; the
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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
// K1 on fp32 at hd 256: forward.  grid (q tiles, H, B); the heaviest (last)
// q tiles start first.  Shared memory (fp32): Q | K | V (64 x (HD+4) each) |
// P (64 x 68).
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
template <typename T>
__global__ void flash_stats_kernel(const T* __restrict__ g,
                                   const T* __restrict__ out,
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
      a = fmaf(to_float(g[row * hd + d]), to_float(out[row * hd + d]), a);
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
  flash_stats_kernel<__nv_bfloat16><<<(unsigned)((n_pad + rows_per_block -
                                                  1) / rows_per_block),
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

// ---------------------------------------------------------------------------
// K1 and K2, fp32 at head dims 64 and 128: the split-TF32 wgmma bodies.
//
// Every product runs as three tf32 wgmmas into fp32 accumulators, the two
// small terms first: a.b = a_hi.b_lo + a_lo.b_hi + a_hi.b_hi with
// hi = rna(x), lo = rna(x - hi) (hopper.cuh, tf32_split).  The fp32 tiles
// arrive by TMA in 128-byte swizzled boxes of 32 columns.  Blocks of two
// consumer warpgroups (256 threads) and no producer warpgroup: ptxas held
// a 384-thread block (and a 288-thread one) to 168 registers a thread,
// setmaxnreg notwithstanding, and these consumers spilled there; 256
// threads may take 255.  Thread 0 issues the TMA loads, one stage ahead,
// into a ring of two stages; stage it + 1 goes out when both consumers
// have left stage it - 1 (a barrier at the top of each stage), and all 256
// threads split it (the transform: hi in place, lo beside it, and, K1's v,
// transposed) while their wgmmas of stage it run.  The second products of
// K2 sum each stage into a temporary added to the fp32 accumulator
// (tf32_t_add).

// tf32 wgmma reads shared-memory operands K-major only, and its register A
// fragment holds columns t and t + 4 of a k8 step where an accumulator
// holds 2t and 2t + 1.  The k order of a product is free, so every operand
// that the bodies lay out themselves puts index 2u of a group of 8 at k
// position u and 2u + 1 at u + 4 (kpos): the accumulator of P (or dS) is
// then the A fragment as it stands, and the fragments loaded from a tile
// of rows (the transposed A operands below) hit 8 distinct 16-byte chunks.
//   * K1: 128 q rows a block (64 a consumer); q's lo parts in registers,
//     its hi parts in place; k (hi in place, lo) and v^T (hi, lo), from
//     stages of SR rows; S = Q.K^T, the online softmax of the bf16 body, P
//     split into A fragments, O += P.V.
//   * K2, dq: 64 q rows a block.  Consumer 1 computes S = Q.K^T and P
//     (passed to consumer 2 in fp32 through shared memory), consumer 2
//     dP = dO.V^T and dS = P (dP - delta), split into a K-major tile; both
//     then sum dQ^T = K^T.dS^T, K^T's fragments loaded from the k tile (hi
//     and lo) as A: at hd 128 each over half the head dim (so each loads
//     half the fragments), at hd 64 each over 32 of the q rows.
//   * K2, dk / dv: 64 kv rows a block, q and dO streamed in stages of QR
//     rows.  Consumer 1: S^T = K.Q^T, P^T, split into a K-major tile, and
//     dV^T += dO^T.P; consumer 2: dP^T = V.dO^T, dS^T = P^T (dP^T - delta)
//     with P^T read back (hi + lo), split, and dK^T += Q^T.dS.  dO^T's and
//     Q^T's fragments are loaded from the streamed tiles as A.
//   K1's k and K2's streamed tiles are stacked (split_stacked): each box
//   holds the tile's lo rows and then its hi rows, so that A_hi.[B_lo;
//   B_hi] is one product of twice the width, which reads A once for two of
//   the three terms (tf32_score2).
// Shared memory per block (the launchers assert it): K1 193 KB at hd 64,
// 225 KB at hd 128; dq 209 / 217 KB; dk/dv 226 / 226 KB.  hd 256 does not
// fit (q's lo parts and a 256-wide accumulator would take more than a
// thread's 255 registers, and a 64-row stage of k and v^T, hi and lo, 256
// KB) and keeps the fp32 tile above.
// ---------------------------------------------------------------------------

constexpr int kTf32Threads = 256;  // two consumer warpgroups
constexpr int kTf32Rows = 64;   // q rows of a dq block, kv rows of a dk/dv block

// kv rows a K1 / dq stage (SR) and q rows a dk/dv stage (QR); two stages
template <int HD> struct Tf32Tile {
  static constexpr int SR = HD == 64 ? 64 : 32;
  static constexpr int QR = HD == 64 ? 64 : 32;
  static constexpr int ST = 2;
};

// byte offset of element (r, c) of a tile of `rows` rows of fp32 in
// 128-byte swizzled boxes of 32 columns (the TMA's layout)
__device__ __forceinline__ int sw_off(int r, int c, int rows) {
  return (c >> 5) * rows * 128 + r * 128 +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// the k position of index i (see above)
__device__ __forceinline__ int kpos(int i) {
  return (i & ~7) | ((i & 7) >> 1) | ((i & 1) << 2);
}

__device__ __forceinline__ float& at(uint8_t* tile, int off) {
  return *reinterpret_cast<float*>(tile + off);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// the transform of K1's v: (R rows x HD) into v^T hi and lo (HD rows x R k
// positions); a warp takes 32 rows of one 4-column group, whose 32 stores
// of each column fall in distinct banks
template <int HD, int R>
__device__ __forceinline__ void split_transpose(const uint8_t* src,
                                                uint8_t* hi, uint8_t* lo,
                                                int x) {
  const int lane = x & 31;
#pragma unroll
  for (int u = x >> 5; u < (HD / 4) * (R / 32); u += kTf32Threads / 32) {
    const int cg = u % (HD / 4), r = 32 * (u / (HD / 4)) + lane;
    const float4 v =
        *reinterpret_cast<const float4*>(src + sw_off(r, 4 * cg, R));
    const float e[4] = {v.x, v.y, v.z, v.w};
    const int p = kpos(r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = sw_off(4 * cg + i, p, HD);
      hopper::tf32_split(e[i], at(hi, o), at(lo, o));
    }
  }
}

// A = rows [row, row + 64) of a resident tile (K-major over HD): the lo
// parts as register fragments (kept for the whole block), the hi parts
// written back in place for the shared-memory passes.  r0 = the thread's
// first row (16 w + g within the 64), t its lane in the quad.
template <int HD>
__device__ __forceinline__ void split_resident(uint8_t* tile, int rows,
                                               int r0, int t,
                                               uint32_t (&lo)[HD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = sw_off(r0 + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1), rows);
      float h, l;
      hopper::tf32_split(at(tile, o), h, l);
      at(tile, o) = h;
      lo[kk][e] = bits(l);
    }
}

// the A fragments of k step kk of X^T, X a split tile of `rows` rows (k:
// its rows, in k position order; m: its columns from c0), hi and lo
__device__ __forceinline__ void frags_t(const uint8_t* hi, const uint8_t* lo,
                                        int rows, int kk, int c0, int g,
                                        int t, uint32_t (&fh)[4],
                                        uint32_t (&fl)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = sw_off(8 * kk + 2 * t + (e >> 1), c0 + g + 8 * (e & 1),
                         rows);
    fh[e] = *reinterpret_cast<const uint32_t*>(hi + o);
    fl[e] = *reinterpret_cast<const uint32_t*>(lo + o);
  }
}

// an accumulator (64 rows x 8 N chunks) as split A fragments: chunk j is
// k step j, k positions (t, t + 4) = columns (2t, 2t + 1)
template <int N>
__device__ __forceinline__ void acc_frags(const float (&x)[N / 2],
                                          uint32_t (&fh)[N / 8][4],
                                          uint32_t (&fl)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      hopper::tf32_split(x[4 * j + ((e & 1) << 1) + (e >> 1)], h, l);
      fh[j][e] = bits(h);
      fl[j][e] = bits(l);
    }
}

// an accumulator (64 rows x N) as a split K-major tile of 64 rows (its
// rows) and N k positions; rows r0, r0 + 8 of the thread
template <int N>
__device__ __forceinline__ void acc_tile(const float (&x)[N / 2],
                                         uint8_t* hi, uint8_t* lo, int r0,
                                         int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = sw_off(r0 + 8 * i, 8 * j + t + 4 * e, kTf32Rows);
        hopper::tf32_split(x[4 * j + 2 * i + e], at(hi, o), at(lo, o));
      }
}

// d += A.B for an m-tile of R / 2 columns of B: A the split fragments of X^T
// over K / 8 k steps (frags_t), B a split K-major tile (hi at bh, lo at bl;
// b_rows rows a box), as A_hi.B_lo, A_lo.B_hi, A_hi.B_hi into a zeroed
// temporary (tf32_t_issue) that is then added to d in fp32 (tf32_t_add).
// A wgmma chain adds each k8 step into its accumulator without rounding to
// nearest, and dk's chain over a whole block (group x q tiles x 3 K / 8
// steps, thousands) drifted past the accuracy gate of chip_smoke.py phase
// 93: the temporary keeps each chain to one stage, and the sums across
// stages round to nearest.
template <int K, int R>
__device__ __forceinline__ void tf32_t_issue(float (&tmp)[R],
                                             const uint32_t (&fh)[K / 8][4],
                                             const uint32_t (&fl)[K / 8][4],
                                             uint64_t bh, uint64_t bl,
                                             int b_rows) {
#pragma unroll
  for (int i = 0; i < R; ++i) tmp[i] = 0.f;
  hopper::fence_regs(tmp);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_tf32(tmp, fh[kk], kmajor(bl, b_rows, kk), 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_tf32(tmp, fl[kk], kmajor(bh, b_rows, kk), 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    hopper::wgmma_tf32(tmp, fh[kk], kmajor(bh, b_rows, kk), 1);
  hopper::wgmma_commit();
}

template <int R>
__device__ __forceinline__ void tf32_t_add(float (&d)[R], float (&tmp)[R]) {
  hopper::wgmma_wait<0>();
  hopper::fence_regs(tmp);
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] += tmp[i];
}

// the second product of a K2 kernel: acc[m] += X^T.B for the MT m-tiles of
// the head dim from mt0, X a stacked split tile of K rows (split_stacked;
// the A fragments from its columns), B a split K-major tile of 64 rows, N
// of them (32 or 64) from row n0; `mid` runs while the first wgmmas do
template <int K, int MT, int N, class F>
__device__ __forceinline__ void tf32_t_product(
    float (&acc)[MT][N / 2], const uint8_t* x, int mt0, int w, int g, int t,
    const uint8_t* bh, const uint8_t* bl, int n0, F&& mid) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t fh[K / 8][4], fl[K / 8][4];
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
      frags_t(x + K * 128, x, 2 * K, kk, 64 * (mt0 + m) + 16 * w, g, t,
              fh[kk], fl[kk]);
    float tmp[N / 2];
    tf32_t_issue<K>(tmp, fh, fl, kmajor_desc(bh, n0), kmajor_desc(bl, n0),
                    kTf32Rows);
    if (m == 0) mid();
    tf32_t_add(acc[m], tmp);
  }
}

// the transform of a stacked tile: X (R rows x HD) arrives in the second R
// rows of each box of 2R rows; its hi parts stay there and its lo parts go
// to the box's first R rows, so that [X_lo; X_hi] is one K-major tile of
// 2R rows (tf32_score2)
template <int R, int HD>
__device__ __forceinline__ void split_stacked(uint8_t* x, int i0) {
#pragma unroll 2
  for (int i = i0; i < (HD / 32) * R * 8; i += kTf32Threads) {
    uint8_t* lo = x + (i / (R * 8)) * 2 * R * 128 + (i % (R * 8)) * 16;
    const float4 v = *reinterpret_cast<const float4*>(lo + R * 128);
    float4 h, l;
    hopper::tf32_split(v.x, h.x, l.x);
    hopper::tf32_split(v.y, h.y, l.y);
    hopper::tf32_split(v.z, h.z, l.z);
    hopper::tf32_split(v.w, h.w, l.w);
    *reinterpret_cast<float4*>(lo + R * 128) = h;
    *reinterpret_cast<float4*>(lo) = l;
  }
}

// d (the accumulator of N = 2R columns, R registers) = A_hi.[B_lo; B_hi]
// over HD, then A_lo.B_hi added to its first R columns, for a resident A
// (hi in shared memory at a_desc, lo in registers) and a stacked split B
// of R rows at b: one n = 2R product reads A once for both of its terms.
// Issued and committed; after tf32_wait the caller sums the halves
// (tf32_fold): the small terms, then A_hi.B_hi.
template <int HD, int R>
__device__ __forceinline__ void tf32_score2(float (&d)[R], uint64_t a_desc,
                                            int a_rows,
                                            const uint32_t (&alo)[HD / 8][4],
                                            const uint8_t* b) {
  const uint64_t bs = kmajor_desc(b, 0), bh = kmajor_desc(b, R);
  hopper::fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    hopper::wgmma_tf32(d, kmajor(a_desc, a_rows, kk), kmajor(bs, 2 * R, kk),
                       kk > 0);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk)
    hopper::wgmma_tf32(*reinterpret_cast<float(*)[R / 2]>(&d[0]), alo[kk],
                       kmajor(bh, 2 * R, kk), 1);
  hopper::wgmma_commit();
}

template <int R2>
__device__ __forceinline__ void tf32_fold(const float (&d)[R2],
                                          float (&x)[R2 / 2]) {
#pragma unroll
  for (int i = 0; i < R2 / 2; ++i) x[i] = d[i] + d[R2 / 2 + i];
}

// the end of a product the caller issued (tf32_score2)
template <int R>
__device__ __forceinline__ void tf32_wait(float (&d)[R]) {
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
}

// the fp32 map of a (B*H or B*Hkv, S, HD) tensor, boxes of 32 columns x
// `rows` rows
template <int HD>
bool attn_map_f32(CUtensorMap* map, const void* p, int bh, int s, int rows) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)s, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)HD * 4, (uint64_t)s * HD * 4};
  const uint32_t box[3] = {32, (uint32_t)rows, 1};
  return hopper::make_map_of(map, p, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, dims,
                             strides, box);
}

// an m64nHD accumulator's rows `row`, row + 8 into an (n_rows, HD) fp32
// array, times mul0 and mul1
template <int HD>
__device__ __forceinline__ void store_f32(float* __restrict__ dst, int row,
                                          int n_rows, int t,
                                          const float (&acc)[HD / 2],
                                          float mul0, float mul1) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= n_rows) continue;
    const float mul = i == 0 ? mul0 : mul1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(dst + (long long)r * HD + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

// transposed accumulators (m-tile m: head-dim columns 64 (mt0 + m) + 16 w
// + g (+8), N rows 8 j + 2 t (+1) from n0) into an (n_rows, HD) fp32 array,
// times mul
template <int HD, int MT, int N>
__device__ __forceinline__ void store_t(float* __restrict__ dst, int n0,
                                        int n_rows, int mt0, int w, int g,
                                        int t, const float (&acc)[MT][N / 2],
                                        float mul) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = n0 + 8 * j + 2 * t + e;
        if (r >= n_rows) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          dst[(long long)r * HD + 64 * (mt0 + m) + 16 * w + g + 8 * i] =
              acc[m][4 * j + 2 * i + e] * mul;
      }
}

template <int HD> struct Tf32FwdSmem {
  static constexpr int SR = Tf32Tile<HD>::SR, ST = Tf32Tile<HD>::ST;
  static constexpr int kQ = kBlockRows * HD * 4;  // bytes
  static constexpr int kT = SR * HD * 4;          // a stage's tile
  // stage: k as a stacked tile (split_stacked, 2 kT), v, v^T hi, v^T lo
  static constexpr int kStage = 5 * kT;
  static constexpr size_t kBytes = kQ + ST * kStage + (1 + ST) * 8 + 1024;
};

// K1, fp32.  grid (q tiles of 128 rows, H, B), the heaviest first.  Thread
// 0 issues the loads; stage it + 1 goes out when both consumers are done
// with it - 1 (barrier 3 at the top of stage it) and is split while the
// consumers' O += P.V of stage it runs.
template <int HD>
__global__ void __launch_bounds__(kTf32Threads, 1) flash_fwd_tf32(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Skv, int window,
    float scale) {
  using L = Tf32FwdSmem<HD>;
  constexpr int SR = L::SR, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* Q_s = smem;
  uint8_t* ring = Q_s + L::kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + ST * L::kStage);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = qt * kBlockRows;
  const int col_hi = min(min(row0 + kBlockRows - 1, Sq - 1), Skv - 1);
  const int col_lo = window > 0 ? max(row0 - window + 1, 0) : 0;
  const int kt_first = col_lo / SR;
  const int n_iter = col_lo <= col_hi ? col_hi / SR - kt_first + 1 : 0;
  const int bkv = b * Hkv + kvh;

  auto load = [&](int it) {  // thread 0: k into a stacked tile, v
    uint8_t* K_t = ring + (it % ST) * L::kStage;
    uint64_t* bar = &full[it % ST];
    const int c0 = (kt_first + it) * SR;
    hopper::mbar_expect_tx(bar, 2 * L::kT);
    for (int j = 0; j < HD / 32; ++j) {
      hopper::tma_load_3d(K_t + (2 * j + 1) * SR * 128, &map_k, bar, 32 * j,
                          c0, bkv);
      hopper::tma_load_3d(K_t + 2 * L::kT + j * SR * 128, &map_v, bar,
                          32 * j, c0, bkv);
    }
  };
  auto transform = [&](int it) {  // all threads
    uint8_t* K_t = ring + (it % ST) * L::kStage;
    hopper::mbar_wait(&full[it % ST], (it / ST) & 1);
    split_stacked<SR, HD>(K_t, threadIdx.x);
    split_transpose<HD, SR>(K_t + 2 * L::kT, K_t + 3 * L::kT,
                            K_t + 4 * L::kT, threadIdx.x);
    hopper::fence_proxy_async();
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(q_full, L::kQ);
    for (int j = 0; j < HD / 32; ++j)
      hopper::tma_load_3d(Q_s + j * kBlockRows * 128, &map_q, q_full, 32 * j,
                          row0, b * H + h);
    if (n_iter > 0) load(0);
  }
  __syncthreads();

  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = row0 + 64 * c;
  const int qr = q_lo + 16 * w + g;  // q rows qr and qr + 8
  const long long bh = (long long)b * H + h;
  const float sl2 = scale * kLog2e;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qlo[HD / 8][4];
  hopper::mbar_wait(q_full, 0);
  split_resident<HD>(Q_s, kBlockRows, 64 * c + 16 * w + g, t, qlo);
  if (n_iter > 0) transform(0);
  hopper::fence_proxy_async();
  const uint64_t q_desc = kmajor_desc(Q_s, 64 * c);

  for (int it = 0; it < n_iter; ++it) {
    const int c0 = (kt_first + it) * SR;
    const uint8_t* K_t = ring + (it % ST) * L::kStage;
    hopper::bar_sync(3, kTf32Threads);  // stage it split; it - 1 released
    if (threadIdx.x == 0 && it + 1 < n_iter) load(it + 1);
    const bool dead = q_lo >= Sq || c0 > q_lo + 63 ||
                      (window > 0 && c0 + SR - 1 <= q_lo - window);
    if (!dead) {
      float s2[SR];
      tf32_score2<HD>(s2, q_desc, kBlockRows, qlo, K_t);
      tf32_wait(s2);
      float sc[SR / 2];
      tf32_fold(s2, sc);
      const bool edge = !(c0 + SR - 1 <= q_lo && c0 + SR - 1 < Skv &&
                          q_lo + 63 < Sq &&
                          (window <= 0 || c0 > q_lo + 63 - window));
      if (edge) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = qr + 8 * i;
          const int hi = row < Sq ? min(row, Skv - 1) : -1;
          const int lo = window > 0 ? row - window + 1 : 0;
#pragma unroll
          for (int j = 0; j < SR / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c0 + 8 * j + 2 * t + e;
              if (col > hi || col < lo) sc[4 * j + 2 * i + e] = -CUDART_INF_F;
            }
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
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
      for (int j = 0; j < SR / 8; ++j)
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
      uint32_t ph[SR / 8][4], pl[SR / 8][4];
      acc_frags<SR>(sc, ph, pl);
      const uint64_t vh = kmajor_desc(K_t + 3 * L::kT, 0);
      const uint64_t vl = kmajor_desc(K_t + 4 * L::kT, 0);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SR / 8; ++kk)
        hopper::wgmma_tf32(o, pl[kk], kmajor(vh, HD, kk), 1);
#pragma unroll
      for (int kk = 0; kk < SR / 8; ++kk)
        hopper::wgmma_tf32(o, ph[kk], kmajor(vl, HD, kk), 1);
#pragma unroll
      for (int kk = 0; kk < SR / 8; ++kk)
        hopper::wgmma_tf32(o, ph[kk], kmajor(vh, HD, kk), 1);
      hopper::wgmma_commit();
      if (it + 1 < n_iter) transform(it + 1);
      tf32_wait(o);
    } else if (it + 1 < n_iter) {
      transform(it + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  store_f32<HD>(out + bh * Sq * HD, qr, Sq, t, o,
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

template <int HD> struct Tf32DqSmem {
  static constexpr int SR = Tf32Tile<HD>::SR, ST = Tf32Tile<HD>::ST;
  static constexpr int kQ = kTf32Rows * HD * 4;  // q or dO (hi in place)
  static constexpr int kT = SR * HD * 4;
  // stage: k and v as stacked tiles (split_stacked), 2 kT each
  static constexpr int kStage = 4 * kT;
  static constexpr int kDs = kTf32Rows * SR * 4;  // dS hi or lo; P
  static constexpr size_t kBytes =
      2 * kQ + ST * kStage + 3 * kDs + (1 + ST) * 8 + 1024;
};

// K2, dq, fp32.  grid (q tiles of 64 rows, H, B), the heaviest first.  The
// loads and the transform as K1's; stage it + 1 is split while the second
// product of stage it runs (its load went out at the top of stage it).
template <int HD>
__global__ void __launch_bounds__(kTf32Threads, 1) flash_bwd_dq_tf32(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    float* __restrict__ dq, int H, int Hkv, int Sq, int Skv, int Sq_pad,
    int window, float scale) {
  using L = Tf32DqSmem<HD>;
  constexpr int SR = L::SR, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* Q_s = smem;
  uint8_t* G_s = Q_s + L::kQ;
  uint8_t* ring = G_s + L::kQ;  // stage s: k, v (stacked)
  uint8_t* DSH = ring + ST * L::kStage;
  uint8_t* DSL = DSH + L::kDs;
  float4* P_s = reinterpret_cast<float4*>(DSL + L::kDs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(DSL + 2 * L::kDs);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = qt * kTf32Rows;
  const int col_hi = min(min(row0 + kTf32Rows - 1, Sq - 1), Skv - 1);
  const int col_lo = window > 0 ? max(row0 - window + 1, 0) : 0;
  const int kt_first = col_lo / SR;
  const int n_iter = col_lo <= col_hi ? col_hi / SR - kt_first + 1 : 0;
  const int bkv = b * Hkv + kvh;

  auto load = [&](int it) {  // thread 0: k and v into stacked tiles
    uint8_t* K_t = ring + (it % ST) * L::kStage + SR * 128;
    uint64_t* bar = &full[it % ST];
    const int c0 = (kt_first + it) * SR;
    hopper::mbar_expect_tx(bar, 2 * L::kT);
    for (int j = 0; j < HD / 32; ++j) {
      hopper::tma_load_3d(K_t + j * 2 * SR * 128, &map_k, bar, 32 * j, c0,
                          bkv);
      hopper::tma_load_3d(K_t + 2 * L::kT + j * 2 * SR * 128, &map_v, bar,
                          32 * j, c0, bkv);
    }
  };
  auto transform = [&](int it) {  // all threads
    uint8_t* K_t = ring + (it % ST) * L::kStage;
    hopper::mbar_wait(&full[it % ST], (it / ST) & 1);
    split_stacked<SR, HD>(K_t, threadIdx.x);
    split_stacked<SR, HD>(K_t + 2 * L::kT, threadIdx.x);
    hopper::fence_proxy_async();
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    hopper::mbar_expect_tx(q_full, 2 * L::kQ);
    for (int j = 0; j < HD / 32; ++j) {
      hopper::tma_load_3d(Q_s + j * kTf32Rows * 128, &map_q, q_full, 32 * j,
                          row0, b * H + h);
      hopper::tma_load_3d(G_s + j * kTf32Rows * 128, &map_g, q_full, 32 * j,
                          row0, b * H + h);
    }
    if (n_iter > 0) load(0);
  }
  __syncthreads();

  // consumers: 1 (S, P) and 2 (dP, dS)
  const int c = threadIdx.x / 128;
  const bool first = c == 0;
  const int tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qr = row0 + 16 * w + g;  // q rows qr and qr + 8
  const long long bh = (long long)b * H + h;
  const float sl2 = scale * kLog2e;
  float st[2];  // 1: lse log2 e of the rows; 2: their delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qr + 8 * i < Sq;
    const long long r = bh * Sq_pad + qr + 8 * i;
    st[i] = !in ? 0.f : first ? lse_p[r] * kLog2e : delta_p[r];
  }
  uint8_t* A_s = first ? Q_s : G_s;
  uint32_t alo[HD / 8][4];
  hopper::mbar_wait(q_full, 0);
  split_resident<HD>(A_s, kTf32Rows, 16 * w + g, t, alo);
  if (n_iter > 0) transform(0);
  hopper::fence_proxy_async();
  const uint64_t a_desc = kmajor_desc(A_s, 0);
  // dQ^T: at hd 128 consumer c sums head-dim columns 64 c.. over the 64 q
  // rows (each loads half of K^T's fragments), at hd 64 all of them over q
  // rows 32 c..
  constexpr int QN = HD > 64 ? 64 : 32;
  const int mt0 = HD > 64 ? c : 0, n0 = HD > 64 ? 0 : 32 * c;
  float dqt[1][QN / 2];
#pragma unroll
  for (int i = 0; i < QN / 2; ++i) dqt[0][i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int c0 = (kt_first + it) * SR;
    const uint8_t* K_t = ring + (it % ST) * L::kStage;
    const uint8_t* B_t = first ? K_t : K_t + 2 * L::kT;  // k or v
    hopper::bar_sync(3, kTf32Threads);  // stage it split; it - 1 released
    if (threadIdx.x == 0 && it + 1 < n_iter) load(it + 1);
    float s2[SR];
    tf32_score2<HD>(s2, a_desc, kTf32Rows, alo, B_t);
    tf32_wait(s2);
    float x[SR / 2];  // 1: S, then P; 2: dP, then dS
    tf32_fold(s2, x);
    if (first) {
      const bool edge = !(c0 + SR - 1 <= row0 && c0 + SR - 1 < Skv &&
                          row0 + kTf32Rows - 1 < Sq &&
                          (window <= 0 || c0 > row0 + kTf32Rows - 1 - window));
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * t + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int y = 4 * j + 2 * i + e;
            const bool ok =
                !edge || attends_at(qr + 8 * i, col, Sq, Skv, window, 0);
            x[y] = ok ? exp2f(fmaf(x[y], sl2, -st[i])) : 0.f;
          }
        }
#pragma unroll
      for (int v = 0; v < SR / 8; ++v)
        P_s[v * 128 + tid] =
            make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
      hopper::bar_arrive(1, kTf32Threads);
      hopper::bar_sync(2, kTf32Threads);
    } else {
      hopper::bar_sync(1, kTf32Threads);
#pragma unroll
      for (int v = 0; v < SR / 8; ++v) {
        const float4 p = P_s[v * 128 + tid];
        x[4 * v] = p.x * (x[4 * v] - st[0]);
        x[4 * v + 1] = p.y * (x[4 * v + 1] - st[0]);
        x[4 * v + 2] = p.z * (x[4 * v + 2] - st[1]);
        x[4 * v + 3] = p.w * (x[4 * v + 3] - st[1]);
      }
      acc_tile<SR>(x, DSH, DSL, 16 * w + g, t);
      hopper::fence_proxy_async();
      hopper::bar_sync(2, kTf32Threads);
    }
    // dQ^T += K^T.dS^T, K^T's fragments from the k tile
    tf32_t_product<SR, 1, QN>(dqt, K_t, mt0, w, g, t, DSH, DSL, n0, [&] {
      if (it + 1 < n_iter) transform(it + 1);
    });
  }
  store_t<HD, 1, QN>(dq + bh * Sq * HD, row0 + n0, Sq, mt0, w, g, t, dqt,
                     scale);
}

template <int HD> struct Tf32DkvSmem {
  static constexpr int QR = Tf32Tile<HD>::QR, ST = Tf32Tile<HD>::ST;
  static constexpr int kKv = kTf32Rows * HD * 4;  // k or v (hi in place)
  static constexpr int kT = QR * HD * 4;
  // stage: q and dO as stacked tiles (split_stacked), 2 kT each
  static constexpr int kStage = 4 * kT;
  static constexpr int kPt = kTf32Rows * QR * 4;  // P^T or dS^T, hi or lo
  static constexpr size_t kBytes = 2 * kKv + ST * kStage + 4 * kPt +
                                   ST * 2 * QR * 4 + (1 + ST) * 8 + 1024;
};

// K2, dk and dv, fp32.  grid (kv tiles of 64 rows, Hkv, B).  The loads and
// the transform as dq's.
template <int HD>
__global__ void __launch_bounds__(kTf32Threads, 1) flash_bwd_dkv_tf32(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq,
    int Skv, int Sq_pad, int window, float scale) {
  using L = Tf32DkvSmem<HD>;
  constexpr int QR = L::QR, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* K_s = smem;
  uint8_t* V_s = K_s + L::kKv;
  uint8_t* ring = V_s + L::kKv;  // stage s: q, dO (stacked)
  uint8_t* PTH = ring + ST * L::kStage;
  uint8_t* PTL = PTH + L::kPt;
  uint8_t* DSH = PTL + L::kPt;
  uint8_t* DSL = DSH + L::kPt;
  float* stats = reinterpret_cast<float*>(DSL + L::kPt);  // lse, delta a stage
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + ST * 2 * QR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int col0 = kt * kTf32Rows;
  const int qt_first = col0 / QR;
  int qt_last = (Sq - 1) / QR;
  if (window > 0) {
    const long long r =
        (long long)min(col0 + kTf32Rows - 1, Skv - 1) + window - 1;
    if (r / QR < qt_last) qt_last = (int)(r / QR);
  }
  const int n_qt = qt_last >= qt_first ? qt_last - qt_first + 1 : 0;
  const int n_iter = group * n_qt;

  auto load = [&](int it) {  // thread 0
    const int s = it % ST;
    const int bh = b * H + kvh * group + it / n_qt;
    const int row0 = (qt_first + it % n_qt) * QR;
    uint8_t* Q_t = ring + s * L::kStage + QR * 128;  // stacked tiles
    hopper::mbar_expect_tx(&full[s], 2 * L::kT + 2 * QR * 4);
    for (int j = 0; j < HD / 32; ++j) {
      hopper::tma_load_3d(Q_t + j * 2 * QR * 128, &map_q, &full[s], 32 * j,
                          row0, bh);
      hopper::tma_load_3d(Q_t + 2 * L::kT + j * 2 * QR * 128, &map_g,
                          &full[s], 32 * j, row0, bh);
    }
    const long long off = (long long)bh * Sq_pad + row0;
    hopper::bulk_load(stats + s * 2 * QR, lse_p + off, QR * 4, &full[s]);
    hopper::bulk_load(stats + s * 2 * QR + QR, delta_p + off, QR * 4,
                      &full[s]);
  };
  auto transform = [&](int it) {  // all threads
    uint8_t* Q_t = ring + (it % ST) * L::kStage;
    hopper::mbar_wait(&full[it % ST], (it / ST) & 1);
    split_stacked<QR, HD>(Q_t, threadIdx.x);
    split_stacked<QR, HD>(Q_t + 2 * L::kT, threadIdx.x);
    hopper::fence_proxy_async();
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    const int bkv = b * Hkv + kvh;
    hopper::mbar_expect_tx(kv_full, 2 * L::kKv);
    for (int j = 0; j < HD / 32; ++j) {
      hopper::tma_load_3d(K_s + j * kTf32Rows * 128, &map_k, kv_full, 32 * j,
                          col0, bkv);
      hopper::tma_load_3d(V_s + j * kTf32Rows * 128, &map_v, kv_full, 32 * j,
                          col0, bkv);
    }
    if (n_iter > 0) load(0);
  }
  __syncthreads();

  // consumers: 1 (S^T, P^T, dV) and 2 (dP^T, dS^T, dK)
  const int c = threadIdx.x / 128;
  const bool first = c == 0;
  const int tid = threadIdx.x & 127, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kr = col0 + 16 * w + g;  // kv rows kr and kr + 8
  const float sl2 = scale * kLog2e;
  uint8_t* A_s = first ? K_s : V_s;
  uint32_t alo[HD / 8][4];
  hopper::mbar_wait(kv_full, 0);
  split_resident<HD>(A_s, kTf32Rows, 16 * w + g, t, alo);
  if (n_iter > 0) transform(0);
  hopper::fence_proxy_async();
  const uint64_t a_desc = kmajor_desc(A_s, 0);
  float acc[HD / 64][32];  // 1: dV^T, 2: dK^T (HD x 64 kv rows)
#pragma unroll
  for (int mt = 0; mt < HD / 64; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % ST;
    const int row0 = (qt_first + it % n_qt) * QR;
    const uint8_t* Q_t = ring + s * L::kStage;
    const uint8_t* G_t = Q_t + 2 * L::kT;
    const float* lse_t = stats + s * 2 * QR;
    const float* delta_t = lse_t + QR;
    const uint8_t* B_t = first ? Q_t : G_t;
    hopper::bar_sync(3, kTf32Threads);  // stage it split; it - 1 released
    if (threadIdx.x == 0 && it + 1 < n_iter) load(it + 1);
    float s2[QR];
    tf32_score2<HD>(s2, a_desc, kTf32Rows, alo, B_t);
    tf32_wait(s2);
    float x[QR / 2];  // 1: S^T, then P^T; 2: dP^T, then dS^T
    tf32_fold(s2, x);
    if (first) {
      const bool edge = !(col0 + kTf32Rows - 1 <= row0 &&
                          col0 + kTf32Rows - 1 < Skv && row0 + QR - 1 < Sq &&
                          (window <= 0 || col0 > row0 + QR - 1 - window));
#pragma unroll
      for (int j = 0; j < QR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * j + 2 * t + e;  // q row within the tile
          const float l2 = lse_t[qc] * kLog2e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int y = 4 * j + 2 * i + e;
            const bool ok =
                !edge || attends_at(row0 + qc, kr + 8 * i, Sq, Skv, window, 0);
            x[y] = ok ? exp2f(fmaf(x[y], sl2, -l2)) : 0.f;
          }
        }
      acc_tile<QR>(x, PTH, PTL, 16 * w + g, t);
      hopper::fence_proxy_async();
      hopper::bar_sync(4, 128);
      hopper::bar_arrive(1, kTf32Threads);
    } else {
      hopper::bar_sync(1, kTf32Threads);
#pragma unroll
      for (int j = 0; j < QR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = delta_t[8 * j + 2 * t + e];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int y = 4 * j + 2 * i + e;
            const int o = sw_off(16 * w + g + 8 * i, 8 * j + t + 4 * e,
                                 kTf32Rows);
            x[y] = (at(PTH, o) + at(PTL, o)) * (x[y] - dl);
          }
        }
      acc_tile<QR>(x, DSH, DSL, 16 * w + g, t);
      hopper::fence_proxy_async();
      hopper::bar_sync(5, 128);
    }
    // 1: dV^T += dO^T.P; 2: dK^T += Q^T.dS (the streamed tile's fragments)
    tf32_t_product<QR, HD / 64, 64>(acc, first ? G_t : Q_t, 0, w, g, t,
                                    first ? PTH : DSH, first ? PTL : DSL, 0,
                                    [&] {
                                      if (it + 1 < n_iter) transform(it + 1);
                                    });
  }

  const long long kvoff = ((long long)b * Hkv + kvh) * Skv;
  store_t<HD, HD / 64, 64>((first ? dv : dk) + kvoff * HD, col0, Skv, 0, w,
                           g, t, acc, first ? 1.f : scale);
}

template <int HD>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* out,
                    float* lse, int B, int H, int Hkv, int Sq, int Skv,
                    int window, float scale, cudaStream_t stream) {
  using L = Tf32FwdSmem<HD>;
  static_assert(L::kBytes <= kSmemLimit, "K1's fp32 tile fits");
  CUtensorMap mq, mk, mv;
  if (!attn_map_f32<HD>(&mq, q, B * H, Sq, kBlockRows) ||
      !attn_map_f32<HD>(&mk, k, B * Hkv, Skv, L::SR) ||
      !attn_map_f32<HD>(&mv, v, B * Hkv, Skv, L::SR))
    return (int)cudaErrorInvalidValue;
  const auto kernel = flash_fwd_tf32<HD>;
  const cudaError_t e = hopper::allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlockRows - 1) / kBlockRows, H, B);
  kernel<<<grid, kTf32Threads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<float*>(out), lse, H, Hkv, Sq, Skv, window,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_tf32(const void* q, const void* k, const void* v,
                    const void* g, const void* out, const float* lse,
                    float* scratch, void* dq, void* dk, void* dv, int B,
                    int H, int Hkv, int Sq, int Skv, int window, float scale,
                    cudaStream_t stream) {
  using LQ = Tf32DqSmem<HD>;
  using LK = Tf32DkvSmem<HD>;
  static_assert(LQ::kBytes <= kSmemLimit && LK::kBytes <= kSmemLimit,
                "K2's fp32 tiles fit");
  const int Sq_pad = (Sq + kStreamRows - 1) / kStreamRows * kStreamRows;
  const long long n_pad = (long long)B * H * Sq_pad;
  float* lse_p = scratch;
  float* delta_p = scratch + n_pad;
  CUtensorMap dq_q, dq_g, dq_k, dq_v, kv_q, kv_g, kv_k, kv_v;
  if (!attn_map_f32<HD>(&dq_q, q, B * H, Sq, kTf32Rows) ||
      !attn_map_f32<HD>(&dq_g, g, B * H, Sq, kTf32Rows) ||
      !attn_map_f32<HD>(&dq_k, k, B * Hkv, Skv, LQ::SR) ||
      !attn_map_f32<HD>(&dq_v, v, B * Hkv, Skv, LQ::SR) ||
      !attn_map_f32<HD>(&kv_q, q, B * H, Sq, LK::QR) ||
      !attn_map_f32<HD>(&kv_g, g, B * H, Sq, LK::QR) ||
      !attn_map_f32<HD>(&kv_k, k, B * Hkv, Skv, kTf32Rows) ||
      !attn_map_f32<HD>(&kv_v, v, B * Hkv, Skv, kTf32Rows))
    return (int)cudaErrorInvalidValue;
  const auto dq_kernel = flash_bwd_dq_tf32<HD>;
  const auto dkv_kernel = flash_bwd_dkv_tf32<HD>;
  cudaError_t e = hopper::allow_smem(dq_kernel, LQ::kBytes);
  if (e != cudaSuccess) return (int)e;
  e = hopper::allow_smem(dkv_kernel, LK::kBytes);
  if (e != cudaSuccess) return (int)e;

  const int rows_per_block = kThreads / 32;
  flash_stats_kernel<float><<<(unsigned)((n_pad + rows_per_block - 1) /
                                         rows_per_block),
                              kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(out), lse,
      lse_p, delta_p, Sq, Sq_pad, n_pad, HD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((Sq + kTf32Rows - 1) / kTf32Rows, H, B);
  dq_kernel<<<grid_q, kTf32Threads, LQ::kBytes, stream>>>(
      dq_q, dq_k, dq_v, dq_g, lse_p, delta_p, static_cast<float*>(dq), H, Hkv,
      Sq, Skv, Sq_pad, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kTf32Rows - 1) / kTf32Rows, Hkv, B);
  dkv_kernel<<<grid_kv, kTf32Threads, LK::kBytes, stream>>>(
      kv_q, kv_k, kv_v, kv_g, lse_p, delta_p, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Hkv, Sq, Skv, Sq_pad, window, scale);
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
// rows, stages (and q_rows) from the tables above; fp32 ignores them (one
// tile).  q, k, v, g 16-byte aligned for bf16 and for fp32 at hd 64 and 128
// (TMA).

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
    return launch_fwd_tf32<128>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
                                scale, s);
  if (dtype == 0 && hd == 64)
    return launch_fwd_tf32<64>(q, k, v, out, l, B, H, Hkv, Sq, Skv, window,
                               scale, s);
  return (int)cudaErrorInvalidValue;
}

// dq (B, H, Sq, hd); dk, dv (B, Hkv, Skv, hd); three launches: delta, dq,
// dk/dv.  delta: fp32 scratch of 2 x B x H x roundup(Sq, 64) values (the
// fp32 tile at hd 256 uses its first B x H x Sq; the wgmma bodies hold lse
// and delta there, padded to whole 64-row tiles)
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
    return launch_bwd_tf32<128>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv,
                                Sq, Skv, window, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd_tf32<64>(q, k, v, g, out, l, dl, dq, dk, dv, B, H, Hkv,
                               Sq, Skv, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
