// One hop of ring attention for Hopper (sm_90a): the forward merge of one
// kv shard into the online-softmax carry, and the backward's share of one
// hop in dq / dk / dv (K12).
//
// Replaces the TPU kernels of
//   kfunca_tpu/ops/pallas_kernels/ring_hop.py:
//     flash_attention_hop (body _hop_kernel)
//     flash_attention_bwd_hop (body _bwd_hop_kernel)
//
// Contract:
//   q, g (BH, Sq, hd) and k, v (BH, Skv, hd), contiguous, one dtype (fp32
//   or bf16); hd is 64, 128 or 256 (the Python wrapper zero-pads other
//   head dims up to 256, wgmma's largest N).  q is PRE-SCALED by
//   1/sqrt(D), so scores are plain q.k.  Row i of the q shard attends
//   column j of the kv shard when
//   kv_off + j <= q_off + i, j < Skv and i < Sq (global causal positions).
//   Forward: m, l (BH, Sq) and acc (BH, Sq, hd) fp32 are the online-softmax
//   carry, read and written in place; acc stays unnormalized.  Masked
//   scores raise no running max and add an exact 0 to the sums, so a row
//   that sees no column of the hop keeps m, l and acc bit for bit.  A q
//   tile whose rows all lie before the shard's first column (a
//   wholly-future hop) returns before it reads anything: its carry is
//   untouched.
//   Backward: lse, delta (BH, pitch) fp32 are the ring's global natural-log
//   lse and rowsum(g * out) (pitch = Sq, or for bf16 a multiple of 64 with
//   zeros past Sq); P = exp(q.k - lse) on attended pairs (exact 0
//   elsewhere), dS = P * (g.v - delta); dq += dS k (unscaled), dk += dS^T q
//   (q is scaled), dv += P^T g, the fp32 accumulators (BH, S, hd) updated
//   in place: each block adds its hop's sum to the stored value once.
//   fp32 inputs run in plain fp32 FFMA (never TF32).  bf16 inputs run every
//   product on the tensor cores from the bf16 tiles with fp32 accumulators,
//   and round P (and, backward, dS) to bf16 before the second products, as
//   the TPU kernel does (_mxu_in); the forward's l sums the fp32 P before
//   that rounding, as the TPU kernel's does.
//
// What bounds it: operations.  At the ring's shape (B=1, H=32, s_local =
// 8192, hd=128) a past hop has 67.1 M unmasked pairs a head at 4*hd flops
// (forward) and 10*hd (backward) against ~0.2 GB of traffic: thousands of
// flops per byte, far above the ~295 flop/byte where a Hopper card's
// tensor cores, not its memory, become the limit.
//
// What the designs do about that:
//   * only live tiles are visited: kv tiles wholly in the future of a q
//     tile (and q tiles wholly before a kv tile in the dk/dv pass) are
//     never loaded, so a future hop costs a launch and a diagonal hop half
//     a past one;
//   * the backward is two kernels that each own what they write (dq per q
//     tile; dk and dv per kv tile), so there are no atomics and the
//     gradients are bitwise repeatable;
//   * bf16 inputs: the wgmma bodies of K1 and K2 (attention_wgmma.cuh with
//     kHop = true; TMA rings on hopper.cuh): the forward keeps 128 q rows
//     resident in a block of a producer and two 64-row consumer warpgroups
//     and streams 64-row k and v tiles through 3 stages; the dq kernel
//     keeps 128 rows of q and dO and streams k and v; the dk/dv kernel
//     keeps 64 kv rows and streams 64-row q and dO tiles with their lse and
//     delta, one consumer making P^T and dV, the other dS^T and dK.  What
//     differs from K1 / K2:
//       - the mask is the hop's: shift = q_off - kv_off moves the diagonal
//         (row i attends columns j <= i + shift) and there is no window; a
//         block whose rows all precede the shard (the forward and dq), or
//         whose kv rows no q row reads (dk/dv, which starts at the first q
//         tile that reads its kv tile, row max(kv_off + col0 - q_off, 0)),
//         returns before it initializes a barrier; a consumer's tile is
//         dead when its first column lies past the shifted diagonal of its
//         last row, and an edge (each pair tested) only when it crosses
//         that diagonal or a length's end: a past hop at the ring's shape
//         (q_off = 8192, kv_off = 0) tests no pair;
//       - the carry comes in and goes out: each consumer loads its rows'
//         m, l and acc into K1's accumulator layout and stores acc, m, l
//         back in fp32 (no division, no bf16 output); m is kept in K1's
//         exp2 domain (m log2 e), and a row whose max did not move writes
//         the carry's own m back; lane 0 of a quad starts its partial l
//         from the carry's l, the other three from 0;
//       - scale 1 (q is pre-scaled), in both backward epilogues too;
//       - one head a kv head (the ring repeats grouped kv heads first);
//       - the accumulators are fp32, read, added to and stored once;
//       - lse and delta are the caller's: read in place when Sq is a
//         multiple of 64, else from the wrapper's zero-padded copy (the
//         dk/dv producer bulk-copies 64 floats of each a tile);
//       - the tiles are the head dim's defaults (WgDefaults): at hd 256 the
//         forward streams 64-row k and v through 2 stages, the dq and dk/dv
//         kernels 32-row tiles, so that each block fits 227 KB;
//   * fp32 inputs: 64 x 64 tiles staged in shared memory as fp32 with rows
//     padded by 4 floats (attention_tile.cuh, shared with K1/K2's fp32
//     bodies); each of the 256 threads keeps a 4 x 4 block of the score
//     tile and a 4 x (hd/16) block of the output tile in registers; the
//     ceiling is the 67 TFLOP/s fp32 pipe; at hd 256 the backward's two
//     streamed tiles share one (kBwdShared), as in K2's fp32 body.
// Left for later: what K1 and K2 leave for later (attention_wgmma.cuh's
// bodies: a tile's softmax overlapped with the next tile's products, a
// persistent grid, one backward kernel), and overlapping a hop with the
// transfer of the next shard.

#include "attention_wgmma.cuh"

namespace {

__device__ __forceinline__ bool attends(int row, int col, int Sq, int Skv,
                                        int q_off, int kv_off) {
  return row < Sq && col < Skv && kv_off + col <= q_off + row;
}

// The per-thread fragment of rows [row0, row0 + 64) of an fp32 (n_rows, HD)
// accumulator in memory, in tile_accum's layout (rows past n_rows read 0).
template <int HD>
__device__ __forceinline__ void load_tile_acc(const float* __restrict__ src,
                                         int row0, int n_rows, int ty, int tx,
                                         float (&acc)[4][HD / 16]) {
  constexpr int NV = HD / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n_rows)
        x = *reinterpret_cast<const float4*>(src + (long long)row * HD +
                                             c * 64 + tx * 4);
      acc[i][4 * c + 0] = x.x;
      acc[i][4 * c + 1] = x.y;
      acc[i][4 * c + 2] = x.z;
      acc[i][4 * c + 3] = x.w;
    }
  }
}

// dst[rows] = base[rows] + acc (base may alias dst; rows past n_rows are
// not written).  With base == nullptr, dst = acc.
template <int HD>
__device__ __forceinline__ void store_tile_acc(float* dst,
                                          const float* base, int row0,
                                          int n_rows, int ty, int tx,
                                          const float (&acc)[4][HD / 16]) {
  constexpr int NV = HD / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const long long at = (long long)row * HD + c * 64 + tx * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (base != nullptr) x = *reinterpret_cast<const float4*>(base + at);
      x.x += acc[i][4 * c + 0];
      x.y += acc[i][4 * c + 1];
      x.z += acc[i][4 * c + 2];
      x.w += acc[i][4 * c + 3];
      *reinterpret_cast<float4*>(dst + at) = x;
    }
  }
}

// the last local kv column a q tile starting at row0 may attend (< 0: none)
__device__ __forceinline__ int last_col(int row0, int Sq, int Skv, int q_off,
                                        int kv_off) {
  const int row_last = min(row0 + kTile - 1, Sq - 1);
  return min(q_off + row_last - kv_off, Skv - 1);
}

// ---------------------------------------------------------------------------
// Forward.  grid (q tiles, BH); the heaviest (last) q tiles start first.
// Shared memory (fp32): Q | K | V (64 x (HD+4) each) | P (64 x 68).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads) hop_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ m,
    float* __restrict__ l, float* __restrict__ acc_g, int Sq, int Skv,
    int q_off, int kv_off) {
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int row0 = qt * kTile;
  const int col_last = last_col(row0, Sq, Skv, q_off, kv_off);
  if (col_last < 0) return;  // every row of the tile precedes the shard

  extern __shared__ __align__(16) float smem[];
  constexpr int LD = HD + 4;
  float* Q_s = smem;
  float* K_s = Q_s + kTile * LD;
  float* V_s = K_s + kTile * LD;
  float* P_s = V_s + kTile * LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long qbase = (long long)bh * Sq;
  const float* kh = k + (long long)bh * Skv * HD;
  const float* vh = v + (long long)bh * Skv * HD;
  load_tile<float, HD>(Q_s, q + qbase * HD, row0, Sq);

  float m_r[4], l_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    m_r[i] = row < Sq ? m[qbase + row] : kNegInf;
    l_r[i] = row < Sq ? l[qbase + row] : 0.f;
  }
  load_tile_acc<HD>(acc_g + qbase * HD, row0, Sq, ty, tx, acc);

  const int kt_last = col_last / kTile;
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int col0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, HD>(K_s, kh, col0, Skv);
    load_tile<float, HD>(V_s, vh, col0, Skv);
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
        ok[j] = attends(row, col0 + tx + 16 * j, Sq, Skv, q_off, kv_off);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        P_s[(ty + 16 * i) * kTLD + tx + 16 * j] = p;
      }
      sum = half_warp_sum(sum);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // P rows ty + 16 i are written and read by this warp only
    tile_accum<HD>(P_s, V_s, ty, tx, acc);
  }

  store_tile_acc<HD>(acc_g + qbase * HD, nullptr, row0, Sq, ty, tx, acc);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row < Sq) {
        m[qbase + row] = m_r[i];
        l[qbase + row] = l_r[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dq.  grid (q tiles, BH).  Shared: Q | dO | K | V | dS.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads) hop_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Skv,
    int q_off, int kv_off) {
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int row0 = qt * kTile;
  const int col_last = last_col(row0, Sq, Skv, q_off, kv_off);
  if (col_last < 0) return;

  extern __shared__ __align__(16) float smem[];
  constexpr int LD = HD + 4;
  float* Q_s = smem;
  float* G_s = Q_s + kTile * LD;
  float* K_s = G_s + kTile * LD;
  float* V_s = kBwdShared<HD> ? K_s : K_s + kTile * LD;  // k, v take turns
  float* P_s = V_s + kTile * LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long qbase = (long long)bh * Sq;
  const float* kh = k + (long long)bh * Skv * HD;
  const float* vh = v + (long long)bh * Skv * HD;
  load_tile<float, HD>(Q_s, q + qbase * HD, row0, Sq);
  load_tile<float, HD>(G_s, g + qbase * HD, row0, Sq);

  float lse_r[4], delta_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse[qbase + row] : 0.f;
    delta_r[i] = row < Sq ? delta[qbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  const int kt_last = col_last / kTile;
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int col0 = kt * kTile;
    float s[4][4], dp[4][4];
    __syncthreads();
    if constexpr (kBwdShared<HD>) {  // v first, then k, which dS.K reads
      load_tile<float, HD>(V_s, vh, col0, Skv);
      __syncthreads();
      tile_scores<HD>(G_s, V_s, ty, tx, dp);
      __syncthreads();
      load_tile<float, HD>(K_s, kh, col0, Skv);
      __syncthreads();
      tile_scores<HD>(Q_s, K_s, ty, tx, s);
    } else {
      load_tile<float, HD>(K_s, kh, col0, Skv);
      load_tile<float, HD>(V_s, vh, col0, Skv);
      __syncthreads();
      tile_scores<HD>(Q_s, K_s, ty, tx, s);
      tile_scores<HD>(G_s, V_s, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = attends(row, col0 + tx + 16 * j, Sq, Skv, q_off,
                                kv_off);
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        P_s[(ty + 16 * i) * kTLD + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncwarp();
    tile_accum<HD>(P_s, K_s, ty, tx, acc);
  }

  store_tile_acc<HD>(dq + qbase * HD, dq + qbase * HD, row0, Sq, ty, tx,
                     acc);
}

// ---------------------------------------------------------------------------
// Backward, dk and dv.  grid (kv tiles, BH).  Shared: K | V | Q | dO | P^T.
// The block walks the q tiles that hold a row reading its kv tile, keeping
// the transposed score tile (kv rows x q rows), so that
//   dv[col] += sum_row P[row, col] dO[row],  dk[col] += sum_row dS[row, col] q[row]
// are the forward's second product.  A kv tile that no q row reads (a
// wholly-future hop) returns without touching its accumulators.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads) hop_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk,
    float* __restrict__ dv, int Sq, int Skv, int q_off, int kv_off) {
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int col0 = kt * kTile;
  // first local q row that attends column col0: q_off + row >= kv_off + col0
  const int row_first = max(kv_off + col0 - q_off, 0);
  if (row_first >= Sq) return;

  extern __shared__ __align__(16) float smem[];
  constexpr int LD = HD + 4;
  float* K_s = smem;
  float* V_s = K_s + kTile * LD;
  float* Q_s = V_s + kTile * LD;
  float* G_s = kBwdShared<HD> ? Q_s : Q_s + kTile * LD;  // q, dO take turns
  float* P_s = G_s + kTile * LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long kvbase = (long long)bh * Skv;
  const long long qbase = (long long)bh * Sq;
  load_tile<float, HD>(K_s, k + kvbase * HD, col0, Skv);
  load_tile<float, HD>(V_s, v + kvbase * HD, col0, Skv);

  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int qt_last = (Sq - 1) / kTile;
  for (int qt = row_first / kTile; qt <= qt_last; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();
    load_tile<float, HD>(Q_s, q + qbase * HD, row0, Sq);
    if constexpr (!kBwdShared<HD>)
      load_tile<float, HD>(G_s, g + qbase * HD, row0, Sq);
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + tx + 16 * j;
      lse_c[j] = row < Sq ? lse[qbase + row] : 0.f;
      delta_c[j] = row < Sq ? delta[qbase + row] : 0.f;
    }
    __syncthreads();

    // transposed tiles: index [i][j] is kv row ty + 16 i, q row tx + 16 j
    float st[4][4], dpt[4][4];
    tile_scores<HD>(K_s, Q_s, ty, tx, st);
    if constexpr (kBwdShared<HD>) {  // dO over q; q again for dK below
      __syncthreads();
      load_tile<float, HD>(G_s, g + qbase * HD, row0, Sq);
      __syncthreads();
    }
    tile_scores<HD>(V_s, G_s, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = attends(row0 + tx + 16 * j, col0 + ty + 16 * i, Sq,
                                Skv, q_off, kv_off);
        const float p = ok ? expf(st[i][j] - lse_c[j]) : 0.f;
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
      load_tile<float, HD>(Q_s, q + qbase * HD, row0, Sq);
      __syncthreads();
    }
    tile_accum<HD>(P_s, Q_s, ty, tx, dk_acc);
  }

  store_tile_acc<HD>(dv + kvbase * HD, dv + kvbase * HD, col0, Skv, ty, tx,
                dv_acc);
  store_tile_acc<HD>(dk + kvbase * HD, dk + kvbase * HD, col0, Skv, ty, tx,
                dk_acc);
}

template <int HD>
int launch_fwd(const float* q, const float* k, const float* v, float* m,
               float* l, float* acc, int BH, int Sq, int Skv, int q_off,
               int kv_off, cudaStream_t stream) {
  static_assert(fwd_smem<HD>() <= kSmemLimit, "K12's fp32 block");
  const size_t smem = fwd_smem<HD>();
  const cudaError_t e = allow_smem(hop_fwd_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kTile - 1) / kTile, BH);
  hop_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(q, k, v, m, l, acc, Sq,
                                                         Skv, q_off, kv_off);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* g, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, int BH, int Sq, int Skv,
               int q_off, int kv_off, cudaStream_t stream) {
  static_assert(bwd_smem<HD>() <= kSmemLimit, "K12b's fp32 blocks");
  const size_t smem = bwd_smem<HD>();
  cudaError_t e = allow_smem(hop_bwd_dq_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(hop_bwd_dkv_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((Sq + kTile - 1) / kTile, BH);
  hop_bwd_dq_kernel<HD><<<grid_q, kThreads, smem, stream>>>(
      q, k, v, g, lse, delta, dq, Sq, Skv, q_off, kv_off);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kTile - 1) / kTile, BH);
  hop_bwd_dkv_kernel<HD><<<grid_kv, kThreads, smem, stream>>>(
      q, k, v, g, lse, delta, dk, dv, Sq, Skv, q_off, kv_off);
  return (int)cudaGetLastError();
}

// bf16: the wgmma bodies of K1 and K2 with kHop = true (attention_wgmma.cuh);
// B = 1 and H = Hkv = BH (one head a kv head), window 0, scale 1
template <int HD>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, float* m,
                     float* l, float* acc, int BH, int Sq, int Skv, int q_off,
                     int kv_off, cudaStream_t stream) {
  using D = WgDefaults<HD>;
  CUtensorMap mq, mk, mv;
  if (!attn_map<HD>(&mq, q, BH, Sq, kBlockRows) ||
      !attn_map<HD>(&mk, k, BH, Skv, D::kFwdRows) ||
      !attn_map<HD>(&mv, v, BH, Skv, D::kFwdRows))
    return (int)cudaErrorInvalidValue;
  using L = WgFwdSmem<HD, D::kFwdRows, D::kFwdDepth>;
  static_assert(L::kBytes <= kSmemLimit,
                "K12's tile fits a block's shared memory");
  const auto kernel = flash_fwd_wgmma<HD, true, D::kFwdRows, D::kFwdDepth>;
  const cudaError_t e = hopper::allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBlockRows - 1) / kBlockRows, BH);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(
      mq, mk, mv, nullptr, nullptr, m, l, acc, BH, BH, Sq, Skv, 0,
      q_off - kv_off, 1.f);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* g, const float* lse, const float* delta,
                     int pitch, float* dq, float* dk, float* dv, int BH,
                     int Sq, int Skv, int q_off, int kv_off,
                     cudaStream_t stream) {
  // dq kernel: q, dO resident (128 rows), k, v streamed (SR rows);
  // dk/dv kernel: k, v resident (64 rows), q, dO streamed (QR rows)
  using D = WgDefaults<HD>;
  constexpr int SR = D::kDqRows, QR = D::kDkvRows, ST = D::kDepth;
  CUtensorMap dq_q, dq_g, dq_k, dq_v, kv_q, kv_g, kv_k, kv_v;
  if (!attn_map<HD>(&dq_q, q, BH, Sq, kBlockRows) ||
      !attn_map<HD>(&dq_g, g, BH, Sq, kBlockRows) ||
      !attn_map<HD>(&dq_k, k, BH, Skv, SR) ||
      !attn_map<HD>(&dq_v, v, BH, Skv, SR) ||
      !attn_map<HD>(&kv_q, q, BH, Sq, QR) ||
      !attn_map<HD>(&kv_g, g, BH, Sq, QR) ||
      !attn_map<HD>(&kv_k, k, BH, Skv, kKvRows) ||
      !attn_map<HD>(&kv_v, v, BH, Skv, kKvRows))
    return (int)cudaErrorInvalidValue;
  using L = WgBwdSmem<HD, SR, QR, ST>;
  static_assert(L::kDqBytes <= kSmemLimit && L::kDkvBytes <= kSmemLimit,
                "K12b's tiles fit a block's shared memory");
  const auto dq_kernel = flash_bwd_dq_wgmma<HD, true, SR, ST>;
  const auto dkv_kernel = flash_bwd_dkv_wgmma<HD, true, QR, ST>;
  cudaError_t e = hopper::allow_smem(dq_kernel, L::kDqBytes);
  if (e != cudaSuccess) return (int)e;
  e = hopper::allow_smem(dkv_kernel, L::kDkvBytes);
  if (e != cudaSuccess) return (int)e;
  const int shift = q_off - kv_off;

  const dim3 grid_q((Sq + kBlockRows - 1) / kBlockRows, BH);
  dq_kernel<<<grid_q, kWgThreads, L::kDqBytes, stream>>>(
      dq_q, dq_k, dq_v, dq_g, lse, delta, dq, BH, BH, Sq, Skv, pitch, 0,
      shift, 1.f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kKvRows - 1) / kKvRows, BH);
  dkv_kernel<<<grid_kv, kWgThreads, L::kDkvBytes, stream>>>(
      kv_q, kv_k, kv_v, kv_g, lse, delta, dk, dv, BH, BH, Sq, Skv, pitch, 0,
      shift, 1.f);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32 (the fp32
// tile), 1 = bfloat16 (the wgmma bodies; q, k, v and g 16-byte aligned for
// TMA) for q, k, v and g; every statistic and accumulator is float32.  hd
// must be 64, 128 or 256.  Each returns cudaGetLastError() after its launches
// (0 on success).  The caller checks shapes, dtypes and contiguity.

// m, l (BH, Sq), acc (BH, Sq, hd): the carry, updated in place
extern "C" int kf_ring_hop_fwd(const void* q, const void* k, const void* v,
                               void* m, void* l, void* acc, int BH, int Sq,
                               int Skv, int hd, int q_off, int kv_off,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* af = static_cast<float*>(acc);
  if (BH <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 256)
    return launch_fwd_wgmma<256>(q, k, v, mf, lf, af, BH, Sq, Skv, q_off,
                                 kv_off, s);
  if (dtype == 1 && hd == 128)
    return launch_fwd_wgmma<128>(q, k, v, mf, lf, af, BH, Sq, Skv, q_off,
                                 kv_off, s);
  if (dtype == 1 && hd == 64)
    return launch_fwd_wgmma<64>(q, k, v, mf, lf, af, BH, Sq, Skv, q_off,
                                kv_off, s);
  const float* q32 = static_cast<const float*>(q);
  const float* k32 = static_cast<const float*>(k);
  const float* v32 = static_cast<const float*>(v);
  if (dtype == 0 && hd == 256)
    return launch_fwd<256>(q32, k32, v32, mf, lf, af, BH, Sq, Skv, q_off,
                           kv_off, s);
  if (dtype == 0 && hd == 128)
    return launch_fwd<128>(q32, k32, v32, mf, lf, af, BH, Sq, Skv, q_off,
                           kv_off, s);
  if (dtype == 0 && hd == 64)
    return launch_fwd<64>(q32, k32, v32, mf, lf, af, BH, Sq, Skv, q_off,
                          kv_off, s);
  return (int)cudaErrorInvalidValue;
}

// lse, delta (BH, pitch): pitch = Sq for float32; for bfloat16 a multiple
// of 64 >= Sq, the entries past Sq zero, both arrays 16-byte aligned (the
// dk/dv kernel bulk-copies whole 64-row tiles of them).  dq (BH, Sq, hd),
// dk, dv (BH, Skv, hd) updated in place; two launches: dq, then dk/dv
extern "C" int kf_ring_hop_bwd(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, int pitch, void* dq,
                               void* dk, void* dv, int BH, int Sq, int Skv,
                               int hd, int q_off, int kv_off, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (BH <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (pitch < Sq || pitch % kQRows))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && pitch != Sq) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 256)
    return launch_bwd_wgmma<256>(q, k, v, g, lf, df, pitch, dqf, dkf, dvf,
                                 BH, Sq, Skv, q_off, kv_off, s);
  if (dtype == 1 && hd == 128)
    return launch_bwd_wgmma<128>(q, k, v, g, lf, df, pitch, dqf, dkf, dvf,
                                 BH, Sq, Skv, q_off, kv_off, s);
  if (dtype == 1 && hd == 64)
    return launch_bwd_wgmma<64>(q, k, v, g, lf, df, pitch, dqf, dkf, dvf, BH,
                                Sq, Skv, q_off, kv_off, s);
  const float* q32 = static_cast<const float*>(q);
  const float* k32 = static_cast<const float*>(k);
  const float* v32 = static_cast<const float*>(v);
  const float* g32 = static_cast<const float*>(g);
  if (dtype == 0 && hd == 256)
    return launch_bwd<256>(q32, k32, v32, g32, lf, df, dqf, dkf, dvf, BH, Sq,
                           Skv, q_off, kv_off, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd<128>(q32, k32, v32, g32, lf, df, dqf, dkf, dvf, BH, Sq,
                           Skv, q_off, kv_off, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<64>(q32, k32, v32, g32, lf, df, dqf, dkf, dvf, BH, Sq,
                          Skv, q_off, kv_off, s);
  return (int)cudaErrorInvalidValue;
}
