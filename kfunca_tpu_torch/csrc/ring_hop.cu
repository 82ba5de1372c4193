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
//   or bf16); hd is 64 or 128 (the Python wrapper zero-pads other head
//   dims).  q is PRE-SCALED by 1/sqrt(D), so scores are plain q.k.  Row i
//   of the q shard attends column j of the kv shard when
//   kv_off + j <= q_off + i, j < Skv and i < Sq (global causal positions).
//   Forward: m, l (BH, Sq) and acc (BH, Sq, hd) fp32 are the online-softmax
//   carry, read and written in place; acc stays unnormalized.  Masked
//   scores count as the finite -1e30 for the running max and add an exact
//   0 to the sums, so a row that sees no column of a tile keeps m and l bit
//   for bit (alpha = exp(0) = 1) and adds exact zeros to acc.  A q tile
//   whose rows all lie before the shard's first column (a wholly-future
//   hop) returns before it reads anything: its carry is untouched.
//   Backward: lse, delta (BH, Sq) fp32 are the ring's global natural-log
//   lse and rowsum(g * out); P = exp(q.k - lse) on attended pairs (exact 0
//   elsewhere), dS = P * (g.v - delta); dq += dS k (unscaled), dk += dS^T q
//   (q is scaled), dv += P^T g, the fp32 accumulators (BH, S, hd) updated
//   in place: each block adds its hop's sum to the stored value once.
//   fp32 inputs run in plain fp32 FFMA (never TF32).  bf16 inputs are
//   widened to fp32 when a tile is staged, and P and dS stay fp32 into the
//   second product (the TPU kernel rounds them to bf16 there).
//
// What bounds it: operations.  At the ring's shape (B=1, H=32, s_local =
// 8192, hd=128) a past hop has 67.1 M unmasked pairs a head at 4*hd flops
// (forward) and 10*hd (backward) against ~0.2 GB of traffic: thousands of
// flops per byte, far above the ~295 flop/byte where a Hopper card's
// tensor cores, not its memory, become the limit.
//
// What the design does about that, staying simple (the tile code is
// K1/K2's, shared with csrc/flash_attention.cu through attention_tile.cuh):
//   * only live tiles are visited: kv tiles wholly in the future of a q
//     tile (and q tiles wholly before a kv tile in the dk/dv pass) are
//     never loaded, so a future hop costs a launch and a diagonal hop half
//     a past one;
//   * 64 x 64 tiles staged in shared memory as fp32 with rows padded by 4
//     floats (16-byte loads free of bank conflicts); each of the 256
//     threads keeps a 4 x 4 block of the score tile and a 4 x (hd/16) block
//     of the output tile in registers;
//   * the backward is two kernels that each own what they write (dq per q
//     tile; dk and dv per kv tile), so there are no atomics and the
//     gradients are bitwise repeatable.
// Left for later: the tensor cores (wgmma on bf16 tiles; this version's
// ceiling is the 67 TFLOP/s fp32 pipe), TMA / cp.async double buffering,
// and overlapping a hop with the transfer of the next shard.

#include "attention_tile.cuh"

namespace {

__device__ __forceinline__ bool attends(int row, int col, int Sq, int Skv,
                                        int q_off, int kv_off) {
  return row < Sq && col < Skv && kv_off + col <= q_off + row;
}

// The per-thread fragment of rows [row0, row0 + 64) of an fp32 (n_rows, HD)
// accumulator in memory, in tile_accum's layout (rows past n_rows read 0).
template <int HD>
__device__ __forceinline__ void load_acc(const float* __restrict__ src,
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
__device__ __forceinline__ void store_acc(float* dst,
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) hop_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ m, float* __restrict__ l, float* __restrict__ acc_g,
    int Sq, int Skv, int q_off, int kv_off) {
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
  const T* kh = k + (long long)bh * Skv * HD;
  const T* vh = v + (long long)bh * Skv * HD;
  load_tile<T, HD>(Q_s, q + qbase * HD, row0, Sq);

  float m_r[4], l_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    m_r[i] = row < Sq ? m[qbase + row] : kNegInf;
    l_r[i] = row < Sq ? l[qbase + row] : 0.f;
  }
  load_acc<HD>(acc_g + qbase * HD, row0, Sq, ty, tx, acc);

  const int kt_last = col_last / kTile;
  for (int kt = 0; kt <= kt_last; ++kt) {
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

  store_acc<HD>(acc_g + qbase * HD, nullptr, row0, Sq, ty, tx, acc);
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) hop_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv,
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
  float* V_s = K_s + kTile * LD;
  float* P_s = V_s + kTile * LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long qbase = (long long)bh * Sq;
  const T* kh = k + (long long)bh * Skv * HD;
  const T* vh = v + (long long)bh * Skv * HD;
  load_tile<T, HD>(Q_s, q + qbase * HD, row0, Sq);
  load_tile<T, HD>(G_s, g + qbase * HD, row0, Sq);

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
        const bool ok = attends(row, col0 + tx + 16 * j, Sq, Skv, q_off,
                                kv_off);
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        P_s[(ty + 16 * i) * kTLD + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncwarp();
    tile_accum<HD>(P_s, K_s, ty, tx, acc);
  }

  store_acc<HD>(dq + qbase * HD, dq + qbase * HD, row0, Sq, ty, tx, acc);
}

// ---------------------------------------------------------------------------
// Backward, dk and dv.  grid (kv tiles, BH).  Shared: K | V | Q | dO | P^T.
// The block walks the q tiles that hold a row reading its kv tile, keeping
// the transposed score tile (kv rows x q rows), so that
//   dv[col] += sum_row P[row, col] dO[row],  dk[col] += sum_row dS[row, col] q[row]
// are the forward's second product.  A kv tile that no q row reads (a
// wholly-future hop) returns without touching its accumulators.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) hop_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
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
  float* G_s = Q_s + kTile * LD;
  float* P_s = G_s + kTile * LD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long kvbase = (long long)bh * Skv;
  const long long qbase = (long long)bh * Sq;
  load_tile<T, HD>(K_s, k + kvbase * HD, col0, Skv);
  load_tile<T, HD>(V_s, v + kvbase * HD, col0, Skv);

  float dk_acc[4][HD / 16], dv_acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int qt_last = (Sq - 1) / kTile;
  for (int qt = row_first / kTile; qt <= qt_last; ++qt) {
    const int row0 = qt * kTile;
    __syncthreads();
    load_tile<T, HD>(Q_s, q + qbase * HD, row0, Sq);
    load_tile<T, HD>(G_s, g + qbase * HD, row0, Sq);
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
    tile_accum<HD>(P_s, Q_s, ty, tx, dk_acc);
  }

  store_acc<HD>(dv + kvbase * HD, dv + kvbase * HD, col0, Skv, ty, tx,
                dv_acc);
  store_acc<HD>(dk + kvbase * HD, dk + kvbase * HD, col0, Skv, ty, tx,
                dk_acc);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, float* m,
               float* l, float* acc, int BH, int Sq, int Skv, int q_off,
               int kv_off, cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  const cudaError_t e = allow_smem(hop_fwd_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kTile - 1) / kTile, BH);
  hop_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, acc, Sq, Skv, q_off, kv_off);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, float* dq, float* dk,
               float* dv, int BH, int Sq, int Skv, int q_off, int kv_off,
               cudaStream_t stream) {
  const size_t smem = bwd_smem<HD>();
  cudaError_t e = allow_smem(hop_bwd_dq_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(hop_bwd_dkv_kernel<T, HD>, smem);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((Sq + kTile - 1) / kTile, BH);
  hop_bwd_dq_kernel<T, HD><<<grid_q, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dq, Sq,
      Skv, q_off, kv_off);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((Skv + kTile - 1) / kTile, BH);
  hop_bwd_dkv_kernel<T, HD><<<grid_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, dk, dv,
      Sq, Skv, q_off, kv_off);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32,
// 1 = bfloat16 for q, k, v and g; every statistic and accumulator is
// float32.  hd must be 64 or 128.  Each returns cudaGetLastError() after its
// launches (0 on success).  The caller checks shapes, dtypes and contiguity.

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
  if (dtype == 1 && hd == 128)
    return launch_fwd<__nv_bfloat16, 128>(q, k, v, mf, lf, af, BH, Sq, Skv,
                                          q_off, kv_off, s);
  if (dtype == 1 && hd == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, mf, lf, af, BH, Sq, Skv,
                                         q_off, kv_off, s);
  if (dtype == 0 && hd == 128)
    return launch_fwd<float, 128>(q, k, v, mf, lf, af, BH, Sq, Skv, q_off,
                                  kv_off, s);
  if (dtype == 0 && hd == 64)
    return launch_fwd<float, 64>(q, k, v, mf, lf, af, BH, Sq, Skv, q_off,
                                 kv_off, s);
  return (int)cudaErrorInvalidValue;
}

// lse, delta (BH, Sq); dq (BH, Sq, hd), dk, dv (BH, Skv, hd) updated in
// place; two launches: dq, then dk/dv
extern "C" int kf_ring_hop_bwd(const void* q, const void* k, const void* v,
                               const void* g, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, int BH, int Sq, int Skv, int hd,
                               int q_off, int kv_off, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (BH <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && hd == 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, g, lf, df, dqf, dkf, dvf,
                                          BH, Sq, Skv, q_off, kv_off, s);
  if (dtype == 1 && hd == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, g, lf, df, dqf, dkf, dvf,
                                         BH, Sq, Skv, q_off, kv_off, s);
  if (dtype == 0 && hd == 128)
    return launch_bwd<float, 128>(q, k, v, g, lf, df, dqf, dkf, dvf, BH, Sq,
                                  Skv, q_off, kv_off, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, g, lf, df, dqf, dkf, dvf, BH, Sq,
                                 Skv, q_off, kv_off, s);
  return (int)cudaErrorInvalidValue;
}
