// The wgmma bodies of causal attention on bf16 for Hopper (sm_90a), shared
// by K1 / K2 (flash_attention.cu: flash attention, forward and backward) and
// K12 (ring_hop.cu: one hop of ring attention, forward and backward).
// runtime/_kernels.py hashes this header into the name of every library.
//
// Blocks of three warpgroups: warpgroup 0 is the producer (one thread issues
// the TMA loads; setmaxnreg leaves it 24 registers), warpgroups 1 and 2 are
// consumers of 64 rows each (240 registers).  Tiles are 128-byte swizzled
// boxes 64 columns wide (hopper.cuh); hd / 64 boxes make a row of a tile.
// The head dims built are 64, 128 and 256: 256 is wgmma's largest N, the
// width of the second products (O += P.V, dV += P^T.dO, dK, dQ), whose
// accumulator then takes 128 fp32 registers of a consumer thread beside
// its score tile: there ptxas spills (chip_smoke.py's phase 2 prints how
// much), which a later version may remove by splitting the head dim
// between passes.  A producer of one warp (288 threads, no setmaxnreg) is
// no way out: wgmma needs its four warps to be a warpgroup, warps 4k to
// 4k + 3, and ptxas kept the 168 registers all the same.
//
// Each kernel is a template over the head dim and kHop:
//   kHop = false (K1, K2): row i attends column j when j <= i, j < Skv,
//     i < Sq and, with a window, j > i - window.  The forward starts each
//     row's softmax state empty and ends with out = O / l in bf16 and lse;
//     the backward writes bf16 dq, dk, dv (dq and dk times scale).
//   kHop = true (K12): the mask is shifted by the shards' offsets: with
//     shift = q_off - kv_off, row i attends column j when j <= i + shift,
//     j < Skv and i < Sq (no window).  The launch passes scale 1 (q arrives
//     pre-scaled).  The forward loads the ring's carry (m, l in natural
//     log, acc unnormalized, fp32) into its registers and stores it back;
//     the backward adds its sums to fp32 dq, dk, dv in place.  A block
//     with no attended pair returns before it initializes a barrier and
//     touches nothing.
// With kHop false the shift and the hop's branches fold away at compile
// time, so K1 and K2 compile to the kernels they were before the bodies
// were shared.

#pragma once

#include <math_constants.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgThreads = 384;
constexpr int kBlockRows = 128;  // resident q rows of a dq block: 2 x 64
// The launch parameters below are the defaults (K12's, and K1's and K2's
// without a tuned entry); K1 and K2 also build the other tiles that
// runtime/autotune.py sweeps (flash_attention.cu: fwd_tile, bwd_tile).
constexpr int kStreamRows = 64;  // rows of a k / v tile streamed by dq
constexpr int kQRows = 64;       // rows of a q / dO tile streamed by dk/dv
// one consumer warpgroup's wgmma rows: both consumers of a dk/dv block
// work on the same kv rows, so this is not a tunable parameter
constexpr int kKvRows = 64;      // resident kv rows of a dk/dv block
constexpr int kStages = 2;
constexpr int kFwdStages = 3;

// The tiles K12 launches at a head dim (K1 and K2 take theirs from the
// tables in flash_attention.cu, whose first entries are these): up to hd
// 128 the constants above.  At hd 256 a
// 128-row q tile takes 64 KB and a 64-row k or v tile 32 KB, so the
// forward streams 64 rows through 2 stages (193 KB; 3 would need 262 KB)
// and the dq kernel, whose resident q and dO take 128 KB, streams 32 rows
// (193 KB; 64 would need 262 KB), as does the dk/dv kernel (146 KB).
template <int HD> struct WgDefaults {
  static constexpr int kFwdRows = kStreamRows;
  static constexpr int kFwdDepth = HD > 128 ? 2 : kFwdStages;
  static constexpr int kDqRows = HD > 128 ? 32 : kStreamRows;
  static constexpr int kDkvRows = HD > 128 ? 32 : kQRows;
  static constexpr int kDepth = kStages;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the gradients' element type: bf16 stores (K2), fp32 accumulators (K12)
template <bool kHop> struct GradOf { using T = __nv_bfloat16; };
template <> struct GradOf<true> { using T = float; };

__device__ __forceinline__ bool attends_at(int row, int col, int Sq, int Skv,
                                           int window, int shift) {
  return col <= row + shift && col < Skv && row < Sq &&
         (window <= 0 || col > row + shift - window);
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

// the same fragment of an (n_rows, HD) fp32 array in memory: load it into
// acc (rows past n_rows read 0), store acc to it, or add acc to it once
template <int HD>
__device__ __forceinline__ void load_acc(const float* __restrict__ src,
                                         int row, int n_rows, int t,
                                         float (&acc)[HD / 2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (r < n_rows)
        x = *reinterpret_cast<const float2*>(src + (long long)r * HD + 8 * j +
                                             2 * t);
      acc[4 * j + 2 * i] = x.x;
      acc[4 * j + 2 * i + 1] = x.y;
    }
  }
}

template <int HD, bool kAdd>
__device__ __forceinline__ void put_acc(float* __restrict__ dst, int row,
                                        int n_rows, int t,
                                        const float (&acc)[HD / 2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float2* p =
          reinterpret_cast<float2*>(dst + (long long)r * HD + 8 * j + 2 * t);
      float2 x = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      if (kAdd) {
        const float2 y = *p;
        x.x += y.x;
        x.y += y.y;
      }
      *p = x;
    }
  }
}

// SR: the k / v rows the dq kernel streams; QR: the q / dO rows the dk/dv
// kernel streams; ST: the depth of both rings
template <int HD, int SR = kStreamRows, int QR = kQRows, int ST = kStages>
struct WgBwdSmem {
  static constexpr int kBars = (1 + 2 * ST) * 8 > 64 ? (1 + 2 * ST) * 8 : 64;
  // the dq kernel: q and dO resident (128 rows), k and v streamed (SR)
  static constexpr int kBlockTile = kBlockRows * HD * 2;    // bytes
  static constexpr int kStreamTile = SR * HD * 2;
  static constexpr size_t kDqBytes =
      2 * kBlockTile + ST * 2 * kStreamTile + kBars + 1024;
  // the dk/dv kernel: k and v resident (64 rows), q and dO streamed (QR),
  // with the tile's lse and delta (2 x QR floats a stage), and P^T passed
  // from consumer A to consumer B (fp32, 64 x QR a stage)
  static constexpr int kKvTile = kKvRows * HD * 2;
  static constexpr int kQTile = QR * HD * 2;
  static constexpr int kPTile = kKvRows * QR * 4;
  static constexpr size_t kDkvBytes = 2 * kKvTile + ST * 2 * kQTile +
                                      ST * kPTile + ST * 2 * QR * 4 + kBars +
                                      1024;
};

// K2 / K12b, dk and dv.  grid (kv tiles of 64 rows, Hkv, B).  K and V stay
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
// lse_p and delta_p are (B*H, Sq_pad) with Sq_pad a multiple of 64 (the
// producer copies a tile's 256 bytes of each with one bulk copy).
template <int HD, bool kHop, int QR = kQRows, int ST = kStages>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    typename GradOf<kHop>::T* __restrict__ dk,
    typename GradOf<kHop>::T* __restrict__ dv, int H, int Hkv, int Sq,
    int Skv, int Sq_pad, int window, int shift, float scale) {
  using L = WgBwdSmem<HD, kStreamRows, QR, ST>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* K_s = smem;
  uint8_t* V_s = K_s + L::kKvTile;
  uint8_t* ring = V_s + L::kKvTile;  // stage s: q tile, dO tile
  float* P_s = reinterpret_cast<float*>(ring + ST * 2 * L::kQTile);
  float* stats = P_s + ST * kKvRows * QR;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + ST * 2 * QR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = kHop ? 1 : H / Hkv;
  const int col0 = kt * kKvRows;
  const int wg = threadIdx.x / 128;
  const int d = kHop ? shift : 0;  // row i attends columns j <= i + d
  const int win = kHop ? 0 : window;
  // q tiles holding a row that attends a column of this kv tile: rows from
  // col0 - d (causal) to the tile's last column + window - 1
  const int qt_first = (kHop ? max(col0 - d, 0) : col0) / QR;
  int qt_last = (Sq - 1) / QR;
  if (win > 0) {
    const long long r =
        (long long)min(col0 + kKvRows - 1, Skv - 1) + win - 1;
    if (r / QR < qt_last) qt_last = (int)(r / QR);
  }
  const int n_qt = qt_last >= qt_first ? qt_last - qt_first + 1 : 0;
  const int n_iter = group * n_qt;
  if (kHop && n_iter == 0) return;  // no q row reads this kv tile

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
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
        const int s = it % ST;
        const int bh = b * H + kvh * group + it / n_qt;
        const int row0 = (qt_first + it % n_qt) * QR;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        uint8_t* Q_t = ring + s * 2 * L::kQTile;
        uint8_t* G_t = Q_t + L::kQTile;
        hopper::mbar_expect_tx(&full[s], 2 * L::kQTile + 2 * QR * 4);
        for (int j = 0; j < HD / 64; ++j) {
          hopper::tma_load_3d(Q_t + j * QR * 128, &map_q, &full[s],
                              64 * j, row0, bh);
          hopper::tma_load_3d(G_t + j * QR * 128, &map_g, &full[s],
                              64 * j, row0, bh);
        }
        const long long off = (long long)bh * Sq_pad + row0;
        hopper::bulk_load(stats + s * 2 * QR, lse_p + off, QR * 4,
                          &full[s]);
        hopper::bulk_load(stats + s * 2 * QR + QR, delta_p + off,
                          QR * 4, &full[s]);
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
      const int s = it % ST;
      const int row0 = (qt_first + it % n_qt) * QR;
      const uint8_t* Q_t = ring + s * 2 * L::kQTile;
      const uint8_t* G_t = Q_t + L::kQTile;
      const float* lse_t = stats + s * 2 * QR;
      const float* delta_t = lse_t + QR;
      // the stage's P^T, in the accumulator's register order: A's and B's
      // thread tid hold the same (kv row, q row) pairs, and float4 v of
      // thread tid sits at P_t[v * 128 + tid] (a warp's 16-byte accesses
      // fall on consecutive addresses)
      float4* P_t = reinterpret_cast<float4*>(P_s + s * kKvRows * QR) + tid;
      hopper::mbar_wait(&full[s], (it / ST) & 1);

      float x[QR / 2];  // A: S^T, then P^T; B: dP^T, then dS^T
      hopper::wgmma_fence();
      const uint64_t qg_desc = kmajor_desc(is_a ? Q_t : G_t, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<true, 0>(x, kmajor(kv_desc, kKvRows, kk),
                                  kmajor(qg_desc, QR, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(x);

      if (is_a) {
        // masks: only tiles that cross the diagonal, the window's edge or
        // an end of the sequences test each pair
        const bool edge = !(col0 + kKvRows - 1 <= row0 + d &&
                            col0 + kKvRows - 1 < Skv &&
                            row0 + QR - 1 < Sq &&
                            (win <= 0 ||
                             col0 > row0 + QR - 1 + d - win));
#pragma unroll
        for (int j = 0; j < QR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = 8 * j + 2 * t + e;  // q row within the tile
            const float l2 = lse_t[qc] * kLog2e;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int y = 4 * j + 2 * i + e;
              const bool ok = !edge || attends_at(row0 + qc, kr + 8 * i, Sq,
                                                  Skv, win, d);
              x[y] = ok ? exp2f(fmaf(x[y], sl2, -l2)) : 0.f;
            }
          }
#pragma unroll
        for (int v = 0; v < QR / 8; ++v)
          P_t[v * 128] = make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2],
                                     x[4 * v + 3]);
        hopper::bar_arrive(1 + s, 256);
      } else {
        hopper::bar_sync(1 + s, 256);
#pragma unroll
        for (int v = 0; v < QR / 8; ++v) {
          const float4 p = P_t[v * 128];
          const float dl0 = delta_t[8 * v + 2 * t];
          const float dl1 = delta_t[8 * v + 2 * t + 1];
          x[4 * v] = p.x * (x[4 * v] - dl0);
          x[4 * v + 1] = p.y * (x[4 * v + 1] - dl1);
          x[4 * v + 2] = p.z * (x[4 * v + 2] - dl0);
          x[4 * v + 3] = p.w * (x[4 * v + 3] - dl1);
        }
      }
      uint32_t f[QR / 16][4];
      to_frags<QR / 16>(x, f);

      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      const uint64_t mn = mnmajor_desc(is_a ? G_t : Q_t, QR);
#pragma unroll
      for (int kk = 0; kk < QR / 16; ++kk)
        hopper::wgmma_rs<1>(acc, f[kk], mnmajor(mn, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
    }

    const long long kvoff = ((long long)b * Hkv + kvh) * Skv;
    if constexpr (kHop) {
      put_acc<HD, true>((is_a ? dv : dk) + kvoff * HD, kr, Skv, t, acc);
    } else {
      const float mul = is_a ? 1.f : scale;
      store_acc<HD>((is_a ? dv : dk) + kvoff * HD, kr, Skv, t, acc, mul, mul);
    }
  }
}

// K2 / K12b, dq.  grid (q tiles of 128 rows, H, B), the heaviest (last) q
// tiles first.  Q and dO stay resident; k and v tiles of 64 rows stream
// through the ring over the live kv tiles.  Consumer c owns q rows 64c..:
//   S = Q.K^T, dP = dO.V^T (K-major), P = exp(scale S - lse),
//   dS = P (dP - delta) rounded to bf16 as A fragments,
//   dQ += dS.K (MN-major k, transpose-B).
template <int HD, bool kHop, int SR = kStreamRows, int ST = kStages>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g,
    const float* __restrict__ lse_p, const float* __restrict__ delta_p,
    typename GradOf<kHop>::T* __restrict__ dq, int H, int Hkv, int Sq,
    int Skv, int Sq_pad, int window, int shift, float scale) {
  using L = WgBwdSmem<HD, SR, kQRows, ST>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* Q_s = smem;
  uint8_t* G_s = Q_s + L::kBlockTile;
  uint8_t* ring = G_s + L::kBlockTile;  // stage s: k tile, v tile
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + ST * 2 * L::kStreamTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = kHop ? h : h / (H / Hkv);
  const int row0 = qt * kBlockRows;
  const int wg = threadIdx.x / 128;
  const int d = kHop ? shift : 0;  // row i attends columns j <= i + d
  const int win = kHop ? 0 : window;
  // kv tiles with a column that a row of this q tile attends: columns from
  // row0 + d - window + 1 (or 0) to the tile's last row + d (and below Skv)
  const int col_hi = min(min(row0 + kBlockRows - 1, Sq - 1) + d, Skv - 1);
  const int col_lo = win > 0 ? max(row0 + d - win + 1, 0) : 0;
  const int kt_first = col_lo / SR;
  const int n_iter = col_lo <= col_hi ? col_hi / SR - kt_first + 1 : 0;
  if (kHop && n_iter == 0) return;  // every row precedes the kv shard

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
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
        const int s = it % ST;
        const int c0 = (kt_first + it) * SR;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        uint8_t* K_t = ring + s * 2 * L::kStreamTile;
        uint8_t* V_t = K_t + L::kStreamTile;
        hopper::mbar_expect_tx(&full[s], 2 * L::kStreamTile);
        for (int j = 0; j < HD / 64; ++j) {
          hopper::tma_load_3d(K_t + j * SR * 128, &map_k, &full[s],
                              64 * j, c0, bkv);
          hopper::tma_load_3d(V_t + j * SR * 128, &map_v, &full[s],
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
      const int s = it % ST;
      const int c0 = (kt_first + it) * SR;
      const uint8_t* K_t = ring + s * 2 * L::kStreamTile;
      const uint8_t* V_t = K_t + L::kStreamTile;
      hopper::mbar_wait(&full[s], (it / ST) & 1);

      float sc[SR / 2], dp[SR / 2];
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      const uint64_t k_desc = kmajor_desc(K_t, 0);
      const uint64_t v_desc = kmajor_desc(V_t, 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<true, 0>(sc, kmajor(q_desc, kBlockRows, kk),
                                  kmajor(k_desc, SR, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<true, 0>(dp, kmajor(g_desc, kBlockRows, kk),
                                  kmajor(v_desc, SR, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      const bool edge = !(c0 + SR - 1 <= q_lo + d &&
                          c0 + SR - 1 < Skv && q_lo + 63 < Sq &&
                          (win <= 0 || c0 > q_lo + 63 + d - win));
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * t + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i + e;
            const bool ok =
                !edge || attends_at(qr + 8 * i, col, Sq, Skv, win, d);
            const float p = ok ? exp2f(fmaf(sc[x], sl2, -l2[i])) : 0.f;
            dp[x] = p * (dp[x] - dl[i]);
          }
        }
      uint32_t df[SR / 16][4];
      to_frags<SR / 16>(dp, df);

      hopper::fence_regs(dq_acc);
      hopper::wgmma_fence();
      const uint64_t k_mn = mnmajor_desc(K_t, SR);
#pragma unroll
      for (int kk = 0; kk < SR / 16; ++kk)
        hopper::wgmma_rs<1>(dq_acc, df[kk], mnmajor(k_mn, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq_acc);
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
    }

    if constexpr (kHop)
      put_acc<HD, true>(dq + bh * Sq * HD, qr, Sq, t, dq_acc);
    else
      store_acc<HD>(dq + bh * Sq * HD, qr, Sq, t, dq_acc, scale, scale);
  }
}

// K1 / K12, the forward.  Shared memory: Q (128 rows) | the ring of
// kFwdStages stages of a k tile and a v tile (64 rows each) | barriers.
// SR: the k / v rows a stage streams; ST: the ring's depth
template <int HD, int SR = kStreamRows, int ST = kFwdStages>
struct WgFwdSmem {
  static constexpr int kQTile = kBlockRows * HD * 2;  // bytes
  static constexpr int kKvTile = SR * HD * 2;
  static constexpr size_t kBytes =
      kQTile + ST * 2 * kKvTile + (1 + 2 * ST) * 8 + 1024;
};

// grid (q tiles of 128 rows, H, B), the heaviest (last) q tiles first.  Q
// stays resident; k and v tiles of 64 rows stream through the ring over the
// live kv tiles (the dq kernel's range).  Consumer c owns q rows 64c..; its
// thread holds rows qr and qr + 8 of the 64 and, per tile:
//   S = Q.K^T (K-major, hd/16 steps); masked pairs (edge tiles only) set
//   to -inf, so that they raise no running max and their p is exactly 0;
//   the row max over the quad (lanes 4g..4g+3), m' = max(m, scale log2e
//   max S), p = exp2(scale log2e S - m'), O *= exp2(m - m'); l sums the
//   thread's fp32 p (the quad's partial sums are added at the end, since
//   their rescaling factors agree); P rounded to bf16 as A fragments, and
//   O += P.V (MN-major v, transpose-B).
// A tile that holds no pair of a consumer's rows (above its diagonal,
// behind its window, or past Sq) is released without a product.  m starts
// at the finite -1e30 (K1) or the carry's m (K12), so exp2(m - m') never
// meets inf - inf.  K12 keeps m in the same exp2 domain (m_in log2 e); a
// row whose max did not move writes the carry's own m back, bit for bit,
// and its l and O, rescaled by exp2(0) = 1 and added exact zeros, are
// unchanged too; lane t = 0 of a quad starts l from the carry's l, the
// others from 0, so that the quad's sum counts it once.
template <int HD, bool kHop, int SR = kStreamRows, int ST = kFwdStages>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ m_io, float* __restrict__ l_io,
    float* __restrict__ acc_io, int H, int Hkv, int Sq, int Skv, int window,
    int shift, float scale) {
  using L = WgFwdSmem<HD, SR, ST>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  uint8_t* Q_s = smem;
  uint8_t* ring = Q_s + L::kQTile;  // stage s: k tile, v tile
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + ST * 2 * L::kKvTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + ST;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = kHop ? h : h / (H / Hkv);
  const int row0 = qt * kBlockRows;
  const int wg = threadIdx.x / 128;
  const int d = kHop ? shift : 0;  // row i attends columns j <= i + d
  const int win = kHop ? 0 : window;
  const int col_hi = min(min(row0 + kBlockRows - 1, Sq - 1) + d, Skv - 1);
  const int col_lo = win > 0 ? max(row0 + d - win + 1, 0) : 0;
  const int kt_first = col_lo / SR;
  const int n_iter = col_lo <= col_hi ? col_hi / SR - kt_first + 1 : 0;
  if (kHop && n_iter == 0) return;  // every row precedes the kv shard

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
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
        const int s = it % ST;
        const int c0 = (kt_first + it) * SR;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        uint8_t* K_t = ring + s * 2 * L::kKvTile;
        uint8_t* V_t = K_t + L::kKvTile;
        hopper::mbar_expect_tx(&full[s], 2 * L::kKvTile);
        for (int j = 0; j < HD / 64; ++j) {
          hopper::tma_load_3d(K_t + j * SR * 128, &map_k, &full[s],
                              64 * j, c0, bkv);
          hopper::tma_load_3d(V_t + j * SR * 128, &map_v, &full[s],
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
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float m_in[2];  // K12: the carry's m (natural log) of rows qr, qr + 8
    if constexpr (kHop) {
      load_acc<HD>(acc_io + bh * Sq * HD, qr, Sq, t, o);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qr + 8 * i;
        m_in[i] = row < Sq ? m_io[bh * Sq + row] : kNegInf;
        m[i] = m_in[i] * kLog2e;
        l[i] = row < Sq && t == 0 ? l_io[bh * Sq + row] : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    }
    hopper::mbar_wait(q_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % ST;
      const int c0 = (kt_first + it) * SR;
      const uint8_t* K_t = ring + s * 2 * L::kKvTile;
      const uint8_t* V_t = K_t + L::kKvTile;
      hopper::mbar_wait(&full[s], (it / ST) & 1);
      const bool dead = q_lo >= Sq || c0 > q_lo + 63 + d ||
                        (win > 0 && c0 + SR - 1 <= q_lo + d - win);
      if (!dead) {
        float sc[SR / 2];
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
        const uint64_t k_desc = kmajor_desc(K_t, 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          hopper::wgmma_ss<true, 0>(sc, kmajor(q_desc, kBlockRows, kk),
                                    kmajor(k_desc, SR, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);

        const bool edge = !(c0 + SR - 1 <= q_lo + d &&
                            c0 + SR - 1 < Skv && q_lo + 63 < Sq &&
                            (win <= 0 || c0 > q_lo + 63 + d - win));
        if (edge) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // the row's attended columns are [lo, hi] (none for a row past
            // Sq); col < Skv is in hi
            const int row = qr + 8 * i;
            const int hi = row < Sq ? min(row + d, Skv - 1) : -1;
            const int lo = win > 0 ? row + d - win + 1 : 0;
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
        uint32_t pf[SR / 16][4];
        to_frags<SR / 16>(sc, pf);

        hopper::fence_regs(o);
        hopper::wgmma_fence();
        const uint64_t v_mn = mnmajor_desc(V_t, SR);
#pragma unroll
        for (int kk = 0; kk < SR / 16; ++kk)
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
    if constexpr (kHop) {
      put_acc<HD, false>(acc_io + bh * Sq * HD, qr, Sq, t, o);
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = qr + 8 * i;
          if (row >= Sq) continue;
          m_io[bh * Sq + row] =
              m[i] == m_in[i] * kLog2e ? m_in[i] : m[i] * kLn2;
          l_io[bh * Sq + row] = l[i];
        }
      }
    } else {
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

}  // namespace
