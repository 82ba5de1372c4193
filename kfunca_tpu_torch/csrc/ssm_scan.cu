// The Mamba selective scan, forward and backward (K11), for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   kfunca_tpu/ops/pallas_kernels/ssm_scan.py: ssm_scan_fwd (body
//   _fwd_kernel) and ssm_scan_bwd (body _bwd_kernel, plus the wrapper's
//   sums of its per-tile partials).
//
// Contract (the TPU kernels'; all fp32, row-major, contiguous):
//   dt, u (B, L, di); bm, c (B, L, N); a_t = A transposed (N, di).
//   h_t = exp(dt_t * A) o h_{t-1} + u_t * B_t, h_0 = 0 (per channel d and
//   state n), y_t[d] = sum_n c_t[n] h_t[n, d].  h_bound (B, ceil(L/lb), N,
//   di) is the state ENTERING each block of lb steps.
//   Backward, for the cotangent dy of y: the reverse recurrence
//     delta_t = dA_{t+1} o delta_{t+1} + C_t dy_t
//   gives ddt (the dA path only: u is an independent input), du, dbm and dc
//   (summed over di) and da_t (summed over B and L).
// Any L and di: the ragged last L-block and the channels past di are
// masked here.  Any N: the kernels walk the states in groups of kMaxN = 16
// (every published Mamba-1 and Jamba state width is one group), each group
// a full walk over L; from the second group on y (forward) and ddt, du
// (backward) add to what the earlier groups left, in the same thread and
// in group order, so the sums stay in a fixed order.
//
// What bounds it.  Per (b, t, d, n) the forward does one exponential and
// three multiply-adds; the backward needs the exponential again.  At the
// training shape (B 4, L 2048, di 5120, N 16) that is 671 M exponentials a
// pass, ~0.16 ms at the SFUs' rate (16 a clock an SM, 1/16 of the fp32
// FLOP rate), while the bytes (dt, u, y and h_bound in the forward; dt, u,
// dy, h_bound, ddt and du in the backward) take 0.2-0.3 ms at 3.35 TB/s.
// The TPU kernels walk the grid's L axis in order and carry the state
// between grid steps in VMEM scratch; on the card the blocks run at once.
//
// The forward (ssm_fwd_ring_kernel) walks L inside the thread, fed by a
// ring: a walk that loads its next steps only when it reaches them waits
// on a device round trip each time, with nothing else in flight.
//   * a block is 32 adjacent channels of one batch row: two consumer
//     warps and a producer warp.  The producer keeps a ring of kStages
//     stages of kT = 32 steps in shared memory, each holding dt and u
//     (kT rows of the block's 32 channels, 128 bytes a row) and B and C
//     (kT rows of a group's 16 states), with full / empty mbarriers.  Where
//     TMA takes the operands (di and N multiples of 4, 16-byte bases) one
//     lane issues four 3-D TMA loads a stage, zeros past L, di and N;
//     elsewhere the warp fills the same stage with ordinary loads.  The
//     consumers only wait on a stage's barrier and release it: no
//     __syncthreads in the walk.  Three stages: a fourth would cost the
//     fifth block an SM (36 KB a block), and one 640-block wave at the
//     training shape needs five;
//   * two adjacent lanes own a channel, each holding eight of a group's
//     16 states and their a * log2 e in registers (1,280 warps at the
//     training shape, 2.5 a scheduler).  Four lanes a channel (2,560
//     warps, five a scheduler) read slower on an H100, with twice the
//     loads and shuffles a state, and one lane (640 warps) far slower.  A
//     step reads dt and u once for the channel's lanes (a broadcast) and
//     each lane's B and C as two 16-byte broadcasts.  The lanes' sums of
//     two steps meet by one shuffle (step_sums), where one step's took
//     one, with no branch around it: the stores beside it are predicated;
//   * y leaves through shared memory: lane g of a channel writes step
//     i0 + g's y over u in the stage (every lane has read u by then), and
//     the producer, once the consumers release the stage, stores its rows
//     of 32 channels (128 bytes) before it refills the slot.  The state
//     entering every lb-th step (kT % lb == 0, so every h_bound point falls
//     inside a stage) goes to h_bound from registers: each store writes
//     four whole 32-byte sectors, and staging it would cost a barrier
//     among the consumers every lb steps;
//   * the decay is 2^(dt * a log2 e) by ex2.approx (2 ulp; 0 below 2^-126,
//     where dA * h is far below the tolerance), one SFU operation and one
//     multiply, where expf costs several fp32 operations around it.
// On an H100 at the training shape the walk is bound by the consumers'
// instruction issue, not by bytes or the SFU: the feed alone (the TMA loads
// and y's stores) runs in about the bytes' time, and an FMA in the
// exponential's place barely moves it (probe builds of this source with
// one choice changed, timed against the forward before its ring: PERF.md).
// The backward is a scan parallel over L (ssm_bwd_kernel below): a block
// is 32 channels (one a lane) by kBwdWarps segments of L (one a warp), and
// h_bound gives every segment its entering state, so the forward side of
// each segment is independent; only the reverse carry crosses segments,
// as a composition of affine maps (the TPU kernel's scan of (dA, x) pairs,
// here one pair a segment).  Every exponential is computed once.  dbm and
// dc, summed over the block's channels in a fixed order, leave as
// per-block partials, as the TPU kernel writes partials per di-tile, and
// a second small kernel sums them, and da_t's per-batch partials, in a
// fixed order: no atomics, so two runs give the same bits.
// The backward keeps expf, and no fast-math flags: the recurrence
// compounds per-step rounding multiplicatively.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kCh = 32;      // channels per block
constexpr int kMaxN = 16;    // states in one group (one walk over L)
constexpr unsigned kFull = 0xffffffffu;

// -- the forward: a walk over L fed by a ring --------------------------------

constexpr int kG = 2;                  // lanes per channel, splitting its states
constexpr int kS = kMaxN / kG;         // states per lane, in registers
constexpr int kFwdWarps = kCh * kG / 32;            // consumer warps
constexpr int kFwdThreads = 32 * (kFwdWarps + 1);   // + the producer warp
constexpr int kT = 32;                 // steps a stage
constexpr int kStages = 3;             // depth of the ring
constexpr int kTile = kT * kCh;        // floats of a stage's dt (or u) tile
constexpr int kBTile = kT * kMaxN;     // floats of its B (or C) tile
constexpr int kStageFloats = 2 * kTile + 2 * kBTile;
constexpr uint32_t kStageBytes = kStageFloats * sizeof(float);  // 12 KB
constexpr size_t kFwdSmem =
    128 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kStageBytes % 128 == 0, "stages stay 128-byte aligned");
static_assert(kS % 4 == 0, "a lane's B and C are whole float4s");
static_assert(kG == 2 && kT % kG == 0, "step_sums pairs two lanes' steps");

// The sums over a channel's two lanes of two steps' partials p (this lane's
// sums over its states): lane grp keeps step grp's partial, sends the other
// step's and returns step grp's sum p0 + p1 (p_l = lane l's; the same bits
// whichever lane adds), one shuffle for two steps.
__device__ __forceinline__ float step_sums(const float (&p)[kG], int grp) {
  const float keep = grp ? p[1] : p[0], send = grp ? p[0] : p[1];
  return keep + __shfl_xor_sync(kFull, send, 1);
}

// exp(x) for x2 = x log2 e: 2^x2 by the SFU (2 ulp, 0 below 2^-126)
__device__ __forceinline__ float decay(float x2) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x2));
  return r;
}

// a shared-memory store the compiler may move loads across (no memory
// clobber): the stage's later loads never read the word stored
__device__ __forceinline__ void put_y(float* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(hopper::smem_addr(p)),
               "f"(v));
}

// a global store under a predicate, with no branch around it, so the
// walk's shuffles stay on converged code (nothing in the kernel reads it)
__device__ __forceinline__ void put_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"((int)ok));
}

// The producer warp's fill of one stage with ordinary loads (operands TMA
// cannot take): dt and u rows t0 .. t0 + kT - 1 of channel d (lane =
// channel), B and C rows of states n0 .. n0 + 15; zeros past L, di and N.
__device__ __forceinline__ void fill_stage(
    float* st, const float* __restrict__ dt, const float* __restrict__ u,
    const float* __restrict__ bm, const float* __restrict__ c,
    long long row0, int t0, int n0, int L, int di, int n, int d, int lane) {
  float* sdt = st;
  float* su = sdt + kTile;
  float* sb = su + kTile;
  float* sc = sb + kBTile;
#pragma unroll 8
  for (int i = 0; i < kT; ++i) {
    const bool ok = t0 + i < L && d < di;
    const long long off = (row0 + t0 + i) * di + d;
    sdt[i * kCh + lane] = ok ? dt[off] : 0.0f;
    su[i * kCh + lane] = ok ? u[off] : 0.0f;
  }
#pragma unroll 4
  for (int q = lane; q < kBTile; q += 32) {
    const int i = q / kMaxN, s = q % kMaxN;
    const bool ok = t0 + i < L && n0 + s < n;
    const long long off = (row0 + t0 + i) * n + n0 + s;
    sb[q] = ok ? bm[off] : 0.0f;
    sc[q] = ok ? c[off] : 0.0f;
  }
}

// The producer warp's store of a released stage's y (left by the consumers
// over u): rows t0 .. of channel d (lane), 128 bytes a row; from the second
// group of states on, added to what the earlier groups left.
__device__ __forceinline__ void store_y(const float* sy, float* __restrict__ y,
                                        bool first, long long row0, int t0,
                                        int L, int di, int d, int lane) {
  if (d >= di) return;
  float* yp = y + (row0 + t0) * di + d;
  const int len = min(kT, L - t0);
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    if (i < len) {
      const float v = sy[i * kCh + lane];
      yp[(long long)i * di] = first ? v : yp[(long long)i * di] + v;
    }
  }
}

// grid (ceil(di / 32), B), block kFwdThreads: warps 0 .. kFwdWarps - 1
// consume, the last warp produces.  Stages are numbered across the groups
// of states (group g's stage k is g * nst + k), so the ring runs on from
// one group's walk into the next.
template <int LB, bool kTma>
__global__ void __launch_bounds__(kFwdThreads, 5) ssm_fwd_ring_kernel(
    const __grid_constant__ CUtensorMap map_dt,
    const __grid_constant__ CUtensorMap map_u,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c, const float* __restrict__ dt,
    const float* __restrict__ u, const float* __restrict__ bm,
    const float* __restrict__ c, const float* __restrict__ a_t,
    float* __restrict__ y, float* __restrict__ hb, int L, int di, int n) {
  static_assert(kT % LB == 0, "every h_bound point falls inside a stage");
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128 - (hopper::smem_addr(smem_raw) & 127)) & 127));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageFloats);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = blockIdx.x * kCh, b = blockIdx.y;
  const int nst = (L + kT - 1) / kT;  // stages a group
  const int total = (n + kMaxN - 1) / kMaxN * nst;
  const long long row0 = (long long)b * L;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], kTma ? 1 : 32);  // expect_tx, or each lane
      hopper::mbar_init(&empty[s], kFwdWarps);     // one arrival a consumer
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kFwdWarps) {  // the producer
    const int d = d0 + lane;
    for (int st = 0; st < total + kStages; ++st) {
      if (st >= kStages) {  // retire stage st - kStages: its y leaves
        const int done = st - kStages, slot = done % kStages;
        hopper::mbar_wait(&empty[slot], (done / kStages) & 1);
        store_y(ring + slot * kStageFloats + kTile, y, done < nst, row0,
                (done % nst) * kT, L, di, d, lane);
      }
      if (st >= total) continue;
      const int slot = st % kStages, t0 = (st % nst) * kT;
      const int n0 = st / nst * kMaxN;
      float* stage = ring + slot * kStageFloats;
      if (kTma) {
        hopper::fence_proxy_async();  // the slot's y was read by loads
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[slot], kStageBytes);
          hopper::tma_load_3d(stage, &map_dt, &full[slot], d0, t0, b);
          hopper::tma_load_3d(stage + kTile, &map_u, &full[slot], d0, t0, b);
          hopper::tma_load_3d(stage + 2 * kTile, &map_b, &full[slot], n0, t0,
                              b);
          hopper::tma_load_3d(stage + 2 * kTile + kBTile, &map_c, &full[slot],
                              n0, t0, b);
        }
      } else {
        fill_stage(stage, dt, u, bm, c, row0, t0, n0, L, di, n, d, lane);
        hopper::mbar_arrive(&full[slot]);
      }
    }
    return;
  }

  // consumer lane (ch, grp): states grp * kS .. grp * kS + kS - 1 of each
  // group for channel d; a channel past di computes on zeros (dA = 1)
  const int ch = tid / kG, grp = tid % kG;
  const int d = d0 + ch;
  const bool live = d < di;
  const int nblk = (L + LB - 1) / LB;
  int st = 0;
  for (int n0 = 0; n0 < n; n0 += kMaxN) {
    const int ng = min(kMaxN, n - n0);
    float a2[kS], h[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int s = grp * kS + j;
      a2[j] = (live && s < ng) ? a_t[(long long)(n0 + s) * di + d] * kLog2e
                               : 0.0f;
      h[j] = 0.0f;
    }
    for (int t0 = 0; t0 < L; t0 += kT, ++st) {
      const int slot = st % kStages;
      hopper::mbar_wait(&full[slot], (st / kStages) & 1);
      const float* sdt = ring + slot * kStageFloats;
      float* su = ring + slot * kStageFloats + kTile;  // u, then y
      const float* sb = su + kTile;
      const float* sc = sb + kBTile;
#pragma unroll
      for (int i0 = 0; i0 < kT; i0 += kG) {
        float part[kG];  // this lane's share of steps i0 .. i0 + kG - 1
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          const int i = i0 + r;
          if (i % LB == 0) {  // the state entering t0 + i
            const bool ok = live && t0 + i < L;
            float* hbp = hb + (((long long)b * nblk + (t0 + i) / LB) * n + n0) *
                                  (long long)di + d;
#pragma unroll
            for (int j = 0; j < kS; ++j)
              put_if(hbp + (long long)(grp * kS + j) * di, h[j],
                     ok && grp * kS + j < ng);
          }
          const float dtv = sdt[i * kCh + ch], uv = su[i * kCh + ch];
          float bv[kS], cv[kS];
#pragma unroll
          for (int q = 0; q < kS / 4; ++q) {
            const float4 b4 = *reinterpret_cast<const float4*>(
                sb + i * kMaxN + grp * kS + 4 * q);
            const float4 c4 = *reinterpret_cast<const float4*>(
                sc + i * kMaxN + grp * kS + 4 * q);
            bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y;
            bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
            cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y;
            cv[4 * q + 2] = c4.z, cv[4 * q + 3] = c4.w;
          }
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < kS; ++j) {
            const float dA = decay(dtv * a2[j]);
            h[j] = dA * h[j] + uv * bv[j];
            acc += cv[j] * h[j];
          }
          part[r] = acc;
        }
        // lane grp leaves step i0 + grp's y over its u, which every lane of
        // the channel has read (the shuffles need what they computed from it)
        put_y(su + (i0 + grp) * kCh + ch, step_sums(part, grp));
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }
  }
}

// -- the backward: a scan parallel over L ------------------------------------

constexpr int kBwdWarps = 8;     // time segments of a chunk, one a warp
constexpr int kFoldRow = 32 + 4; // a fold row: 32 lanes, padded (16-byte rows)

// floats of the backward's shared memory for segments of SEG steps
template <int SEG>
struct BwdSmem {
  static constexpr int kChunk = kBwdWarps * SEG;  // steps a chunk
  static constexpr int kTileRow = kMaxN + 1;      // padded dbm / dc tile row
  static constexpr int kSRow = kChunk + 4;        // a state's row of sB, sC
  static constexpr int kSB = kMaxN * kSRow;       // sB, sC
  static constexpr int kTile = kChunk * kTileRow; // tb, tc
  static constexpr int kLanes = kMaxN * kBwdWarps * 32;  // shb, sda
  static constexpr int kFold = kBwdWarps * SEG * kFoldRow;
  static constexpr int kPq = 2 * kBwdWarps * 32 * 2;
  static constexpr int kCarry = 2 * kMaxN * 32;
  static constexpr int kA = kMaxN * 32;
  static constexpr size_t kBytes =
      sizeof(float) *
      (size_t)(2 * kSB + 2 * kTile + 2 * kLanes + kFold + kPq + kCarry + kA);
};

// The sum over the warp's 32 lanes (channels) of the terms a warp left in
// its fold rows (row i = item i, column = lane): lane l adds item l % SEG
// over the SEG channels of its half, four at a time into four sums (the
// channels j % 4 == 0, 1, 2, 3 of the half, each in order), adds those as
// (0 + 1) + (2 + 3), then the halves meet by one shuffle (SEG = 16; for
// SEG = 32 each lane takes all 32 channels of item l).  Every lane returns
// the sum of item l % SEG, in a fixed order.
template <int SEG>
__device__ __forceinline__ float fold_lanes(const float* rows, int lane) {
  const float4* p = reinterpret_cast<const float4*>(
      rows + (lane % SEG) * kFoldRow + (lane / SEG) * SEG);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // four short chains
#pragma unroll
  for (int j = 0; j < SEG / 4; ++j) {
    const float4 v = p[j];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  float sum = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
  for (int o = SEG; o < 32; o *= 2) sum += __shfl_xor_sync(kFull, sum, o);
  return sum;
}

// grid (ceil(di / 32), B), block kBwdWarps warps.  Lane = channel, warp =
// time segment of SEG steps (SEG a multiple of LB, so that each
// segment starts at a state in h_bound).  A chunk is the block's
// kBwdWarps segments; the chunks run from the last to the first, the
// reverse carry of every (channel, state) passing between them through
// shared memory.  States run one after another inside the thread, in
// groups of kMaxN staged together.  Per state:
//   * forward over the segment from its h_bound entry: every exponential
//     once, kept with the entering state of each step in registers; the
//     terms h_t * dy_t go to the warp's fold rows;
//   * the segment's reverse map g_left = P g_right + Q (g = dA_{t+1} *
//     delta_{t+1}, the carry into step t from the right) goes to shared
//     memory; one barrier; each segment composes the maps of the segments
//     to its right onto the chunk's carry, in order, and segment 0 leaves
//     the next chunk's carry;
//   * the reverse walk over the segment emits ddt, du (summed over the
//     states in registers), the da partial, and the terms delta_t * u_t;
//   * the warp sums both kinds of terms over its 32 channels (fold_lanes)
//     into the chunk's dbm / dc tiles, which leave as coalesced rows of
//     per-(channel block) partials once a group of states is done.
// component j of v (j a constant after unrolling)
__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int LB, int SEG>
__global__ void __launch_bounds__(kBwdWarps * 32, 2) ssm_bwd_kernel(
    const float* __restrict__ dt, const float* __restrict__ u,
    const float* __restrict__ bm, const float* __restrict__ c,
    const float* __restrict__ a_t, const float* __restrict__ hb,
    const float* __restrict__ dy, float* __restrict__ ddt,
    float* __restrict__ du, float* __restrict__ dbp, float* __restrict__ dcp,
    float* __restrict__ datp, int L, int di, int n) {
  using S = BwdSmem<SEG>;
  constexpr int W = kBwdWarps, R = S::kChunk, T = W * 32;
  static_assert(SEG % LB == 0, "segments start at h_bound entries");
  extern __shared__ float smem[];
  float* sB = smem;                    // [kMaxN][kSRow] B of the chunk's steps
  float* sC = sB + S::kSB;             // [kMaxN][kSRow] C
  float* tb = sC + S::kSB;             // [R][kTileRow] sums of delta * u
  float* tc = tb + S::kTile;           // [R][kTileRow] sums of h * dy
  float* shb = tc + S::kTile;          // [kMaxN][W][32] state entering a segment
  float* sda = shb + S::kLanes;        // [kMaxN][W][32] da partials
  float* fold = sda + S::kLanes;       // [W][SEG][kFoldRow] terms to sum
  float2* pq = reinterpret_cast<float2*>(fold + S::kFold);  // [2][W][32]
  float* carry = reinterpret_cast<float*>(pq + 2 * W * 32); // [2][kMaxN][32]
  float* sa = carry + S::kCarry;       // [kMaxN][32] A of the group
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int d = blockIdx.x * kCh + lane;
  const int b = blockIdx.y;
  const int ncb = gridDim.x;
  const bool live = d < di;
  const int nblk = (L + LB - 1) / LB;
  const int nchunk = (L + R - 1) / R;
  const long long row0 = (long long)b * L;
  float* my_fold = fold + w * SEG * kFoldRow;
  int step = 0;  // states done by the block: the parity of their pq buffer
  for (int n0 = 0; n0 < n; n0 += kMaxN) {
    const int ng = min(kMaxN, n - n0);
    __syncthreads();  // the previous group's reads of sa, carry, sda are done
    for (int i = tid; i < kMaxN * 32; i += T) {
      const int s = i / 32, dd = blockIdx.x * kCh + i % 32;
      sa[i] = (s < ng && dd < di) ? a_t[(long long)(n0 + s) * di + dd] : 0.0f;
      carry[i] = 0.0f;  // nothing enters the last chunk from the right
    }
#pragma unroll
    for (int s = 0; s < kMaxN; ++s) sda[(s * W + w) * 32 + lane] = 0.0f;
    for (int q = 0; q < nchunk; ++q) {
      const int c0 = (nchunk - 1 - q) * R;  // the chunk's first step
      const int t0 = c0 + w * SEG;          // this segment's first step
      for (int i = tid; i < R * kMaxN; i += T) {
        const int tt = i / kMaxN, s = i % kMaxN;
        const bool ok = c0 + tt < L && s < ng;
        sB[s * S::kSRow + tt] = ok ? bm[(row0 + c0 + tt) * n + n0 + s] : 0.0f;
        sC[s * S::kSRow + tt] = ok ? c[(row0 + c0 + tt) * n + n0 + s] : 0.0f;
      }
      {
        const bool ok = live && t0 < L;
        const float* hbp =
            hb + (((long long)b * nblk + t0 / LB) * n + n0) * (long long)di + d;
#pragma unroll
        for (int s = 0; s < kMaxN; ++s)
          shb[(s * W + w) * 32 + lane] =
              (ok && s < ng) ? hbp[(long long)s * di] : 0.0f;
      }
      // steps past L are the identity: dt = u = dy = 0 (dA = 1), B = C = 0
      float dtv[SEG], uv[SEG], dyv[SEG], gdt[SEG], gdu[SEG];
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const bool ok = live && t0 + i < L;
        const long long off = (row0 + t0 + i) * di + d;
        dtv[i] = ok ? dt[off] : 0.0f;
        uv[i] = ok ? u[off] : 0.0f;
        dyv[i] = ok ? dy[off] : 0.0f;
        gdt[i] = 0.0f;
        gdu[i] = 0.0f;
      }
      __syncthreads();  // sB, sC, sa and carry are staged
      for (int s = 0; s < ng; ++s, ++step) {
        // this segment's B and C of state s, four steps a load
        const float4* b4 =
            reinterpret_cast<const float4*>(sB + s * S::kSRow + w * SEG);
        const float4* c4 =
            reinterpret_cast<const float4*>(sC + s * S::kSRow + w * SEG);
        const float a = sa[s * 32 + lane];
        float h = shb[(s * W + w) * 32 + lane];
        float dA[SEG], hp[SEG];
#pragma unroll
        for (int i4 = 0; i4 < SEG / 4; ++i4) {
          const float4 bq = b4[i4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * i4 + j;
            dA[i] = expf(dtv[i] * a);
            hp[i] = h;
            h = dA[i] * h + uv[i] * lane4(bq, j);
            my_fold[i * kFoldRow + lane] = h * dyv[i];
          }
        }
        float P = 1.0f, Q = 0.0f;
#pragma unroll
        for (int i4 = SEG / 4 - 1; i4 >= 0; --i4) {
          const float4 cq = c4[i4];
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            const int i = 4 * i4 + j;
            Q = fmaf(dA[i], Q, dA[i] * (lane4(cq, j) * dyv[i]));
            P *= dA[i];
          }
        }
        float2* pqs = pq + (step & 1) * W * 32;
        pqs[w * 32 + lane] = make_float2(P, Q);
        __syncwarp();
        const float sum_c = fold_lanes<SEG>(my_fold, lane);
        if (lane < SEG) tc[(w * SEG + lane) * S::kTileRow + s] = sum_c;
        __syncthreads();  // every segment's (P, Q) is in
        float g = carry[((q & 1) * kMaxN + s) * 32 + lane];
#pragma unroll
        for (int w2 = W - 1; w2 > 0; --w2) {
          if (w2 > w) {
            const float2 o = pqs[w2 * 32 + lane];
            g = fmaf(o.x, g, o.y);
          }
        }
        if (w == 0)
          carry[(((q + 1) & 1) * kMaxN + s) * 32 + lane] = fmaf(P, g, Q);
        float da = 0.0f;
#pragma unroll
        for (int i4 = SEG / 4 - 1; i4 >= 0; --i4) {
          const float4 bq = b4[i4], cq = c4[i4];
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            const int i = 4 * i4 + j;
            const float cdy = lane4(cq, j) * dyv[i];
            const float delta = g + cdy;
            const float ddA = delta * hp[i] * dA[i];  // d / d(dt * a)
            gdt[i] += ddA * a;
            da += ddA * dtv[i];
            gdu[i] += delta * lane4(bq, j);
            my_fold[i * kFoldRow + lane] = delta * uv[i];
            g = fmaf(dA[i], g, dA[i] * cdy);  // dA * delta, off delta's path
          }
        }
        sda[(s * W + w) * 32 + lane] += da;
        __syncwarp();
        const float sum_b = fold_lanes<SEG>(my_fold, lane);
        if (lane < SEG) tb[(w * SEG + lane) * S::kTileRow + s] = sum_b;
        __syncwarp();  // the fold rows are read before the next state writes
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          if (t0 + i < L) {
            const long long off = (row0 + t0 + i) * di + d;
            ddt[off] = n0 == 0 ? gdt[i] : ddt[off] + gdt[i];
            du[off] = n0 == 0 ? gdu[i] : du[off] + gdu[i];
          }
        }
      }
      __syncthreads();  // the chunk's tiles are complete
      for (int i = tid; i < R * kMaxN; i += T) {
        const int tt = i / kMaxN, s = i % kMaxN;
        if (c0 + tt < L && s < ng) {
          const long long o =
              (((long long)b * ncb + blockIdx.x) * L + c0 + tt) * n + n0 + s;
          dbp[o] = tb[tt * S::kTileRow + s];
          dcp[o] = tc[tt * S::kTileRow + s];
        }
      }
      __syncthreads();  // the next chunk may restage sB, sC and the tiles
    }
    // da_t's per-batch partial: the segments' sums in order
    for (int i = tid; i < ng * 32; i += T) {
      const int s = i / 32, l = i % 32, dd = blockIdx.x * kCh + l;
      if (dd < di) {
        float acc = 0.0f;
        for (int w2 = 0; w2 < W; ++w2) acc += sda[(s * W + w2) * 32 + l];
        datp[((long long)b * n + n0 + s) * di + dd] = acc;
      }
    }
  }  // state groups
}

// out[o, j] = sum_p in[o, p, j], p in order
__global__ void sum_parts_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, long long outer,
                                 int parts, long long inner) {
  const long long total = outer * inner;
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    const long long o = j / inner, r = j % inner;
    const float* p = in + o * parts * inner + r;
    float acc = 0.0f;
    for (int q = 0; q < parts; ++q) acc += p[q * inner];
    out[j] = acc;
  }
}

int sum_parts(const float* in, float* out, long long outer, int parts,
              long long inner, cudaStream_t s) {
  const long long total = outer * inner;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  sum_parts_kernel<<<blocks, threads, 0, s>>>(in, out, outer, parts, inner);
  return (int)cudaGetLastError();
}

// a row-major fp32 tensor (batch, rows, inner) as a TMA map read in boxes
// of box_inner x kT x 1, no swizzle, zeros past the edges
bool make_map_f32(CUtensorMap* map, const float* base, int batch, int rows,
                  int inner, int box_inner) {
  hopper::EncodeTiled enc = hopper::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * sizeof(float),
                                 (cuuint64_t)inner * rows * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)kT, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<float*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int LB, bool kTma>
int launch_fwd(const float* dt, const float* u, const float* bm,
               const float* c, const float* a_t, float* y, float* hb, int b,
               int L, int di, int n, cudaStream_t s) {
  CUtensorMap map_dt{}, map_u{}, map_b{}, map_c{};
  if (kTma && (!make_map_f32(&map_dt, dt, b, L, di, kCh) ||
               !make_map_f32(&map_u, u, b, L, di, kCh) ||
               !make_map_f32(&map_b, bm, b, L, n, kMaxN) ||
               !make_map_f32(&map_c, c, b, L, n, kMaxN)))
    return (int)cudaErrorInvalidValue;
  auto kernel = ssm_fwd_ring_kernel<LB, kTma>;
  // the attribute belongs to the current device's context: set on every
  // launch (a no-op while the ring fits the default 48 KB)
  const cudaError_t e = hopper::allow_smem(kernel, kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((di + kCh - 1) / kCh, b);
  kernel<<<grid, kFwdThreads, kFwdSmem, s>>>(map_dt, map_u, map_b, map_c, dt,
                                             u, bm, c, a_t, y, hb, L, di, n);
  return (int)cudaGetLastError();
}

// TMA takes rows whose pitch is a multiple of 16 bytes from 16-byte bases
template <int LB>
int dispatch_fwd(const float* dt, const float* u, const float* bm,
                 const float* c, const float* a_t, float* y, float* hb, int b,
                 int L, int di, int n, cudaStream_t s) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (di % 4 == 0 && n % 4 == 0 && aligned(dt) && aligned(u) &&
      aligned(bm) && aligned(c))
    return launch_fwd<LB, true>(dt, u, bm, c, a_t, y, hb, b, L, di, n, s);
  return launch_fwd<LB, false>(dt, u, bm, c, a_t, y, hb, b, L, di, n, s);
}

template <int LB>
int launch_bwd(const float* dt, const float* u, const float* bm,
               const float* c, const float* a_t, const float* hb,
               const float* dy, float* ddt, float* du, float* dbp, float* dcp,
               float* datp, int b, int L, int di, int n, cudaStream_t s) {
  constexpr int SEG = LB < 16 ? 16 : LB;
  const size_t smem = BwdSmem<SEG>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      ssm_bwd_kernel<LB, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((di + kCh - 1) / kCh, b);
  ssm_bwd_kernel<LB, SEG><<<grid, kBwdWarps * 32, smem, s>>>(
      dt, u, bm, c, a_t, hb, dy, ddt, du, dbp, dcp, datp, L, di, n);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int L, int di, int n) {
  return b <= 0 || L <= 0 || di <= 0 || n <= 0;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Shapes as in the contract
// above; lb is 8, 16 or 32.  Return cudaGetLastError() after the launches
// (0 on success).

extern "C" int kf_ssm_scan_fwd(const void* dt, const void* u, const void* bm,
                               const void* c, const void* a_t, void* y,
                               void* h_bound, int b, int L, int di, int n,
                               int lb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, L, di, n)) return (int)cudaErrorInvalidValue;
  const float *pdt = static_cast<const float*>(dt), *pu = static_cast<const float*>(u),
              *pb = static_cast<const float*>(bm), *pc = static_cast<const float*>(c),
              *pa = static_cast<const float*>(a_t);
  float *py = static_cast<float*>(y), *ph = static_cast<float*>(h_bound);
  switch (lb) {
    case 8: return dispatch_fwd<8>(pdt, pu, pb, pc, pa, py, ph, b, L, di, n, s);
    case 16: return dispatch_fwd<16>(pdt, pu, pb, pc, pa, py, ph, b, L, di, n, s);
    case 32: return dispatch_fwd<32>(pdt, pu, pb, pc, pa, py, ph, b, L, di, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Scratch from the caller: dbp, dcp (B, ceil(di/32), L, N) and datp
// (B, N, di), all fp32; the results dbm, dc (B, L, N) and da_t (N, di) are
// their sums over the channel blocks and over the batch.
extern "C" int kf_ssm_scan_bwd(const void* dt, const void* u, const void* bm,
                               const void* c, const void* a_t,
                               const void* h_bound, const void* dy, void* ddt,
                               void* du, void* dbm, void* dc, void* da_t,
                               void* dbp, void* dcp, void* datp, int b, int L,
                               int di, int n, int lb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(b, L, di, n)) return (int)cudaErrorInvalidValue;
  const float *pdt = static_cast<const float*>(dt), *pu = static_cast<const float*>(u),
              *pb = static_cast<const float*>(bm), *pc = static_cast<const float*>(c),
              *pa = static_cast<const float*>(a_t),
              *ph = static_cast<const float*>(h_bound),
              *pdy = static_cast<const float*>(dy);
  float *pddt = static_cast<float*>(ddt), *pdu = static_cast<float*>(du),
        *pdbp = static_cast<float*>(dbp), *pdcp = static_cast<float*>(dcp),
        *pdatp = static_cast<float*>(datp);
  int err;
  switch (lb) {
    case 8: err = launch_bwd<8>(pdt, pu, pb, pc, pa, ph, pdy, pddt, pdu, pdbp,
                                pdcp, pdatp, b, L, di, n, s); break;
    case 16: err = launch_bwd<16>(pdt, pu, pb, pc, pa, ph, pdy, pddt, pdu, pdbp,
                                  pdcp, pdatp, b, L, di, n, s); break;
    case 32: err = launch_bwd<32>(pdt, pu, pb, pc, pa, ph, pdy, pddt, pdu, pdbp,
                                  pdcp, pdatp, b, L, di, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int ncb = (di + kCh - 1) / kCh;
  const long long ln = (long long)L * n;
  if ((err = sum_parts(pdbp, static_cast<float*>(dbm), b, ncb, ln, s))) return err;
  if ((err = sum_parts(pdcp, static_cast<float*>(dc), b, ncb, ln, s))) return err;
  return sum_parts(pdatp, static_cast<float*>(da_t), 1, b, (long long)n * di, s);
}
