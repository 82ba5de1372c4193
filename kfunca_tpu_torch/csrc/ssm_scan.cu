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
// The forward walks L inside the thread:
//   * four adjacent lanes own one (batch, channel) pair, each holding four
//     of a group's 16 states and the matching values of A in registers;
//     the sum over the states (y) meets by two shuffles.  A block is 32
//     adjacent channels (128 threads): 2,560 warps at the training shape;
//   * bm and c of an L-block are staged in shared memory once for the
//     block's channels (a broadcast read), and the block's dt and u are
//     loaded into registers before its steps start, so that the loads of
//     a block are in flight together; the state entering each L-block
//     goes to h_bound.
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
// expf, not __expf, and no fast-math flags: the recurrence compounds
// per-step rounding multiplicatively.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;      // channels per block
constexpr int kMaxN = 16;    // states in one group (one walk over L)
constexpr int kG = 4;        // lanes per channel, splitting its states
constexpr int kS = kMaxN / kG;  // states per thread, in registers
constexpr int kThreads = kCh * kG;
constexpr unsigned kFull = 0xffffffffu;

// sum over the kG lanes of a channel (adjacent lanes), the same bits in each
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

template <int LB>
__global__ void __launch_bounds__(kThreads) ssm_fwd_kernel(
    const float* __restrict__ dt, const float* __restrict__ u,
    const float* __restrict__ bm, const float* __restrict__ c,
    const float* __restrict__ a_t, float* __restrict__ y,
    float* __restrict__ hb, int L, int di, int n) {
  __shared__ float sB[LB][kMaxN], sC[LB][kMaxN];
  const int tid = threadIdx.x, ch = tid / kG, grp = tid % kG;
  const int d = blockIdx.x * kCh + ch;
  const int b = blockIdx.y;
  const bool live = d < di;
  const int nblk = (L + LB - 1) / LB;
  const long long row0 = (long long)b * L;
  // states n0 .. n0 + ng - 1 of this group; s below counts within it
  for (int n0 = 0; n0 < n; n0 += kMaxN) {
  const int ng = min(kMaxN, n - n0);
  float a[kS], h[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int s = grp * kS + j;
    a[j] = (live && s < ng) ? a_t[(long long)(n0 + s) * di + d] : 0.0f;
    h[j] = 0.0f;
  }
  for (int k = 0; k < nblk; ++k) {
    const int t0 = k * LB;
    const int len = min(LB, L - t0);
    __syncthreads();  // the previous block's reads of sB / sC are done
    for (int i = tid; i < LB * kMaxN; i += kThreads) {
      const int tt = i / kMaxN, s = i % kMaxN;
      const bool ok = tt < len && s < ng;
      sB[tt][s] = ok ? bm[(row0 + t0 + tt) * n + n0 + s] : 0.0f;
      sC[tt][s] = ok ? c[(row0 + t0 + tt) * n + n0 + s] : 0.0f;
    }
    __syncthreads();
    if (live) {
      float* hbp = hb + (((long long)b * nblk + k) * n + n0) * (long long)di + d;
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (grp * kS + j < ng) hbp[(long long)(grp * kS + j) * di] = h[j];
    }
    // a channel's lanes load the same values (one sector a warp); a lane
    // of a channel past di computes on zeros, as the shuffles need it
    float dtv[LB], uv[LB];
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const long long off = (row0 + t0 + i) * di + d;
      dtv[i] = (live && i < len) ? dt[off] : 0.0f;
      uv[i] = (live && i < len) ? u[off] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      if (i < len) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const int s = grp * kS + j;
          if (s < ng) {
            const float dA = expf(dtv[i] * a[j]);
            h[j] = dA * h[j] + uv[i] * sB[i][s];
            acc += sC[i][s] * h[j];
          }
        }
        acc = group_sum(acc);
        if (live && grp == 0) {
          float* yp = y + (row0 + t0 + i) * di + d;
          *yp = n0 == 0 ? acc : *yp + acc;
        }
      }
    }
  }
  }  // state groups
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

template <int LB>
int launch_fwd(const float* dt, const float* u, const float* bm,
               const float* c, const float* a_t, float* y, float* hb, int b,
               int L, int di, int n, cudaStream_t s) {
  const dim3 grid((di + kCh - 1) / kCh, b);
  ssm_fwd_kernel<LB><<<grid, kThreads, 0, s>>>(dt, u, bm, c, a_t, y, hb, L, di, n);
  return (int)cudaGetLastError();
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
    case 8: return launch_fwd<8>(pdt, pu, pb, pc, pa, py, ph, b, L, di, n, s);
    case 16: return launch_fwd<16>(pdt, pu, pb, pc, pa, py, ph, b, L, di, n, s);
    case 32: return launch_fwd<32>(pdt, pu, pb, pc, pa, py, ph, b, L, di, n, s);
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
