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
// masked here.  Any N: a thread block walks the states in groups of
// kMaxN = 16 (every published Mamba-1 and Jamba state width is one group),
// each group a full walk over L; from the second group on y (forward) and
// ddt, du (backward) add to what the earlier groups left, in the same
// thread and in group order, so the sums stay in a fixed order.
//
// What bounds it.  Per (b, t, d, n) the forward does one exponential and
// three multiply-adds; the backward needs the exponential again.  At the
// training shape (B 4, L 2048, di 5120, N 16) that is 671 M exponentials a
// pass, ~0.16 ms at the SFUs' rate (16 a clock an SM, 1/16 of the fp32
// FLOP rate), while the bytes (dt, u, y and h_bound in the forward; dt, u,
// dy, h_bound, ddt and du in the backward) take 0.2-0.3 ms at 3.35 TB/s.
// The TPU kernel walks the grid's L axis in order and carries the state
// between grid steps in VMEM scratch; on the card the blocks run at once,
// so the walk over L moves inside the thread:
//   * four adjacent lanes own one (batch, channel) pair, each holding four
//     of a group's 16 states, the matching values of A and (backward) the reverse
//     carry and the da sums in registers; sums over the states (y, ddt,
//     du) meet by two shuffles.  A block is 32 adjacent channels (128
//     threads): 2,560 warps at the training shape, ~19 an SM;
//   * bm and c of an L-block are staged in shared memory once for the
//     block's channels (a broadcast read), and the block's dt, u (and dy)
//     are loaded into registers before its steps start, so that the loads
//     of a block are in flight together;
//   * the backward recomputes each block's states from h_bound into a
//     shared-memory history (one column a thread), walks the block in
//     reverse, and leaves per-step contributions (delta * u and h * dy)
//     in two shared arrays; the block then sums them over its 32 channels
//     in a fixed order and writes per-block partials of dbm and dc, as the
//     TPU kernel writes partials per di-tile.  A second small kernel sums
//     those partials, and da_t's per-batch partials, in a fixed order: no
//     atomics, so two runs give the same bits;
//   * expf, not __expf, and no fast-math flags: the recurrence compounds
//     per-step rounding multiplicatively.
// The walk over L is sequential in each thread, so the kernels are bound by
// latency, not by either bound above.  Left for later: a chunked parallel
// scan over L.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;      // channels per block
constexpr int kMaxN = 16;    // states in one group (one walk over L)
constexpr int kG = 4;        // lanes per channel, splitting its states
constexpr int kS = kMaxN / kG;  // states per thread, in registers
constexpr int kThreads = kCh * kG;
constexpr int kRow = kThreads + 1;  // shared rows padded against bank conflicts
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

template <int LB>
constexpr size_t bwd_smem_bytes() {
  // history: LB + 1 slots (the state entering the block, then h_0..h_LB-1),
  // and the h * dy contributions: LB slots, each kS rows of kRow
  return (size_t)(2 * LB + 1) * kS * kRow * sizeof(float);
}

template <int LB>
__global__ void __launch_bounds__(kThreads) ssm_bwd_kernel(
    const float* __restrict__ dt, const float* __restrict__ u,
    const float* __restrict__ bm, const float* __restrict__ c,
    const float* __restrict__ a_t, const float* __restrict__ hb,
    const float* __restrict__ dy, float* __restrict__ ddt,
    float* __restrict__ du, float* __restrict__ dbp, float* __restrict__ dcp,
    float* __restrict__ datp, int L, int di, int n) {
  extern __shared__ float smem[];
  // hist[slot][j][thread] and cbuf[slot][j][thread]: a thread's state
  // grp * kS + j of channel ch sits at column tid = ch * kG + grp
  float* hist = smem;
  float* cbuf = smem + (LB + 1) * kS * kRow;
  __shared__ float sB[LB][kMaxN], sC[LB][kMaxN];
  const int tid = threadIdx.x, ch = tid / kG, grp = tid % kG;
  const int d = blockIdx.x * kCh + ch;
  const int b = blockIdx.y;
  const int ncb = gridDim.x;
  const bool live = d < di;
  const int cols = min(kCh, di - (int)blockIdx.x * kCh);
  const int nblk = (L + LB - 1) / LB;
  const long long row0 = (long long)b * L;
  // states n0 .. n0 + ng - 1 of this group; s below counts within it
  for (int n0 = 0; n0 < n; n0 += kMaxN) {
  const int ng = min(kMaxN, n - n0);
  float a[kS], g[kS], da[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int s = grp * kS + j;
    a[j] = (live && s < ng) ? a_t[(long long)(n0 + s) * di + d] : 0.0f;
    g[j] = 0.0f;   // dA_{t+1} * delta_{t+1}, carried from the right
    da[j] = 0.0f;
  }
  for (int k = nblk - 1; k >= 0; --k) {
    const int t0 = k * LB;
    const int len = min(LB, L - t0);
    __syncthreads();  // the previous block's reduction reads are done
    for (int i = tid; i < LB * kMaxN; i += kThreads) {
      const int tt = i / kMaxN, s = i % kMaxN;
      const bool ok = tt < len && s < ng;
      sB[tt][s] = ok ? bm[(row0 + t0 + tt) * n + n0 + s] : 0.0f;
      sC[tt][s] = ok ? c[(row0 + t0 + tt) * n + n0 + s] : 0.0f;
    }
    __syncthreads();
    float dtv[LB], uv[LB], dyv[LB];
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const long long off = (row0 + t0 + i) * di + d;
      dtv[i] = (live && i < len) ? dt[off] : 0.0f;
      uv[i] = (live && i < len) ? u[off] : 0.0f;
      dyv[i] = (live && i < len) ? dy[off] : 0.0f;
    }
    // recompute the block's states from the one entering it
    const float* hbp =
        hb + (((long long)b * nblk + k) * n + n0) * (long long)di + d;
    float h[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int s = grp * kS + j;
      h[j] = (live && s < ng) ? hbp[(long long)s * di] : 0.0f;
      hist[j * kRow + tid] = h[j];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      if (i < len) {
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const int s = grp * kS + j;
          if (s < ng) {
            const float dA = expf(dtv[i] * a[j]);
            h[j] = dA * h[j] + uv[i] * sB[i][s];
            hist[((i + 1) * kS + j) * kRow + tid] = h[j];
            cbuf[(i * kS + j) * kRow + tid] = h[j] * dyv[i];
          }
        }
      }
    }
    // the reverse recurrence over the block
#pragma unroll
    for (int i = LB - 1; i >= 0; --i) {
      if (i < len) {
        float sdt = 0.0f, sdu = 0.0f;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const int s = grp * kS + j;
          if (s < ng) {
            const float dA = expf(dtv[i] * a[j]);
            const float delta = g[j] + sC[i][s] * dyv[i];
            const float hp = hist[(i * kS + j) * kRow + tid];
            const float ddA = delta * hp * dA;  // d / d(dt * a)
            sdt += ddA * a[j];
            da[j] += ddA * dtv[i];
            sdu += delta * sB[i][s];
            // slot i + 1 (h_i) is no longer read: it takes delta * u
            hist[((i + 1) * kS + j) * kRow + tid] = delta * uv[i];
            g[j] = dA * delta;
          }
        }
        sdt = group_sum(sdt);
        sdu = group_sum(sdu);
        if (live && grp == 0) {
          const long long off = (row0 + t0 + i) * di + d;
          ddt[off] = n0 == 0 ? sdt : ddt[off] + sdt;
          du[off] = n0 == 0 ? sdu : du[off] + sdu;
        }
      }
    }
    __syncthreads();
    // dbm and dc of this block's steps, summed over the block's channels
    // in a fixed order
    for (int r = tid; r < len * ng; r += kThreads) {
      const int i = r / ng, s = r % ng;
      const int j = s % kS, col = s / kS;
      const float* pb = hist + ((i + 1) * kS + j) * kRow + col;
      const float* pc = cbuf + (i * kS + j) * kRow + col;
      float sb = 0.0f, sc = 0.0f;
      for (int cc = 0; cc < cols; ++cc) {
        sb += pb[cc * kG];
        sc += pc[cc * kG];
      }
      const long long o =
          (((long long)b * ncb + blockIdx.x) * L + t0 + i) * n + n0 + s;
      dbp[o] = sb;
      dcp[o] = sc;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int s = grp * kS + j;
      if (s < ng) datp[((long long)b * n + n0 + s) * di + d] = da[j];
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
  const size_t smem = bwd_smem_bytes<LB>();
  cudaError_t e = cudaFuncSetAttribute(
      ssm_bwd_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((di + kCh - 1) / kCh, b);
  ssm_bwd_kernel<LB><<<grid, kThreads, smem, s>>>(dt, u, bm, c, a_t, hb, dy, ddt,
                                             du, dbp, dcp, datp, L, di, n);
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
