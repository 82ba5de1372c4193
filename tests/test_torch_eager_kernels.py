"""The eager API's kernels K3, K7, K8 and K9, on the CPU.

Two kinds of test, at small shapes:
  * parity: each kernel's plain PyTorch version (what the wrapper runs for
    CPU tensors) against the JAX package's Pallas kernel in interpret mode,
    as tests/test_pallas_kernels.py runs it, on the same numpy inputs;
  * tiling: a pure-torch emulation of each CUDA kernel's own blocking
    (csrc/matmul.cu, csrc/reduce.cu, csrc/elementwise.cu) -- its tile
    loops, masking of ragged edges, mma fragment layout, per-thread
    accumulators and fixed-order merges -- against the plain version.
    The kernels themselves run only on the card (tests/test_torch_cuda.py
    and chip_smoke.py hold them to these plain versions there).

Tolerances: fp32 1e-4 relative (other summation orders), bf16 one bf16 step
of the largest magnitude, integers and the elementwise contract exact.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.ops.pallas_kernels.elementwise import elementwise as jax_ew
from kfunca_tpu.ops.pallas_kernels.matmul import matmul as jax_matmul
from kfunca_tpu.ops.pallas_kernels.reduce import reduce_2d as jax_reduce
from kfunca_tpu.ops.pallas_kernels.welford import welford_norm_stat as jax_welford
from kfunca_tpu_torch.ops.pallas_kernels import bitonic_sort as k10
from kfunca_tpu_torch.ops.pallas_kernels import elementwise as k9
from kfunca_tpu_torch.ops.pallas_kernels import matmul as k3
from kfunca_tpu_torch.ops.pallas_kernels import reduce as k8
from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as k11
from kfunca_tpu_torch.ops.pallas_kernels import welford as k7


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# -- K3: matmul + epilogue ------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128), (123, 57, 34)])
def test_k3_plain_matches_pallas_fp32(m, k, n):
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    want = jax_matmul(jnp.asarray(a), jnp.asarray(b), bm=128, bn=128, bk=128,
                      interpret=True)
    got = k3.matmul(_t(a), _t(b))  # CPU tensors: the plain version
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("epi", ["bias", "bias_gelu", "bias_silu", "relu",
                                 "bias_res", "res", "silu_res"])
def test_k3_epilogues_match_pallas(epi):
    rng = np.random.default_rng(3)
    m, k, n = 256, 384, 128
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    bias = rng.uniform(-1, 1, (n,)).astype(np.float32)
    res = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    jkw, tkw = {}, {}
    if "bias" in epi:
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), _t(bias)
    if "res" in epi:
        jkw["residual"], tkw["residual"] = jnp.asarray(res), _t(res)
    want = jax_matmul(jnp.asarray(a), jnp.asarray(b), epilogue=epi, bm=128,
                      bn=128, bk=128, interpret=True, **jkw)
    got = k3.matmul(_t(a), _t(b), epilogue=epi, **tkw)
    _close(got.numpy(), want)


def test_k3_bf16_and_int8_match_pallas():
    rng = np.random.default_rng(6)
    a = rng.uniform(-2, 2, (128, 256)).astype(np.float32)
    b = rng.uniform(-2, 2, (256, 128)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jax_matmul(ja, jb, bm=128, bn=128, bk=128, interpret=True),
                      np.float32)
    ta = _t(np.asarray(ja, np.float32)).bfloat16()
    tb = _t(np.asarray(jb, np.float32)).bfloat16()
    got = k3.matmul(ta, tb)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, rtol=2.0 ** -7)
    a8 = rng.integers(-128, 128, (64, 200)).astype(np.int8)
    b8 = rng.integers(-128, 128, (200, 96)).astype(np.int8)
    want8 = jax_matmul(jnp.asarray(a8), jnp.asarray(b8), bm=128, bn=128, bk=128,
                       interpret=True)
    got8 = k3.matmul(_t(a8), _t(b8))
    assert got8.dtype == torch.int32
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(got8.numpy(), a8.astype(np.int64) @ b8.astype(np.int64))


def test_k3_wrapper_checks():
    a = torch.ones((4, 5))
    with pytest.raises(ValueError, match=r"\(m, k\) @ \(k, n\)"):
        k3.matmul(a, torch.ones((4, 5)))
    with pytest.raises(TypeError, match="share one of"):
        k3.matmul(a, torch.ones((5, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="bias disagree"):
        k3.matmul(a, torch.ones((5, 3)), epilogue="bias")
    with pytest.raises(ValueError, match="bias must be"):
        k3.matmul(a, torch.ones((5, 3)), bias=torch.ones(4), epilogue="bias")
    with pytest.raises(ValueError, match="unsupported device"):
        k3.matmul(a.to("meta"), torch.ones((5, 3), device="meta"))


# the CUDA kernel's mma.sync body: one 128 x 64 output tile, k steps of 32,
# 8 warps as 2 x 4, a warp 64 x 16 = 4 x 2 mma tiles of m16n8k16
BM, BN = k3.MMA_TILE
BK = 32


def _mma_m16n8k16(a_tile, b_tile):
    """One mma.sync.m16n8k16 (row.col) through the kernel's fragment
    offsets: the a and b tiles are rebuilt only from the elements the 32
    lanes' registers read (so an offset that misses an element leaves a
    zero there), and the result only from the (row, col) each lane's four
    accumulators are stored to."""
    d = torch.zeros((16, 8), dtype=torch.float64)
    a_reg = {}
    b_reg = {}
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        # kernel: af[0] = (g, 2t4..), af[1] = (g+8, ..), af[2] = (g, 2t4+8..),
        # af[3] = (g+8, 2t4+8..); bf[0] = k 2t4, 2t4+1 of column g; bf[1] = +8
        a_reg[lane] = [(g, 2 * t4), (g + 8, 2 * t4), (g, 2 * t4 + 8), (g + 8, 2 * t4 + 8)]
        b_reg[lane] = [(2 * t4, g), (2 * t4 + 8, g)]
    # the ISA's fragment layouts, element by element: A row = g (+8 for
    # a2,a3,a6,a7), col = 2t4 + i (+8 for a4..a7); B k = 2t4 + i (+8 for
    # b2,b3), n = g; C row = g (+8 for c2,c3), col = 2t4 + (0, 1)
    A = torch.zeros((16, 16), dtype=torch.float64)
    B = torch.zeros((16, 8), dtype=torch.float64)
    for lane in range(32):
        for r, c in a_reg[lane]:
            for i in range(2):
                A[r, c + i] = a_tile[r, c + i]
        for kk, n in b_reg[lane]:
            for i in range(2):
                B[kk + i, n] = b_tile[kk + i, n]
    full = A @ B
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for r in range(4):
            row, col = g + (r >> 1) * 8, t4 * 2 + (r & 1)
            d[row, col] = full[row, col]
    return d


def _emulate_mma_gemm(a, b):
    """The mma.sync body's loops: tiles zero-filled past the edges (the
    load8 masking), per-warp 64 x 16 sub-tiles of 4 x 2 mma tiles over k
    steps of 16, then the masked store."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.zeros((m, n), dtype=torch.float64)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            acc = torch.zeros((BM, BN), dtype=torch.float64)
            for k0 in range(0, k, BK):
                at = torch.zeros((BM, BK), dtype=torch.float64)
                bt = torch.zeros((BK, BN), dtype=torch.float64)
                sa = a[m0:m0 + BM, k0:k0 + BK]
                sb = b[k0:k0 + BK, n0:n0 + BN]
                at[:sa.shape[0], :sa.shape[1]] = sa
                bt[:sb.shape[0], :sb.shape[1]] = sb
                for kk in range(0, BK, 16):
                    for warp in range(8):
                        wm, wn = warp >> 2, warp & 3
                        for mi in range(BM // 32):
                            for ni in range(BN // 32):
                                r0 = wm * (BM // 2) + mi * 16
                                c0 = wn * (BN // 4) + ni * 8
                                acc[r0:r0 + 16, c0:c0 + 8] += _mma_m16n8k16(
                                    at[r0:r0 + 16, kk:kk + 16],
                                    bt[kk:kk + 16, c0:c0 + 8])
            rows, cols = min(BM, m - m0), min(BN, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out


def test_k3_tensor_core_tiling_emulation():
    """Ragged m, k, n across tile edges: the emulated blocking gives the
    plain product exactly (float64 sums of bf16-exact values)."""
    rng = np.random.default_rng(9)
    m, k, n = 130, 45, 137
    a = torch.from_numpy(rng.integers(-8, 8, (m, k)).astype(np.float64))
    b = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.float64))
    assert torch.equal(_emulate_mma_gemm(a, b), a @ b)


def _wgmma_fragment(acc_tile):
    """The (row, column) of a 64 x n accumulator that thread tid's
    register r holds in wgmma's m64nN layout (warp w = tid // 32 holds rows
    16w + g and 16w + g + 8, g = lane // 4; register 4j + 2i + e is column
    8j + 2t + e, t = lane % 4, of row 16w + g + 8i), read back into a tile
    the way the epilogue stores it: every element exactly once."""
    rows, n = acc_tile.shape
    out = torch.full_like(acc_tile, float("nan"))
    for tid in range(128):
        w, lane = tid // 32, tid % 32
        g, t = lane >> 2, lane & 3
        for r in range(n // 2):
            j, i, e = r // 4, (r >> 1) & 1, r & 1
            row, col = 16 * w + g + 8 * i, 8 * j + 2 * t + e
            assert torch.isnan(out[row, col])
            out[row, col] = acc_tile[row, col]
    return out


def _emulate_wgmma_gemm(a, b, bn, epilogue="", bias=None, residual=None):
    """The wgmma body's loops: 128 x bn output tiles; per stage a 128 x 64
    box of a and bn / 64 boxes of 64 x 64 of b, zero-filled past the edges
    as TMA fills them; two consumers of 64 rows each summing the stages in
    order (four k16 steps a stage); the epilogue in the kernel's order on
    the accumulator fragments; the masked store."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.zeros((m, n), dtype=a.dtype)

    def box(x, r0, c0, rows, cols):
        t = torch.zeros((rows, cols), dtype=x.dtype)
        part = x[r0:r0 + rows, c0:c0 + cols]
        t[:part.shape[0], :part.shape[1]] = part
        return t

    for m0 in range(0, m, 128):
        for n0 in range(0, n, bn):
            acc = torch.zeros((128, bn), dtype=a.dtype)
            for k0 in range(0, k, 64):
                ab = box(a, m0, k0, 128, 64)
                bb = torch.cat([box(b, k0, n0 + 64 * j, 64, 64)
                                for j in range(bn // 64)], dim=1)
                for c in range(2):
                    for kk in range(0, 64, 16):
                        acc[64 * c:64 * c + 64] += (
                            ab[64 * c:64 * c + 64, kk:kk + 16] @ bb[kk:kk + 16])
            tile = torch.cat([_wgmma_fragment(acc[64 * c:64 * c + 64])
                              for c in range(2)])
            if epilogue:
                rows = slice(m0, min(m0 + 128, m))
                cols = slice(n0, min(n0 + bn, n))
                full = torch.zeros((128, bn), dtype=a.dtype)
                full[:rows.stop - m0, :cols.stop - n0] = (
                    k3.apply_epilogue_plain(
                        tile[:rows.stop - m0, :cols.stop - n0].float(),
                        epilogue,
                        None if bias is None else bias[cols],
                        None if residual is None else residual[rows, cols]))
                tile = full.to(a.dtype)
            r, c = min(128, m - m0), min(bn, n - n0)
            out[m0:m0 + r, n0:n0 + c] = tile[:r, :c]
    return out


@pytest.mark.parametrize("bm,bn", k3.TILES, ids=str)
def test_k3_wgmma_tiling_emulation(bm, bn):
    """Ragged m, n and a k that is not a whole number of 64-wide stages,
    for each built tile: the emulated blocking gives the plain product
    exactly (float64 sums of small integers), and with an epilogue the
    plain version's result within fp32 rounding."""
    rng = np.random.default_rng(bn)
    m, k, n = 130, 200, 8 * 37
    assert k3.route(m, k, n, torch.bfloat16) == "wgmma"
    a = torch.from_numpy(rng.integers(-8, 8, (m, k)).astype(np.float64))
    b = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.float64))
    assert torch.equal(_emulate_wgmma_gemm(a, b, bn), a @ b)
    bias = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    res = torch.from_numpy(rng.uniform(-1, 1, (m, n)).astype(np.float32))
    af, bf = (a / 8).float(), (b / 8).float()
    got = _emulate_wgmma_gemm(af, bf, bn, "bias_gelu_res", bias, res)
    want = k3.matmul_plain(af, bf, bias, res, epilogue="bias_gelu_res")
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("m,k,n,dtype,offset,body", [
    (4096, 4096, 4096, torch.bfloat16, 0, "wgmma"),
    (4096, 4096, 14336, torch.bfloat16, 0, "wgmma"),
    (14336, 4096, 4096, torch.float16, 0, "wgmma"),
    (1, 64, 8, torch.bfloat16, 0, "wgmma"),       # any m
    (1000, 333, 1000, torch.bfloat16, 0, "mma"),  # k % 8: row stride
    (37, 100, 53, torch.float16, 0, "mma"),       # n % 8
    (64, 64, 64, torch.bfloat16, 8, "mma"),       # a base off 16 bytes
    (64, 64, 64, torch.float32, 0, "simt"),
    (64, 64, 64, torch.int8, 0, "simt"),
], ids=str)
def test_k3_route_rule(m, k, n, dtype, offset, body):
    """Which body (m, k, n, dtype, alignment) takes, before the launch."""
    assert k3.route(m, k, n, dtype, 1024 + offset, 2048) == body
    if offset:
        assert k3.route(m, k, n, dtype, 1024, 2048 + offset) == body


def test_k3_simt_tiling_emulation():
    """The fp32/int8 body: 128 x 128 tiles, k steps of 8, a thread's 8 x 8
    block at rows ty*8.., columns tx*8.., masked loads and stores."""
    rng = np.random.default_rng(10)
    m, k, n = 131, 19, 140
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int64))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int64))
    out = torch.zeros((m, n), dtype=torch.int64)
    for m0 in range(0, m, 128):
        for n0 in range(0, n, 128):
            acc = torch.zeros((128, 128), dtype=torch.int64)
            for k0 in range(0, k, 8):
                at = torch.zeros((8, 128), dtype=torch.int64)  # transposed
                bt = torch.zeros((8, 128), dtype=torch.int64)
                for idx in range(1024):
                    r, c = idx >> 3, idx & 7
                    if m0 + r < m and k0 + c < k:
                        at[c, r] = a[m0 + r, k0 + c]
                    br, bc = idx >> 7, idx & 127
                    if k0 + br < k and n0 + bc < n:
                        bt[br, bc] = b[k0 + br, n0 + bc]
                for tid in range(256):
                    tx, ty = tid & 15, tid >> 4
                    acc[ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8] += (
                        at[:, ty * 8:ty * 8 + 8].T @ bt[:, tx * 8:tx * 8 + 8])
            rows, cols = min(128, m - m0), min(128, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    assert torch.equal(out, a @ b)
    got = k3.matmul_plain(a.to(torch.int8), b.to(torch.int8))
    assert torch.equal(got.long(), out)


# -- K8: reduce_2d --------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("r,c", [(300, 200), (8, 128), (1000, 257)])
def test_k8_plain_matches_pallas(op, r, c):
    rng = np.random.default_rng(11)
    x = rng.uniform(-5, 5, (r, c)).astype(np.float32)
    want = jax_reduce(jnp.asarray(x), op=op, br=128, bc=128, interpret=True)
    got = k8.reduce_2d(_t(x), op)
    assert got.shape == (1, c) and got.dtype == torch.float32
    _close(got.numpy(), want, rtol=1e-5)


def test_k8_bf16_in_and_out():
    rng = np.random.default_rng(12)
    x = rng.uniform(-5, 5, (300, 130)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_reduce(jx, op="mean", br=128, bc=128, interpret=True),
                      np.float32)
    got = k8.reduce_2d(_t(np.asarray(jx, np.float32)).bfloat16(), "mean")
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, rtol=2.0 ** -7)
    got32 = k8.reduce_2d(_t(np.asarray(jx, np.float32)).bfloat16(), "sum",
                         out_dt=torch.float32)
    assert got32.dtype == torch.float32


def test_k8_max_initial_value_and_nan():
    x = torch.full((5, 3), -float("inf"))
    x[2, 1] = float("nan")
    got = k8.reduce_2d(x, "max")
    assert got[0, 0].item() == pytest.approx(-3.4e38) and math.isnan(got[0, 1].item())


def _widen_pairs(x16):
    """csrc/reduce.cu `Cols<T, 2>::load` (and the vector body's `Lane`):
    each 4-byte word of two adjacent 16-bit values, widened from its bits
    -- bf16 by shifting into the high half of an fp32, fp16 by converting
    each half -- as an (R, C) fp32 matrix."""
    r, c = x16.shape
    h = x16.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    words = (h[:, 0::2] | (h[:, 1::2] << 16)).reshape(r, c // 2)
    if x16.dtype == torch.bfloat16:
        lo = ((words << 16) & 0xFFFFFFFF).to(torch.int64)
        hi = words & 0xFFFF0000
        as_f = [(v - ((v >> 31) << 32)).to(torch.int32).view(torch.float32)
                for v in (lo, hi)]
    else:
        as_f = [((v - ((v >> 15) << 16)).to(torch.int16).view(torch.float16).float())
                for v in (words & 0xFFFF, words >> 16)]
    return torch.stack(as_f, dim=2).reshape(r, c)


def _emulate_k8_split_rows(x, op, splits, pair, chunk=16, warps=8):
    """csrc/reduce.cu's K8 on the CPU, in fp32, for all columns at once:
    S row splits of ceil(R / S) rows; each thread runs its column(s) over
    its split's rows in row order, chunk by chunk (16-bit pairs read as one
    word and widened); then the merge: warp w folds the live splits [w *
    per, (w + 1) * per) in split order from the identity, and the warps'
    results are folded in warp order; mean times float32(1 / R).  Returns
    the (1, C) fp32 result and the number of empty splits."""
    rows, cols = x.shape
    xf = _widen_pairs(x) if pair else x.float()
    rps = -(-rows // splits)
    init = torch.full((cols,), k8.MAX_INIT if op == "max" else 0.0)

    def combine(acc, v):
        if op == "max":
            return torch.where((v != v) | (v > acc), v, acc)  # NaN sticks
        return acc + v

    parts, empty = [], 0
    for s in range(splits):
        n = max(0, min(rps, rows - s * rps))
        if n == 0:
            parts.append(None)  # never written, never read
            empty += 1
            continue
        acc = init.clone()
        for r in range(s * rps, s * rps + n, chunk):
            for v in xf[r:min(r + chunk, s * rps + n)]:
                acc = combine(acc, v)
        parts.append(acc)
    per = -(-splits // warps)
    warp_acc = []
    for w in range(warps):
        acc = init.clone()
        for part in parts[w * per:min(splits, (w + 1) * per)]:
            if part is not None:
                acc = combine(acc, part)
        warp_acc.append(acc)
    r = warp_acc[0]
    for acc in warp_acc[1:]:
        r = combine(r, acc)
    if op == "mean":
        r = r * torch.tensor(k8._mean_scale(rows), dtype=torch.float32)
    return r.reshape(1, cols), empty


@pytest.mark.parametrize("r,c,dtype,shape_for_s", [
    (203, 5, torch.float32, None),          # one split of 203 rows: ragged chunk
    (1000, 333, torch.float32, None),       # S = 63 of 16 rows, the last 8
    (1041, 5, torch.float32, (1041, 16387)),  # S = 65 of 17 rows: 62-64 empty
    (300, 130, torch.bfloat16, None),       # pairs: 512 columns a block
    (77, 9, torch.float16, None),           # C odd: one 16-bit column a thread
    (40, 6, torch.float16, (40, 4096)),     # fp16 pairs, S = 3 of 14 rows
], ids=["one_split", "ragged_1000x333", "empty_splits_1041x16387", "bf16_pairs",
        "fp16_odd_columns", "fp16_pairs"])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_k8_tiling_emulation(r, c, dtype, shape_for_s, op):
    """K8's split-row schedule (splits from the shape, empty splits skipped,
    the merge's fixed order) against the plain version -- fp32 sums within
    1e-5 of the column's sum of |x|, max exact, NaN and -inf columns as the
    plain version -- and against the JAX package's reduce_2d."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(-5, 5, (r, c)).astype(np.float32)).to(dtype)
    x[r // 2, 0] = float("nan")
    x[:, -1] = -float("inf")
    pair = dtype != torch.float32 and c % k8.PAIR == 0
    block_cols = k7.SPLIT_COLS * (k8.PAIR if pair else 1)
    splits = k7.split_count(*(shape_for_s or (r, c)), block_cols)
    got, empty = _emulate_k8_split_rows(x, op, splits, pair)
    assert empty == (3 if shape_for_s == (1041, 16387) else 0)
    want = k8.reduce_2d_plain(x, op, torch.float32)
    assert torch.equal(got.isnan(), want.isnan())
    if op == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        finite = torch.isfinite(want)
        mass = x.float().abs()[:, finite[0]].sum(0).double()
        scale = 1.0 if op == "sum" else 1.0 / r
        err = (got[finite] - want[finite]).abs().double()
        assert bool((err <= 1e-5 * mass * scale).all())
    jx = jnp.asarray(x.float().numpy()).astype(jnp.dtype(str(dtype)[6:]))
    ref = np.asarray(jax_reduce(jx, op=op, out_dt=jnp.float32, br=128, bc=128,
                                interpret=True))
    _close(np.nan_to_num(got.numpy(), neginf=0.0), np.nan_to_num(ref, neginf=0.0),
           rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k8_pairs_widen_exactly(dtype):
    """A word of two 16-bit columns widens to the same fp32 values as
    .float(): bit for bit for infinities, subnormals and -0.0; NaN stays
    NaN (its fp32 payload is the hardware's, not torch's)."""
    v = torch.tensor([1.5, -0.0, float("nan"), float("inf"), -float("inf"),
                      1e-40 if dtype == torch.bfloat16 else 6e-8, -3.25, 65504.0])
    x = v.to(dtype).reshape(2, 4)
    got, want = _widen_pairs(x), x.float()
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got[keep].view(torch.int32), want[keep].view(torch.int32))


def test_k8_split_layout():
    """K8's splits come from K7's rule with the block's columns: 65 x 65
    blocks at 16387^2 fp32 (one column a thread); (4096, 4096) bf16 reads
    pairs, 8 strips of 512 columns x 256 splits of 16 rows; odd C, fp32
    and an odd-element offset read one column a thread."""
    assert k7.split_count(16387, 16387, k7.SPLIT_COLS) == 65
    assert k7.split_count(4096, 4096, k7.SPLIT_COLS * k8.PAIR) == 256
    assert k8.pairs(torch.zeros((4, 4096), dtype=torch.bfloat16))
    assert not k8.pairs(torch.zeros((4, 4097), dtype=torch.bfloat16))
    assert not k8.pairs(torch.zeros((4, 4096), dtype=torch.float32))
    assert not k8.pairs(torch.zeros(4 * 4096 + 1, dtype=torch.float16)[1:]
                        .reshape(4, 4096))


# -- K7: welford_norm_stat --------------------------------------------------------


@pytest.mark.parametrize("r,c", [(64, 128), (1000, 257), (515, 128), (3, 5)])
def test_k7_plain_matches_pallas(r, c):
    rng = np.random.default_rng(4)
    x = rng.uniform(-10, 10, (r, c)).astype(np.float32)
    jm, js = jax_welford(jnp.asarray(x), br=128, bc=128, interpret=True)
    tm, ts = k7.welford_norm_stat(_t(x))
    _close(tm.numpy(), jm, rtol=1e-5)
    _close(ts.numpy(), js, rtol=1e-5)


@pytest.mark.parametrize("shape", [(0, 4), (4, 0)], ids=str)
def test_k7_empty_matrices_answer_as_the_reference(shape):
    """norm_stat of an empty 2-D fp32 tensor (K7's engine): NaN mean and
    invstd of (1, 4) for no rows, (1, 0) outputs for no columns -- the JAX
    package's eager norm_stat and its welford_norm_stat (whose r_main == 0
    path answers in XLA) give the same."""
    import kfunca_tpu as jk
    import kfunca_tpu_torch as tk

    x = np.zeros(shape, np.float32)
    tm, ts = tk.from_numpy(x, "cpu").norm_stat(0)
    jm, js = jk.from_numpy(x, 0).norm_stat(0)
    km, ks = jax_welford(jnp.asarray(x), interpret=True)
    for got in (tm, ts):
        assert got.sizes() == jm.sizes() == [1, shape[1]]
        np.testing.assert_array_equal(got.numpy(), jm.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(km))
    np.testing.assert_array_equal(ts.numpy(), js.numpy())
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ks))
    assert np.isnan(tm.numpy()).all() and np.isnan(ts.numpy()).all()


def _chan_fold(state, nb, delta, m2b):
    """csrc/reduce.cu `chan_fold`: nb more values whose mean lies `delta`
    above the partial's, integer counts made float only here (the kernel
    fuses the mean's multiply-add; here it rounds twice)."""
    n, mean, m2 = state
    tot = n + nb
    f = torch.tensor(nb, dtype=torch.float32) / torch.tensor(tot, dtype=torch.float32)
    return tot, mean + delta * f, m2 + m2b + delta * delta * (torch.tensor(
        n, dtype=torch.float32) * f)


def _chan_merge(a, b):
    return a if b[0] == 0 else _chan_fold(a, b[0], b[1] - a[1], b[2])


def _emulate_split_rows(x, splits, chunk=16, warps=8):
    """csrc/reduce.cu's K7 on the CPU, in fp32, for all columns of x at once:
    S row splits of ceil(R / S) rows; in each, chunks of `chunk` rows (the
    last may be shorter) taken relative to the running mean, the chunk's
    mean of d and its M2 formed in registers, folded in by Chan's formula;
    then the merge kernel's order: warp w merges splits [w * per, (w + 1)
    * per) in split order, and the warps' results are merged in warp
    order.  Returns (n, mean, m2) with mean and m2 of shape (C,)."""
    rows, cols = x.shape
    rps = -(-rows // splits)
    zero = torch.zeros(cols, dtype=torch.float32)
    parts = []
    for s in range(splits):
        r0, r1 = s * rps, min(rows, (s + 1) * rps)
        state = (0, zero, zero)
        for r in range(r0, r1, chunk):
            u = min(chunk, r1 - r)
            d = x[r:r + u] - state[1]
            total = zero
            for v in d:
                total = total + v
            md = total * (1.0 / chunk) if u == chunk else total / u
            m2c = zero
            for v in d:
                m2c = m2c + (v - md) * (v - md)
            state = _chan_fold(state, u, md, m2c)
        parts.append(state)
    per = -(-splits // warps)
    merged = []
    for w in range(warps):
        state = (0, zero, zero)
        for part in parts[w * per:min(splits, (w + 1) * per)]:
            state = _chan_merge(state, part)
        merged.append(state)
    state = merged[0]
    for part in merged[1:]:
        state = _chan_merge(state, part)
    return state


@pytest.mark.parametrize("r,c,splits", [
    (1003, 3, None),  # the shape's own S = 63: 62 splits of 16 rows, one of 11
    (5, 2, 8),        # R < S: three splits hold no row
    (100, 4, 3),      # 34 rows a split: R not a multiple of the chunk
    (40, 3, 4),       # 10 rows a split: every split shorter than a chunk
    (77, 1, None),    # C = 1
    # the S the kernel takes for wider matrices of these rows (a column's
    # schedule depends on R and S only):
    (1041, 3, (1041, 16387)),  # S = 65 of 17 rows: 62-64 empty, 61 four rows
    (17, 3, (17, 4096)),       # S = 2 of 9 rows, each shorter than a chunk
], ids=["1003x3", "r_below_s", "ragged_chunks", "short_splits", "one_column",
        "empty_splits_1041x16387", "short_splits_17x4096"])
def test_k7_tiling_emulation(r, c, splits):
    """The split-row schedule of csrc/reduce.cu gives the two-pass
    statistics, with a large common offset that raw sums of squares would
    cancel away.  `splits`: forced, from the given shape, or (None) from
    the matrix's own."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy((rng.standard_normal((r, c)) + 1e4).astype(np.float32))
    if splits is None:
        splits = k7.split_count(r, c)
    elif isinstance(splits, tuple):
        splits = k7.split_count(*splits)
    n, mean, m2 = _emulate_split_rows(x, splits)
    ref = x.double()
    var = ref.var(0, correction=0)
    assert n == r
    assert (mean.double() - ref.mean(0)).abs().max() < 2e-6 * 1e4  # fp32 steps of the mean
    assert ((m2.double() / n - var).abs() < 1e-2 * var).all()
    if r == 1003:
        # the raw sums of squares the kernel avoids lose the variance here
        raw = (x * x).sum(0) / n - (x.sum(0) / n) ** 2
        assert ((raw.double() - var).abs() > 0.5 * var).all()


def test_k7_split_count_fills_the_card():
    """S from the shape alone: at 16387^2, 65 column strips x 65 splits of
    253 rows, four waves of 8 blocks on 132 SMs; never more splits than
    chunks of rows, never fewer than one."""
    assert k7.split_count(16387, 16387) == 65
    assert -(-16387 // 256) * k7.split_count(16387, 16387) >= k7.TARGET_BLOCKS
    assert k7.split_count(1000, 333) == 63 and k7.split_count(5, 1) == 1
    assert k7.split_count(1, 4096) == 1 and k7.split_count(10 ** 6, 1) == 4224
    assert k7.split_count(1041, 16387) == 65 and k7.split_count(17, 4096) == 2


@pytest.mark.parametrize("module,name,source,constant", [
    (k7, "CHUNK", "reduce.cu", "kChunk"),
    (k7, "SPLIT_COLS", "reduce.cu", "kSplitThreads"),
    (k8, "PAIR", "reduce.cu", "kPair"),
    (k9, "VEC_BYTES", "elementwise.cu", "kVecBytes"),
    (k9, "VEC_UNROLL", "elementwise.cu", "kVecUnroll"),
    (k10, "WORDS_PER_THREAD", "bitonic_sort.cu", "kE"),
    (k10, "MAX_N", "bitonic_sort.cu", "kMaxN"),
    (k11, "CHANNELS_PER_BLOCK", "ssm_scan.cu", "kCh"),
    (k11, "STATE_GROUP", "ssm_scan.cu", "kMaxN"),
    (k11, "STAGE_STEPS", "ssm_scan.cu", "kT"),
    (k11, "LANES_PER_CHANNEL", "ssm_scan.cu", "kG"),
])
def test_wrapper_constants_match_the_kernel_source(module, name, source, constant):
    """The wrappers' copies of the kernels' tile constants, which
    `split_count`, the emulations and chip_smoke.py's pass counts read,
    equal the constexpr values csrc/ compiles."""
    text = (Path(k7.__file__).resolve().parents[2] / "csrc" / source).read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", text)
    assert found == [str(getattr(module, name))]


# -- K9: elementwise ---------------------------------------------------------------


@pytest.mark.parametrize("name", k9.OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_k9_plain_matches_pallas(name, dtype):
    rng = np.random.default_rng(5)
    if dtype == "int32":
        a = rng.integers(-100, 100, (8, 128)).astype(np.int32)
        b = rng.integers(-5, 6, (8, 128)).astype(np.int32)  # zeros, -1
        a[0, :3] = np.iinfo(np.int32).min
        b[0, :3] = [-1, 0, 1]
        acc_j, acc_t = jnp.int64, torch.int64
    else:
        a = rng.uniform(0.5, 2, (8, 128)).astype(np.float32)
        b = rng.uniform(0.5, 2, (8, 128)).astype(np.float32)
        acc_j, acc_t = jnp.float32, torch.float32
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if dtype == "bfloat16":
        ja, jb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
    ops = (ja, jb) if name in ("add", "sub", "mul", "div") else (ja,)
    if name == "exp" and dtype == "int32":
        ops = (jnp.asarray(np.clip(a, -20, 20)),)
    want = jax_ew(name, *ops, acc_dt=acc_j, out_dt=ops[0].dtype, interpret=True)
    tops = [_t(np.asarray(o, np.float32)).bfloat16() if dtype == "bfloat16"
            else _t(np.asarray(o)) for o in ops]
    got = k9.elementwise(name, *tops, acc_dt=acc_t, out_dt=tops[0].dtype)
    want = np.asarray(want, np.float32) if dtype == "bfloat16" else np.asarray(want)
    got = got.float().numpy() if dtype == "bfloat16" else got.numpy()
    if name == "exp" and dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_k9_any_numel_and_out():
    """The card's kernel takes any numel (the TPU's 128-lane rule is
    dropped), and writes a given `out`, which may be an operand."""
    a = torch.arange(7, dtype=torch.float32)
    got = k9.elementwise("mul", a, a, acc_dt=torch.float32, out_dt=torch.float32,
                         out=a)
    assert got is a and a.tolist() == [float(i * i) for i in range(7)]
    with pytest.raises(ValueError, match="share one shape"):
        k9.elementwise("add", a, a[:3], acc_dt=torch.float32, out_dt=torch.float32)
    with pytest.raises(ValueError, match="unknown elementwise op"):
        k9.elementwise("log", a, acc_dt=torch.float32, out_dt=torch.float32)


def _emulate_k9_vector(name, a, b, threads=256):
    """csrc/elementwise.cu's vector body on the CPU: block x thread x
    access -> vector index (each vector exactly once), each vector's four
    32-bit words widened lane by lane from their bits (`Lane::get`), the
    math in fp32, each result rounded once into the dtype (`Lane::put`),
    and block 0's scalar tail past the last whole vector."""
    n, dt = a.numel(), a.dtype
    per = k9.VEC_BYTES // a.element_size()
    nvec = n // per
    per_block = threads * k9.VEC_UNROLL
    blocks = max(1, -(-nvec // per_block))
    idx = (torch.arange(blocks)[:, None, None] * per_block
           + torch.arange(k9.VEC_UNROLL)[None, :, None] * threads
           + torch.arange(threads)[None, None, :]).flatten()
    idx = idx[idx < nvec]
    assert torch.equal(idx.sort().values, torch.arange(nvec))  # once each
    tail = nvec * per + torch.arange(threads)
    tail = tail[tail < n]
    assert len(tail) == n % per

    def widen(v):
        if dt == torch.float32:
            return v.clone()
        return _widen_pairs(v.reshape(1, -1)).reshape(-1)

    func = k9.FUNCS[name]
    out = torch.empty(n, dtype=dt)
    body = slice(0, nvec * per)
    args = [widen(v.reshape(-1)[body]) for v in ((a, b) if b is not None else (a,))]
    out[body] = func(*args).to(dt)
    if len(tail):
        targs = [v.reshape(-1)[tail].float() for v in ((a, b) if b is not None else (a,))]
        out[tail] = func(*targs).to(dt)
    return out.reshape(a.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", [op for op in k9.OPS if op != "copy"])
def test_k9_vector_body_emulation(name, dtype):
    """The vector body's schedule and lanes give bitwise the plain version,
    at a numel that spans several blocks and leaves a scalar tail."""
    rng = np.random.default_rng(15)
    n = 9001  # fp32: 2250 vectors (3 blocks) and a tail of 1; 16-bit: 1125 and 1
    a = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)).to(dtype)
    b = b if name in ("add", "sub", "mul", "div") else None
    args = (a, b) if b is not None else (a,)
    want = k9.elementwise_plain(name, *args, acc_dt=torch.float32, out_dt=dtype)
    got = _emulate_k9_vector(name, a, b)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("name,dtypes,out_dt,acc,offsets,body", [
    ("add", ("float32", "float32"), "float32", "float32", (0, 0, 0), "vector"),
    ("exp", ("bfloat16",), "bfloat16", "float32", (0, 0, 0), "vector"),
    ("div", ("float16", "float16"), "float16", "float32", (0, 0, 0), "vector"),
    ("add", ("float32", "float32"), "float32", "float32", (4, 0, 0), "generic"),
    ("mul", ("bfloat16", "bfloat16"), "bfloat16", "float32", (0, 0, 2), "generic"),
    ("add", ("bfloat16", "float32"), "float32", "float32", (0, 0, 0), "generic"),
    ("add", ("float32", "float32"), "float32", "float64", (0, 0, 0), "generic"),
    ("add", ("int32", "int32"), "int32", "int64", (0, 0, 0), "generic"),
    ("copy", ("bfloat16",), "bfloat16", "bfloat16", (2, 0, 6), "copy"),
    ("copy", ("int64",), "int64", "int64", (0, 0, 0), "copy"),
    ("copy", ("bool",), "bool", "bool", (1, 0, 0), "copy"),
    ("copy", ("float32",), "bfloat16", "bfloat16", (0, 0, 0), "generic"),
    ("copy", ("int32",), "int8", "int8", (0, 0, 0), "generic"),
])
def test_k9_route_rule(name, dtypes, out_dt, acc, offsets, body):
    """The body comes from the dtypes and the byte offsets of a, b and out
    alone: the vector body needs one float dtype throughout, float math and
    16-byte alignment; any copy that keeps its dtype is the byte copy."""
    dt = [getattr(torch, d) for d in dtypes]
    ops = [torch.zeros(4, dtype=d) for d in dt]
    kind = k9._acc_kind(name, ops, getattr(torch, acc), getattr(torch, out_dt))
    ptrs = [4096 + o for o in offsets]
    assert k9.route(name, tuple(dt), getattr(torch, out_dt), kind, ptrs) == body


def _emulate_copy_bytes(src, dst, nbytes, threads=256):
    """csrc/elementwise.cu `kf_copy_bytes`'s pieces for a copy from address
    src to dst: the widest width the two share mod 16, the head bytes up to
    src's next boundary of it, whole vectors, then tail bytes; returns
    (width, [(offset, length), ...]) covering [0, nbytes) once."""
    skew = (src ^ dst) % k9.VEC_BYTES
    width = next(w for w in (16, 8, 4, 2, 1) if skew % w == 0)
    head = min((width - src % width) % width, nbytes)
    nvec = (nbytes - head) // width
    assert head < threads and (nbytes - head - nvec * width) < threads
    pieces = [(i, 1) for i in range(head)]
    pieces += [(head + i * width, width) for i in range(nvec)]
    pieces += [(i, 1) for i in range(head + nvec * width, nbytes)]
    assert all((src + o) % width == 0 and (dst + o) % width == 0
               for o, w in pieces if w == width and w > 1)
    return width, pieces


@pytest.mark.parametrize("dtype,src_off,dst_off,width", [
    (torch.float32, 0, 0, 16), (torch.float32, 4, 12, 8), (torch.float32, 4, 0, 4),
    (torch.bfloat16, 2, 0, 2), (torch.float64, 8, 8, 16), (torch.int8, 1, 0, 1),
    (torch.bool, 3, 7, 4), (torch.int64, 0, 8, 8),
], ids=lambda v: str(v).replace("torch.", ""))
def test_k9_byte_copy_emulation(dtype, src_off, dst_off, width):
    """The byte copy's pieces cover every byte once, aligned at both ends,
    and the copy is bitwise the plain version's, NaN payloads included."""
    rng = np.random.default_rng(16)
    n = 1003
    raw = torch.from_numpy(rng.integers(0, 256, n * torch.empty((), dtype=dtype)
                                        .element_size(), dtype=np.uint8))
    a = raw.view(dtype) if dtype != torch.bool else raw % 2 == 1
    if dtype.is_floating_point:  # quiet and signalling NaNs with payloads
        bits = {4: [0x7FC00001, 0xFF800123, 0x7F8000FF], 2: [0x7FC1, 0xFF81, 0x7F81],
                8: [0x7FF8000000000001, 0x7FF0000000000ABC]}[a.element_size()]
        ints = {4: torch.int32, 2: torch.int16, 8: torch.int64}[a.element_size()]
        a.view(ints)[:len(bits)] = torch.tensor(
            [b - (1 << (8 * a.element_size())) if b >= 1 << (8 * a.element_size() - 1)
             else b for b in bits], dtype=ints)
    nbytes = a.numel() * a.element_size()
    w, pieces = _emulate_copy_bytes(4096 + src_off, 8192 + dst_off, nbytes)
    assert w == width
    src = a.view(torch.uint8) if dtype != torch.bool else a.to(torch.uint8)
    out = torch.zeros(nbytes, dtype=torch.uint8)
    cover = torch.zeros(nbytes, dtype=torch.int64)
    for o, length in pieces:
        out[o:o + length] = src[o:o + length]
        cover[o:o + length] += 1
    assert bool((cover == 1).all())
    want = k9.elementwise_plain("copy", a, acc_dt=dtype, out_dt=dtype)
    want = want.view(torch.uint8) if dtype != torch.bool else want.to(torch.uint8)
    assert torch.equal(out, want)


def _int_div_scalar(x: int, y: int) -> int:
    """csrc/elementwise.cu's int64 division, one element at a time."""
    if y == 0:
        return -1
    if y == -1:
        return -x if x != -2 ** 63 else x
    q = abs(x) // abs(y)
    return q if (x >= 0) == (y >= 0) else -q


def test_k9_integer_division_emulation():
    xs = [7, -7, 5, -2 ** 63, 3, -3, 0, 2 ** 63 - 1, 9, -9, 1]
    ys = [2, 2, 0, -1, -1, 0, 0, -1, 4, -4, 3]
    got = k9.elementwise_plain("div", torch.tensor(xs), torch.tensor(ys),
                               acc_dt=torch.int64, out_dt=torch.int64)
    assert got.tolist() == [_int_div_scalar(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("dt,want", [(torch.int8, [1, -2, 127, -128, 0]),
                                      (torch.uint8, [1, 0, 255, 0, 0]),
                                      (torch.int32, [1, -2, 300, -2 ** 31, 0])])
def test_k9_float_to_int_saturates(dt, want):
    x = torch.tensor([1.5, -2.5, 300.7, -1e10, float("nan")])
    assert k9.elementwise_plain("copy", x, acc_dt=dt, out_dt=dt).tolist() == want


def test_mlp_step_calls_each_kernel_as_the_tape_implies(monkeypatch):
    """One eager MLP step with the three knobs at `pallas` calls K3 six
    times (2 forward, 4 backward), K8 once (the mean) and K9 nine times
    (the forward add, the tape's 7 gradient clones, x's second gradient
    added into x.grad), and K7 never: the counts chip_smoke.py asserts on
    the card.  On the CPU the wrappers run their plain versions, so the
    calls are counted here instead of the launches."""
    import kfunca_tpu_torch as kfunca
    from kfunca_tpu_torch.core import dispatch
    from kfunca_tpu_torch.ops import gemm, reduce

    calls = {"k3": 0, "k8": 0, "k9": 0, "k7": 0}

    def counted(key, fn):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(gemm, "k3_matmul", counted("k3", gemm.k3_matmul))
    monkeypatch.setattr(reduce, "reduce_2d", counted("k8", reduce.reduce_2d))
    monkeypatch.setattr(reduce, "welford_norm_stat",
                        counted("k7", reduce.welford_norm_stat))
    monkeypatch.setattr(dispatch.k9, "elementwise",
                        counted("k9", dispatch.k9.elementwise))
    for knob in ("KFUNCA_GEMM_ENGINE", "KFUNCA_REDUCE_ENGINE",
                 "KFUNCA_ELEMENTWISE_ENGINE"):
        monkeypatch.setenv(knob, "pallas")
    rng = np.random.default_rng(7)
    t, d, ff = 256, 256, 384  # t * d = 65,536: the mean takes K8
    x, w1, w2 = (kfunca.from_numpy(rng.standard_normal(s).astype(np.float32),
                                   "cpu").set_requires_grad(True)
                 for s in ((t, d), (d, ff), (ff, d)))
    z = kfunca.gemm(kfunca.gemm(x, w1).relu(), w2) + x
    m = z.mean(0)
    m.backward(kfunca.from_numpy(np.ones((1, d), np.float32), "cpu"))
    assert calls == {"k3": 6, "k8": 1, "k9": 9, "k7": 0}
    for knob in ("KFUNCA_GEMM_ENGINE", "KFUNCA_REDUCE_ENGINE",
                 "KFUNCA_ELEMENTWISE_ENGINE"):
        monkeypatch.delenv(knob)
    calls.update(k3=0, k8=0, k9=0)
    z = kfunca.gemm(kfunca.gemm(x, w1).relu(), w2) + x
    z.mean(0).backward(kfunca.from_numpy(np.ones((1, d), np.float32), "cpu"))
    assert calls == {"k3": 0, "k8": 0, "k9": 0, "k7": 0}
    x.norm_stat(0)  # norm_stat's default engine is K7
    assert calls["k7"] == 1
