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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.ops.pallas_kernels.elementwise import elementwise as jax_ew
from kfunca_tpu.ops.pallas_kernels.matmul import matmul as jax_matmul
from kfunca_tpu.ops.pallas_kernels.reduce import reduce_2d as jax_reduce
from kfunca_tpu.ops.pallas_kernels.welford import welford_norm_stat as jax_welford
from kfunca_tpu_torch.ops.pallas_kernels import elementwise as k9
from kfunca_tpu_torch.ops.pallas_kernels import matmul as k3
from kfunca_tpu_torch.ops.pallas_kernels import reduce as k8
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


# the CUDA kernel's tensor-core body: 128 x 128 output tiles, k steps of 32,
# 8 warps as 2 x 4, a warp 64 x 32 = 4 x 4 mma tiles of m16n8k16
BM, BN, BK = 128, 128, 32


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
    """The tensor-core body's loops: tiles zero-filled past the edges (the
    load8 masking), per-warp 64 x 32 sub-tiles of 4 x 4 mma tiles over k
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
                        for mi in range(4):
                            for ni in range(4):
                                r0 = wm * 64 + mi * 16
                                c0 = wn * 32 + ni * 8
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


def _emulate_column_strip(x, init, combine, unroll=8, warps=8):
    """csrc/reduce.cu's blocking for one column: warp w keeps its own
    accumulator over rows w, w + 8, ...; whole groups of `unroll` rows are
    loaded before they are combined in row order; the 8 partials are then
    merged in warp order."""
    rows = x.shape[0]
    parts = []
    for w in range(warps):
        acc, r = init, w
        while r + (unroll - 1) * warps < rows:
            for u in range(unroll):
                acc = combine(acc, x[r + u * warps])
            r += unroll * warps
        while r < rows:
            acc = combine(acc, x[r])
            r += warps
        parts.append(acc)
    return parts


def test_k8_tiling_emulation():
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(-5, 5, (203, 5)).astype(np.float32))
    for c in range(5):
        parts = _emulate_column_strip(x[:, c], torch.tensor(0.0), lambda a, v: a + v)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        assert abs(total.item() - x[:, c].double().sum().item()) < 1e-4
        mx = _emulate_column_strip(x[:, c], torch.tensor(-3.4e38),
                                   lambda a, v: v if (v != v or v > a) else a)
        assert max(mx).item() == x[:, c].max().item()


# -- K7: welford_norm_stat --------------------------------------------------------


@pytest.mark.parametrize("r,c", [(64, 128), (1000, 257), (515, 128), (3, 5)])
def test_k7_plain_matches_pallas(r, c):
    rng = np.random.default_rng(4)
    x = rng.uniform(-10, 10, (r, c)).astype(np.float32)
    jm, js = jax_welford(jnp.asarray(x), br=128, bc=128, interpret=True)
    tm, ts = k7.welford_norm_stat(_t(x))
    _close(tm.numpy(), jm, rtol=1e-5)
    _close(ts.numpy(), js, rtol=1e-5)


def _welford_step(state, v):
    n, mean, m2 = state
    n = n + 1.0
    d = v - mean
    mean = mean + d / n
    return n, mean, m2 + d * (v - mean)


def _chan_merge(a, b):
    n, mean, m2 = a
    nb, meanb, m2b = b
    if nb == 0:
        return a
    if n == 0:
        return b
    tot = n + nb
    delta = meanb - mean
    return tot, mean + delta * (nb / tot), m2 + m2b + delta * delta * (n * nb / tot)


def test_k7_tiling_emulation():
    """Per-thread Welford updates over rows w, w + 8, ... and Chan's merge
    in warp order (csrc/reduce.cu) give the two-pass statistics, with a
    large common offset that raw sums of squares would cancel away."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy((rng.standard_normal((1003, 3)) + 1e4).astype(np.float32))
    for c in range(3):
        zero = (torch.tensor(0.0), torch.tensor(0.0), torch.tensor(0.0))
        parts = _emulate_column_strip(x[:, c], zero, _welford_step)
        state = parts[0]
        for p in parts[1:]:
            state = _chan_merge(state, p)
        n, mean, m2 = (float(v) for v in state)
        ref = x[:, c].double()
        var = ref.var(correction=0).item()
        assert n == 1003
        assert abs(mean - ref.mean().item()) < 2e-6 * 1e4  # fp32 steps of the mean
        assert abs(m2 / n - var) < 1e-2 * var
        # the raw sums of squares the kernel avoids lose the variance here
        xc = x[:, c]
        raw = ((xc * xc).sum() / n - (xc.sum() / n) ** 2).item()
        assert abs(raw - var) > 0.5 * var


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
