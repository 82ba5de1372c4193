"""Port parity: flash attention forward (K1) and backward (K2).

The same numpy inputs go through the JAX package's Pallas kernels, run in
interpret mode on the CPU as the JAX package's own tests run them, and
through the port's plain PyTorch versions, which the port's wrappers run
for CPU tensors and which the CUDA kernels are held against on the card
(tests/test_torch_cuda.py, chip_smoke.py).  fp32 throughout, atol and rtol
1e-4 as in tests/test_pallas_kernels.py: the two sum the same fp32 terms
in another order.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kfunca_tpu.ops import attention as jattn
from kfunca_tpu.ops.pallas_kernels import flash_attention as jfa
from kfunca_tpu_torch.ops import attention as tattn
from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as tfa

# (b, h, hkv, sq, skv, d, window): the shapes of tests/test_pallas_kernels.py
# (MHA, ragged everything, tiles that do not divide, GQA 4:2 and 6:3,
# windows 64 and 130), and head dims above 128, which the CUDA kernels pad
# to 256 (Gemma's MQA 8:1 at 256, 200 padded, a window at 256)
CASES = {
    "mha": (1, 2, 2, 128, 128, 128, None),
    "ragged": (1, 1, 1, 35, 67, 40, None),
    "ragged_tiles": (1, 2, 2, 100, 160, 64, None),
    "gqa_4_2": (1, 4, 2, 256, 256, 64, None),
    "gqa_6_3_window_64": (1, 6, 3, 256, 256, 64, 64),
    "gqa_window_130": (1, 4, 2, 384, 384, 64, 130),
    "hd256_mqa_8_1": (1, 8, 1, 128, 128, 256, None),
    "hd200_padded": (1, 2, 2, 100, 160, 200, None),
    "hd256_window_37": (1, 4, 2, 200, 200, 256, 37),
}
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(case, seed=0):
    b, h, hkv, sq, skv, d, _ = case
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    return u(b, h, sq, d), u(b, hkv, skv, d), u(b, hkv, skv, d), u(b, h, sq, d)


def _jax_kernels(q, k, v, g, window):
    """(out, lse, dq, dk, dv) from the Pallas kernels in interpret mode."""
    q, k, v, g = map(jnp.asarray, (q, k, v, g))
    out, lse = jfa.flash_attention_fwd_stats(q, k, v, bq=128, bk=128,
                                             window=window, interpret=True)
    grads = jfa.flash_attention_backward(q, k, v, g, out=out, lse=lse, bq=128,
                                         bk=128, window=window, interpret=True)
    return tuple(np.asarray(x) for x in (out, lse, *grads))


@functools.lru_cache(maxsize=None)
def _both(name):
    """One case through both packages: (JAX results, port results)."""
    case = CASES[name]
    q, k, v, g = _inputs(case)
    want = _jax_kernels(q, k, v, g, case[-1])
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tfa.flash_attention_fwd_stats(tq, tk, tv, window=case[-1])
    grads = tfa.flash_attention_backward(tq, tk, tv, tg, out, lse,
                                         window=case[-1])
    return want, tuple(x.numpy() for x in (out, lse, *grads))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_the_jax_kernel(name):
    want, got = _both(name)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_the_jax_kernel(name):
    want, got = _both(name)
    for w, g in zip(want[2:], got[2:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_unread_kv_rows_get_exact_zero_gradients():
    """Skv 160 over Sq 100: kv rows 100.. are read by no q row."""
    _, got = _both("ragged_tiles")
    dk, dv = got[3], got[4]
    assert not dk[:, :, 100:].any() and not dv[:, :, 100:].any()
    assert np.abs(dk[:, :, :100]).min() > 0


def test_rows_without_a_valid_column():
    """Window 64, Sq 300 over Skv 64: rows 127.. attend no column.  The
    port gives them out = 0, lse = 0 and exact-zero gradients.  The Pallas
    kernel leaves such rows to its block layout (the column sum of V over a
    padded tile, or an unwritten block), so it is the reference on the rows
    that do attend a column: its out, lse and dq there, and its dk/dv when
    it is given those rows alone."""
    case = (1, 2, 1, 300, 64, 64, 64)
    q, k, v, g = _inputs(case, seed=1)
    live = 64 + 64 - 1
    want = _jax_kernels(q[:, :, :live], k, v, g[:, :, :live], 64)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tfa.flash_attention_fwd_stats(tq, tk, tv, window=64)
    dq, dk, dv = tfa.flash_attention_backward(tq, tk, tv, tg, out, lse,
                                              window=64)
    for got, w in zip((out, lse, dq), want[:3]):
        np.testing.assert_allclose(got[:, :, :live].numpy(), w, **TOL)
        assert not got[:, :, live:].any()
    np.testing.assert_allclose(dk.numpy(), want[3], **TOL)
    np.testing.assert_allclose(dv.numpy(), want[4], **TOL)
    # the whole-tensor JAX kernel agrees on the live rows too
    full = _jax_kernels(q, k, v, g, 64)
    np.testing.assert_allclose(out[:, :, :live].numpy(), full[0][:, :, :live],
                               **TOL)


def _vjp_pair(jfn, tfn, case, seed=2):
    q, k, v, g = _inputs(case, seed)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = (jout, *vjp(jnp.asarray(g)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tout = tfn(*leaves)
    got = (tout, *torch.autograd.grad(tout, leaves, torch.from_numpy(g)))
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), **TOL)


def test_causal_attention_fn_gradients_match_jax():
    _vjp_pair(jattn.causal_attention_fn, tattn.causal_attention_fn,
              (1, 2, 2, 96, 96, 32, None))


@pytest.mark.parametrize("window", [None, 32, 130])
def test_make_flash_attention_gradients_match_jax(window):
    _vjp_pair(jattn.make_flash_attention(window),
              tattn.make_flash_attention(window),
              (2, 4, 2, 160, 160, 64, window))


def test_make_flash_attention_is_cached_per_window():
    assert tattn.make_flash_attention(32) is tattn.make_flash_attention(32)
    assert tattn.make_flash_attention(32) is not tattn.make_flash_attention(64)


def test_causal_attention_fn_refuses_grouped_heads():
    q, k, v, _ = map(torch.from_numpy, _inputs((1, 4, 2, 8, 8, 16, None)))
    with pytest.raises(ValueError, match="make_flash_attention"):
        tattn.causal_attention_fn(q, k, v)


def test_oracles_match_jax():
    case = (1, 4, 2, 40, 56, 32, 9)
    q, k, v, _ = _inputs(case, seed=3)
    want = jattn._sdpa_xla_gqa(*map(jnp.asarray, (q, k, v)), 9)
    got = tattn._sdpa_xla_gqa(*map(torch.from_numpy, (q, k, v)), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    q, k, v, _ = _inputs((1, 2, 2, 40, 40, 32, None), seed=4)
    want = jattn._sdpa_xla(*map(jnp.asarray, (q, k, v)))
    got = tattn._sdpa_xla(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_fp16_rides_the_fp32_path_and_bf16_rounds_once():
    q, k, v, _ = _inputs((1, 2, 2, 48, 48, 32, None), seed=5)
    ref = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))[0]
    half = tattn.causal_attention_fn(
        *(torch.from_numpy(x).half() for x in (q, k, v)))
    assert half.dtype == torch.float16
    # fp16 inputs carry 2^-11 relative error each; values are of order 1
    np.testing.assert_allclose(half.float().numpy(), ref.numpy(), atol=3e-3)
    b16 = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    out, lse = tfa.flash_attention_fwd_stats(*b16)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    exact = tfa.flash_attention_plain(*(t.float() for t in b16))[0]
    assert torch.equal(out, exact.bfloat16())


def test_plain_attention_context_routes_to_the_plain_version(monkeypatch):
    q, k, v, _ = map(torch.from_numpy, _inputs((1, 2, 1, 16, 16, 8, None)))
    calls = []
    monkeypatch.setattr(tattn, "flash_attention_fwd_stats",
                        lambda *a, **kw: calls.append(1))
    with tattn.plain_attention():
        out = tattn.make_flash_attention(5)(q, k, v)
    assert calls == [] and not tattn._plain
    torch.testing.assert_close(out, tfa.flash_attention_plain(q, k, v, 5)[0])


def test_wrappers_check_their_arguments():
    q, k, v, g = map(torch.from_numpy, _inputs((1, 4, 2, 8, 8, 16, None)))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention_fwd_stats(q, k, v, window=0)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tfa.flash_attention_fwd_stats(q[:, :3], k, v)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_fwd_stats(q, k.double(), v)
    with pytest.raises(ValueError, match="q's shape"):
        tfa.flash_attention_backward(q, k, v, g[:, :, :4], q, None)
    out, lse = tfa.flash_attention_fwd_stats(q, k, v, save_stats=False)
    assert lse is None
    assert torch.equal(out, tfa.flash_attention_forward(q, k, v))
    # on the CPU nothing is launched
    assert tfa.flash_attention_fwd_stats.launches == 0
    assert tfa.flash_attention_backward.launches == 0


# -- K2's bf16 body on the card (csrc/flash_attention.cu, wgmma): its tiling -
#
# dq kernel: a block owns 128 q rows (two consumers of 64) and streams the
# live 64-row k / v tiles; dk/dv kernel: a block owns 64 kv rows and streams
# the live 64-row q / dO tiles over the GQA group's heads (one consumer
# computes P^T and dV, the other dS^T, from that P^T, and dK).  P and dS are
# rounded to bf16 before the second products (the TPU kernel's _mxu_in);
# each block sums its tiles in order, so no two blocks write one element.

DQ_ROWS, DKV_ROWS = 128, 64  # resident rows of a block
KV_STREAM, Q_STREAM = 64, 64  # rows of a streamed tile: dq, dk/dv


def _attends(row, col, sq, skv, window):
    ok = (col <= row) & (col < skv) & (row < sq)
    if window is not None:
        ok = ok & (col > row - window)
    return ok


def _dq_kv_tiles(row0, sq, skv, window, kv_stream=KV_STREAM):
    """The kv tiles (of kv_stream rows) the dq block at q row row0
    streams."""
    col_hi = min(row0 + DQ_ROWS - 1, sq - 1, skv - 1)
    col_lo = max(row0 - window + 1, 0) if window is not None else 0
    if col_lo > col_hi:
        return range(0)
    return range(col_lo // kv_stream, col_hi // kv_stream + 1)


def _dkv_q_tiles(col0, sq, skv, window, q_stream=Q_STREAM):
    """The q tiles (of q_stream rows) the dk/dv block at kv row col0
    streams."""
    first = col0 // q_stream
    last = (sq - 1) // q_stream
    if window is not None:
        col_last = min(col0 + DKV_ROWS - 1, skv - 1)
        last = min(last, (col_last + window - 1) // q_stream)
    return range(first, last + 1)


def _bf16(x):
    return x.bfloat16().float()


def _k2_emulation(q, k, v, g, out, lse, window, kv_stream=KV_STREAM,
                  q_stream=Q_STREAM):
    """The bf16 body's blocking in plain torch: (dq, dk, dv) in bf16, the
    dq kernel streaming kv_stream kv rows and dk/dv q_stream q rows."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group, scale = h // hkv, 1.0 / np.sqrt(d)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    delta = (gf * out.float()).sum(-1)  # from the SAVED bf16 out
    log2e = 1.4426950408889634

    def p_ds(bi, hi, rows, cols):
        kvh = hi // group
        s = qf[bi, hi, rows] @ kf[bi, kvh, cols].T
        dp = gf[bi, hi, rows] @ vf[bi, kvh, cols].T
        ok = _attends(rows[:, None], cols[None, :], sq, skv, window)
        p = torch.where(ok, torch.exp2(s * (scale * log2e)
                                       - lse[bi, hi, rows, None] * log2e), 0.0)
        ds = p * (dp - delta[bi, hi, rows, None])
        return _bf16(p), _bf16(ds)

    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for bi in range(b):
        for hi in range(h):
            for row0 in range(0, sq, DQ_ROWS):
                rows = torch.arange(row0, min(row0 + DQ_ROWS, sq))
                acc = torch.zeros((len(rows), d))
                for kt in _dq_kv_tiles(row0, sq, skv, window, kv_stream):
                    cols = torch.arange(kt * kv_stream,
                                        min(kt * kv_stream + kv_stream, skv))
                    _, ds = p_ds(bi, hi, rows, cols)
                    acc += ds @ kf[bi, hi // group, cols]
                dq[bi, hi, rows] = acc * scale
        for kvh in range(hkv):
            for col0 in range(0, skv, DKV_ROWS):
                cols = torch.arange(col0, min(col0 + DKV_ROWS, skv))
                dk_acc = torch.zeros((len(cols), d))
                dv_acc = torch.zeros((len(cols), d))
                for hi in range(kvh * group, (kvh + 1) * group):
                    for qt in _dkv_q_tiles(col0, sq, skv, window, q_stream):
                        rows = torch.arange(qt * q_stream,
                                            min(qt * q_stream + q_stream, sq))
                        p, ds = p_ds(bi, hi, rows, cols)
                        dv_acc += p.T @ gf[bi, hi, rows]
                        dk_acc += ds.T @ qf[bi, hi, rows]
                dk[bi, kvh, cols] = dk_acc * scale
                dv[bi, kvh, cols] = dv_acc
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


# causal + window + Sq != Skv both ways + ragged tiles + rows with no
# column, at head dims 64 and 128
EMULATED = {
    "gqa_window_ragged": (1, 4, 2, 200, 200, 64, 37),
    "sq_below_skv": (1, 2, 2, 100, 160, 64, None),
    "sq_above_skv": (2, 4, 2, 160, 100, 64, None),
    "rows_without_a_column": (1, 2, 1, 300, 64, 64, 64),
    "hd128_window_across_blocks": (1, 2, 1, 330, 330, 128, 130),
}


@pytest.mark.parametrize("sq,skv,window", [
    (200, 200, 37), (100, 160, None), (160, 100, None), (300, 64, 64),
    (330, 330, 130), (1000, 1000, 1), (64, 500, None), (513, 257, 200)])
def test_k2_live_tile_ranges_are_exactly_the_tiles_with_a_pair(sq, skv, window):
    """Both kernels visit a tile if and only if it holds an attended
    (row, column) pair: tiles wholly above the diagonal or behind the
    window are never loaded, and none that holds a pair is skipped."""
    row = torch.arange(sq)[:, None]
    col = torch.arange(skv)[None, :]
    ok = _attends(row, col, sq, skv, window)
    for row0 in range(0, sq, DQ_ROWS):
        live = {kt for kt in range(-(-skv // KV_STREAM))
                if ok[row0:row0 + DQ_ROWS,
                      kt * KV_STREAM:(kt + 1) * KV_STREAM].any()}
        assert set(_dq_kv_tiles(row0, sq, skv, window)) == live
    for col0 in range(0, skv, DKV_ROWS):
        live = {qt for qt in range(-(-sq // Q_STREAM))
                if ok[qt * Q_STREAM:(qt + 1) * Q_STREAM,
                      col0:col0 + DKV_ROWS].any()}
        assert set(_dkv_q_tiles(col0, sq, skv, window)) == live


def _bf16_inputs(case, seed):
    q, k, v, g = _inputs(case, seed)
    return [torch.from_numpy(x).bfloat16() for x in (q, k, v, g)]


def _held_bf16(got, ref):
    """Phase 8's bf16 limit: 2^-7 |ref| + 2^-7 max |ref|."""
    got, ref = got.float(), ref.float()
    top = float(ref.abs().max())
    assert bool(((got - ref).abs() <= ref.abs() * 2.0 ** -7
                 + 2.0 ** -7 * top).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("name", list(EMULATED))
def test_k2_bf16_tiling_emulation_matches_plain_and_jax(name):
    """The emulated bf16 body against the plain version (fp32 P and dS)
    and against the JAX K2 on the same bf16 inputs, in interpret mode,
    within phase 8's bf16 limit; rows with no column and kv rows no q row
    reads get exact zeros."""
    case = EMULATED[name]
    window = case[-1]
    q, k, v, g = _bf16_inputs(case, seed=7)
    out, lse = tfa.flash_attention_fwd_stats(q, k, v, window=window)
    got = _k2_emulation(q, k, v, g, out, lse, window)
    plain = tfa.flash_attention_backward(q, k, v, g, out, lse, window=window)
    for x, ref in zip(got, plain):
        assert x.dtype == torch.bfloat16
        _held_bf16(x, ref)
    # the JAX kernel is the reference on the rows that attend a column (it
    # leaves the others to its block layout): it is given those rows alone
    sq, skv = case[3], case[4]
    live = min(sq, skv + (window or sq) - 1)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in (q[:, :, :live], k, v, g[:, :, :live]))
    jout, jlse = jfa.flash_attention_fwd_stats(jq, jk, jv, bq=128, bk=128,
                                               window=window, interpret=True)
    want = jfa.flash_attention_backward(jq, jk, jv, jg, out=jout, lse=jlse,
                                        bq=128, bk=128, window=window,
                                        interpret=True)
    for x, w in zip((got[0][:, :, :live], got[1], got[2]), want):
        _held_bf16(x, torch.from_numpy(np.asarray(w, np.float32)))
    assert not got[0][:, :, live:].any()
    if skv > sq:
        assert not got[1][:, :, sq:].any() and not got[2][:, :, sq:].any()


# -- K1's bf16 body on the card (csrc/flash_attention.cu, wgmma): its tiling -
#
# A block owns 128 q rows (two consumers of 64) and streams the 64-row k / v
# tiles of the dq kernel's live range; a consumer skips a tile that holds no
# pair of its own rows.  Per tile: S = Q.K^T, masked pairs set to -inf, the
# running max m in the exp2 domain (scale log2 e), p = exp2(scale log2e S -
# m), l over the fp32 p, O rescaled and O += bf16(P).V; out = O / l (l == 0:
# / 1) rounded once, lse = m ln 2 + ln l (0 where l == 0).

FWD_ROWS = 64  # q rows of a consumer


def _k1_kv_tiles(row0, sq, skv, window, kv_stream=KV_STREAM):
    """The kv tiles the K1 block at q row row0 streams (the dq kernel's
    range: both blocks own 128 q rows)."""
    return _dq_kv_tiles(row0, sq, skv, window, kv_stream)


def _k1_dead(q_lo, c0, sq, window, kv_stream=KV_STREAM):
    """The consumer at q row q_lo skips the kv tile at column c0."""
    return (q_lo >= sq or c0 > q_lo + FWD_ROWS - 1
            or (window is not None and c0 + kv_stream - 1 <= q_lo - window))


def _k1_emulation(q, k, v, window, kv_stream=KV_STREAM):
    """The bf16 body's blocking in plain torch: (out in bf16, lse), k and v
    streamed kv_stream rows at a time."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    sl2 = 1.0 / np.sqrt(d) * 1.4426950408889634
    qf, kf, vf = (t.float() for t in (q, k, v))
    out, lse = torch.zeros(q.shape), torch.zeros((b, h, sq))
    for bi in range(b):
        for hi in range(h):
            kvh = hi // group
            for row0 in range(0, sq, DQ_ROWS):
                for q_lo in range(row0, min(row0 + DQ_ROWS, sq), FWD_ROWS):
                    rows = torch.arange(q_lo, min(q_lo + FWD_ROWS, sq))
                    m = torch.full((len(rows),), -1e30)
                    l = torch.zeros(len(rows))
                    o = torch.zeros((len(rows), d))
                    for kt in _k1_kv_tiles(row0, sq, skv, window, kv_stream):
                        c0 = kt * kv_stream
                        if _k1_dead(q_lo, c0, sq, window, kv_stream):
                            continue
                        cols = torch.arange(c0, min(c0 + kv_stream, skv))
                        s = qf[bi, hi, rows] @ kf[bi, kvh, cols].T
                        ok = _attends(rows[:, None], cols[None, :], sq, skv,
                                      window)
                        s = torch.where(ok, s, -torch.inf)
                        m_new = torch.maximum(m, s.max(1).values * sl2)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s * sl2 - m_new[:, None])
                        l = l * alpha + p.sum(1)
                        o = o * alpha[:, None] + _bf16(p) @ vf[bi, kvh, cols]
                        m = m_new
                    empty = l == 0
                    out[bi, hi, rows] = o / torch.where(empty, 1.0, l)[:, None]
                    lse[bi, hi, rows] = torch.where(
                        empty, 0.0,
                        m * np.log(2.0) + torch.log(torch.where(empty, 1.0, l)))
    return out.bfloat16(), lse


@pytest.mark.parametrize("sq,skv,window", [
    (200, 200, 37), (100, 160, None), (160, 100, None), (300, 64, 64),
    (330, 330, 130), (1000, 1000, 1), (64, 500, None), (513, 257, 200)])
def test_k1_live_tile_ranges_are_exactly_the_tiles_with_a_pair(sq, skv, window):
    """A K1 block visits a tile if and only if it holds an attended pair of
    the block's rows, and a consumer multiplies a visited tile if and only
    if the tile holds a pair of the consumer's own 64 rows."""
    row = torch.arange(sq)[:, None]
    col = torch.arange(skv)[None, :]
    ok = _attends(row, col, sq, skv, window)
    for row0 in range(0, sq, DQ_ROWS):
        tiles = list(_k1_kv_tiles(row0, sq, skv, window))
        live = {kt for kt in range(-(-skv // KV_STREAM))
                if ok[row0:row0 + DQ_ROWS,
                      kt * KV_STREAM:(kt + 1) * KV_STREAM].any()}
        assert set(tiles) == live
        for q_lo in (row0, row0 + FWD_ROWS):
            for kt in tiles:
                pair = bool(ok[q_lo:q_lo + FWD_ROWS,
                               kt * KV_STREAM:(kt + 1) * KV_STREAM].any())
                assert _k1_dead(q_lo, kt * KV_STREAM, sq, window) == (not pair)


@pytest.mark.parametrize("name", list(EMULATED))
def test_k1_bf16_tiling_emulation_matches_plain_and_jax(name):
    """The emulated bf16 forward (P rounded to bf16 before P.V, l over the
    fp32 P) against the plain version (fp32 throughout) and against the JAX
    K1 on the same bf16 inputs in interpret mode, within phase 8's bf16
    limit; lse within 1e-4 of the plain version's (the JAX kernel folds
    scale log2 e into q in bf16, so its lse is held to the bf16 limit);
    rows with no column get out = 0 and lse = 0 exactly."""
    case = EMULATED[name]
    window = case[-1]
    q, k, v, _ = _bf16_inputs(case, seed=11)
    got, got_lse = _k1_emulation(q, k, v, window)
    ref, ref_lse = tfa.flash_attention_fwd_stats(q, k, v, window=window)
    assert got.dtype == torch.bfloat16
    _held_bf16(got, ref)
    torch.testing.assert_close(got_lse, ref_lse, atol=1e-4, rtol=1e-5)
    sq, skv = case[3], case[4]
    live = min(sq, skv + (window or sq) - 1)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q[:, :, :live], k, v))
    jout, jlse = jfa.flash_attention_fwd_stats(jq, jk, jv, bq=128, bk=128,
                                               window=window, interpret=True)
    _held_bf16(got[:, :, :live], torch.from_numpy(np.array(jout, np.float32)))
    _held_bf16(got_lse[:, :, :live],
               torch.from_numpy(np.array(jlse, np.float32)))
    assert not got[:, :, live:].any() and not got_lse[:, :, live:].any()


# -- the hd-256 tiles (129-256 padded): K1 streams 64 kv rows, K2's dq
# kernel 32 and its dk/dv kernel 32 q rows (flash_attention.fwd_tiles,
# bwd_tiles) --------------------------------------------------------------

EMULATED_256 = {
    "hd256_mqa_window": (1, 8, 1, 200, 200, 256, 37),
    "hd256_rows_without_a_column": (1, 2, 1, 300, 64, 256, 64),
}


@pytest.mark.parametrize("sq,skv,window", [
    (200, 200, 37), (160, 100, None), (300, 64, 64), (513, 257, 200)])
@pytest.mark.parametrize("tile", range(len(tfa.BWD_TILES_256)))
def test_k2_hd256_live_tile_ranges_are_exactly_the_tiles_with_a_pair(
        sq, skv, window, tile):
    rows, q_rows = (tfa.bwd_tiles(256)[tile][k] for k in ("kv_rows",
                                                          "q_rows"))
    ok = _attends(torch.arange(sq)[:, None], torch.arange(skv)[None, :], sq,
                  skv, window)
    for row0 in range(0, sq, DQ_ROWS):
        live = {kt for kt in range(-(-skv // rows))
                if ok[row0:row0 + DQ_ROWS, kt * rows:(kt + 1) * rows].any()}
        assert set(_dq_kv_tiles(row0, sq, skv, window, rows)) == live
    for col0 in range(0, skv, DKV_ROWS):
        live = {qt for qt in range(-(-sq // q_rows))
                if ok[qt * q_rows:(qt + 1) * q_rows,
                      col0:col0 + DKV_ROWS].any()}
        assert set(_dkv_q_tiles(col0, sq, skv, window, q_rows)) == live


@pytest.mark.parametrize("tile", range(len(tfa.FWD_TILES_256)))
@pytest.mark.parametrize("name", list(EMULATED_256))
def test_k1_bf16_tiling_emulation_at_the_hd256_tiles(name, tile):
    """K1's emulated bf16 body at each hd-256 tile against the plain
    version and the JAX K1 in interpret mode, as at head dims 64 and 128."""
    case = EMULATED_256[name]
    window = case[-1]
    q, k, v, _ = _bf16_inputs(case, seed=13)
    got, got_lse = _k1_emulation(q, k, v, window,
                                 tfa.fwd_tiles(case[5])[tile]["kv_rows"])
    ref, ref_lse = tfa.flash_attention_fwd_stats(q, k, v, window=window)
    _held_bf16(got, ref)
    torch.testing.assert_close(got_lse, ref_lse, atol=1e-4, rtol=1e-5)
    sq, skv = case[3], case[4]
    live = min(sq, skv + (window or sq) - 1)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q[:, :, :live], k, v))
    jout, _ = jfa.flash_attention_fwd_stats(jq, jk, jv, bq=128, bk=128,
                                            window=window, interpret=True)
    _held_bf16(got[:, :, :live], torch.from_numpy(np.array(jout, np.float32)))
    assert not got[:, :, live:].any() and not got_lse[:, :, live:].any()


@pytest.mark.parametrize("tile", range(len(tfa.BWD_TILES_256)))
@pytest.mark.parametrize("name", list(EMULATED_256))
def test_k2_bf16_tiling_emulation_at_the_hd256_tiles(name, tile):
    """K2's emulated bf16 body at each hd-256 tile against the plain
    version and the JAX K2 in interpret mode, within phase 8's bf16
    limit."""
    case = EMULATED_256[name]
    window = case[-1]
    q, k, v, g = _bf16_inputs(case, seed=17)
    out, lse = tfa.flash_attention_fwd_stats(q, k, v, window=window)
    t = tfa.bwd_tiles(case[5])[tile]
    got = _k2_emulation(q, k, v, g, out, lse, window, t["kv_rows"],
                        t["q_rows"])
    plain = tfa.flash_attention_backward(q, k, v, g, out, lse, window=window)
    for x, ref in zip(got, plain):
        _held_bf16(x, ref)
    sq, skv = case[3], case[4]
    live = min(sq, skv + (window or sq) - 1)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in (q[:, :, :live], k, v, g[:, :, :live]))
    jout, jlse = jfa.flash_attention_fwd_stats(jq, jk, jv, bq=128, bk=128,
                                               window=window, interpret=True)
    want = jfa.flash_attention_backward(jq, jk, jv, jg, out=jout, lse=jlse,
                                        bq=128, bk=128, window=window,
                                        interpret=True)
    for x, w in zip((got[0][:, :, :live], got[1], got[2]), want):
        _held_bf16(x, torch.from_numpy(np.asarray(w, np.float32)))
    assert not got[0][:, :, live:].any()


# -- shared memory a block takes, by the layouts of csrc/attention_wgmma.cuh
# (WgFwdSmem, WgBwdSmem), csrc/flash_attention.cu (the split-TF32 bodies'
# Tf32*Smem) and csrc/attention_tile.cuh (fwd_smem, bwd_smem); each
# launcher also asserts its fit when it is compiled --------------------------

SMEM_LIMIT = 232448  # bytes a block can use on the H100
BLOCK_ROWS, KV_ROWS = 128, 64  # resident q rows (K1, dq); kv rows (dk/dv)


def _wgmma_smem(hd, tile, backward):
    """Bytes of the bf16 body's block at kernel head dim `hd` and `tile`;
    for the backward the larger of its dq and dk/dv kernels'."""
    st = tile["stages"]
    if not backward:
        return (BLOCK_ROWS * hd * 2 + st * 2 * tile["kv_rows"] * hd * 2
                + (1 + 2 * st) * 8 + 1024)
    bars = max((1 + 2 * st) * 8, 64)
    sr, qr = tile["kv_rows"], tile["q_rows"]
    dq = 2 * BLOCK_ROWS * hd * 2 + st * 2 * sr * hd * 2
    dkv = (2 * KV_ROWS * hd * 2 + st * 2 * qr * hd * 2 + st * KV_ROWS * qr * 4
           + st * 2 * qr * 4)
    return max(dq, dkv) + bars + 1024


def _fp32_smem(hd, backward):
    """Bytes of the fp32 body's block.  Head dims 64 and 128, the split-TF32
    bodies (csrc/flash_attention.cu Tf32FwdSmem, Tf32DqSmem, Tf32DkvSmem;
    two stages of sr = 64 or 32 rows): K1 keeps 128 q rows and a stage of
    k (hi, lo), v and v^T (hi, lo); the dq kernel 64 q and dO rows, stages
    of k and v (hi and lo each), P and dS (hi, lo); the dk/dv kernel 64 k
    and v rows, stages of q and dO (hi and lo each) with their lse and
    delta, P^T and dS^T (hi, lo); the backward is the larger of the two.
    Head dim 256, the fp32 tile (csrc/attention_tile.cuh): three fp32 tiles
    of 64 x (hd + 4) (the backward's streamed tiles share one) and P (64 x
    68)."""
    if hd > 128:
        return 4 * (3 * 64 * (hd + 4) + 64 * 68)
    sr = 64 if hd == 64 else 32
    tile = sr * hd * 4
    if not backward:
        return BLOCK_ROWS * hd * 4 + 2 * 5 * tile + 3 * 8 + 1024
    dq = 2 * KV_ROWS * hd * 4 + 2 * 4 * tile + 3 * KV_ROWS * sr * 4
    dkv = (2 * KV_ROWS * hd * 4 + 2 * 4 * tile + 4 * KV_ROWS * sr * 4
           + 2 * 2 * sr * 4)
    return max(dq, dkv) + 3 * 8 + 1024


@pytest.mark.parametrize("d", [64, 128, 256])
def test_every_tile_fits_a_blocks_shared_memory(d):
    """Each tile of the head dim's tables (and the fp32 bodies' one) fits
    the 232,448 bytes a block can use; the hd-128 tiles that do not fit at
    256 are left out of its tables."""
    for tile in tfa.fwd_tiles(d):
        assert _wgmma_smem(d, tile, backward=False) <= SMEM_LIMIT
    for tile in tfa.bwd_tiles(d):
        assert _wgmma_smem(d, tile, backward=True) <= SMEM_LIMIT
    for backward in (False, True):
        assert _fp32_smem(d, backward) <= SMEM_LIMIT
    if d == 256:  # the hd-128 defaults would not fit: the reason for a table
        assert _wgmma_smem(256, tfa.FWD_TILES[0], False) > SMEM_LIMIT
        assert _wgmma_smem(256, tfa.BWD_TILES[0], True) > SMEM_LIMIT
        assert 4 * (4 * 64 * 260 + 64 * 68) > SMEM_LIMIT  # four fp32 tiles
    # the layouts' figures as the kernels' sources state them
    assert _wgmma_smem(128, tfa.BWD_TILES[2], True) == 182848
    assert _wgmma_smem(256, tfa.FWD_TILES_256[0], False) == 197672
    assert _wgmma_smem(256, tfa.BWD_TILES_256[0], True) == 197696
    assert _fp32_smem(256, True) == 217088
    assert _fp32_smem(128, False) == 230424 and _fp32_smem(64, True) == 231448


def test_head_dims_pad_up_to_256_and_raise_above():
    assert [tfa.padded_head_dim(d) for d in (1, 64, 65, 128, 129, 200, 256)] \
        == [64, 64, 128, 128, 256, 256, 256]
    with pytest.raises(tfa.HeadDimError, match="256"):
        tfa.padded_head_dim(257)
    assert issubclass(tfa.HeadDimError, ValueError)
    q = torch.zeros((1, 1, 4, 257))
    # the plain versions take any head dim; only a CUDA launch is limited
    out, lse = tfa.flash_attention_fwd_stats(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 1, 4)
