"""The split-TF32 fp32 bodies of K1 and K2, emulated on the CPU.

The CUDA bodies (csrc/flash_attention.cu, `flash_fwd_tf32`,
`flash_bwd_dq_tf32`, `flash_bwd_dkv_tf32`) run on the card only.  Their
arithmetic is kept testable here: `tf32_split` (the wrapper's plain copy
of the kernels' `cvt.rna.tf32.f32` split) is checked against its bound,
and an emulation of the bodies' blocking (128 q rows a K1 block in two
consumers of 64, kv stages of 64 rows at head dim 64 and 32 at 128; dq
blocks of 64 q rows; dk/dv blocks of 64 kv rows over q stages of the same
depths) and their split-TF32 products (each as a_hi.b_lo + a_lo.b_hi +
a_hi.b_hi of TF32 values, whose products are exact in fp32) is held

  * to the JAX package's Pallas kernels in interpret mode (fp32, HIGHEST)
    within the fp32 gate of tests/test_torch_flash_attention.py, atol and
    rtol 1e-4;
  * to a float64 evaluation within 1/64 of the error of the plain version
    computed with TF32 products (its operands rounded to TF32, as a TF32
    matmul reads them): the accuracy gate that chip_smoke.py applies to the
    kernels on the card.  The same emulation with one TF32 pass fails it.
"""

import functools
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from kfunca_tpu.ops.pallas_kernels import flash_attention as jfa
from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as tfa

TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
NEG = -1e30
# (b, h, hkv, sq, skv, d, window): tests/test_torch_flash_attention.py's
# mha, ragged (hd 40, padded to 64) and gqa_6_3_window_64, and GQA with a
# window at hd 128
CASES = {
    "mha": (1, 2, 2, 128, 128, 128, None),
    "ragged": (1, 1, 1, 35, 67, 40, None),
    "gqa_6_3_window_64": (1, 6, 3, 256, 256, 64, 64),
    "gqa_4_2_window_130_hd128": (1, 4, 2, 200, 200, 128, 130),
}
# window 64, Sq 300 over Skv 64: rows 127.. attend no column
NO_COLUMN = (1, 2, 1, 300, 64, 64, 64)


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


# -- the emulation -----------------------------------------------------------

def _prod(a, b, passes):
    """a @ b from TF32 operands: three passes (the small terms first) or
    one."""
    ah, al = tfa.tf32_split(a)
    bh, bl = tfa.tf32_split(b)
    if passes == 1:
        return ah @ bh
    return ah @ bl + al @ bh + ah @ bh


def _tiles(d):
    """(padded head dim, kv rows a K1 / dq stage, q rows a dk/dv stage)."""
    dp = tfa.padded_head_dim(d)
    assert dp in (64, 128), "the split-TF32 bodies take head dims to 128"
    return dp, (64 if dp == 64 else 32), (64 if dp == 64 else 32)


def _attends(rows, cols, skv, window):
    ok = (cols[None, :] <= rows[:, None]) & (cols[None, :] < skv)
    if window is not None:
        ok &= cols[None, :] > rows[:, None] - window
    return ok


def _prepare(q, k, v, g=None):
    d = q.shape[-1]
    dp, sr, qr = _tiles(d)
    group = q.shape[1] // k.shape[1]
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, dp - d))
    ts = [pad(q), pad(k).repeat_interleave(group, 1),
          pad(v).repeat_interleave(group, 1)]
    if g is not None:
        ts.append(pad(g))
    return ts, dp, sr, qr, np.float32(1.0 / math.sqrt(d))


def emulate_k1(q, k, v, window=None, passes=3):
    """(out, lse) as the K1 body computes them."""
    (qp, kp, vp), dp, sr, _, scale = _prepare(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    sl2 = torch.tensor(scale * LOG2E)
    out = torch.zeros((b, h, sq, dp))
    lse = torch.zeros((b, h, sq))
    for row0 in range(0, sq, 128):
        col_hi = min(row0 + 127, sq - 1, skv - 1)
        col_lo = max(row0 - window + 1, 0) if window else 0
        if col_lo > col_hi:
            continue
        for c in range(2):  # the two consumers
            q_lo = row0 + 64 * c
            if q_lo >= sq:
                continue
            rows = torch.arange(q_lo, min(q_lo + 64, sq))
            m = torch.full((b, h, len(rows)), NEG)
            l = torch.zeros((b, h, len(rows)))
            o = torch.zeros((b, h, len(rows), dp))
            for c0 in range(col_lo // sr * sr, col_hi + 1, sr):
                if c0 > q_lo + 63 or (window and c0 + sr - 1 <= q_lo - window):
                    continue  # a tile with no pair of this consumer's rows
                cols = torch.arange(c0, min(c0 + sr, skv))
                s = _prod(qp[:, :, rows], kp[:, :, cols].transpose(-1, -2),
                          passes)
                s = torch.where(_attends(rows, cols, skv, window), s,
                                -math.inf)
                m_new = torch.maximum(m, s.amax(-1) * sl2)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * sl2 - m_new[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + _prod(p, vp[:, :, cols], passes)
                m = m_new
            out[:, :, rows] = o / torch.where(l == 0, 1.0, l)[..., None]
            lse[:, :, rows] = torch.where(
                l == 0, 0.0, m * LN2 + torch.log(torch.where(l == 0, 1.0, l)))
    return out[..., :d], lse


def emulate_k2(q, k, v, g, out, lse, window=None, passes=3):
    """(dq, dk, dv) as the K2 bodies compute them (delta pre-pass, the dq
    kernel, the dk/dv kernel)."""
    (qp, kp, vp, gp), dp, sr, qr, scale = _prepare(q, k, v, g)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    op = torch.nn.functional.pad(out.float(), (0, dp - d))
    delta = (gp * op).sum(-1)
    sl2 = torch.tensor(scale * LOG2E)
    l2 = lse * LOG2E
    dq = torch.zeros((b, h, sq, dp))
    for row0 in range(0, sq, 64):
        rows = torch.arange(row0, min(row0 + 64, sq))
        col_hi = min(row0 + 63, sq - 1, skv - 1)
        col_lo = max(row0 - window + 1, 0) if window else 0
        acc = torch.zeros((b, h, len(rows), dp))
        for c0 in range(col_lo // sr * sr, col_hi + 1, sr):
            cols = torch.arange(c0, min(c0 + sr, skv))
            s = _prod(qp[:, :, rows], kp[:, :, cols].transpose(-1, -2), passes)
            p = torch.where(_attends(rows, cols, skv, window),
                            torch.exp2(s * sl2 - l2[:, :, rows, None]), 0.0)
            dpr = _prod(gp[:, :, rows], vp[:, :, cols].transpose(-1, -2),
                        passes)
            ds = p * (dpr - delta[:, :, rows, None])
            acc += _prod(ds, kp[:, :, cols], passes)
        dq[:, :, rows] = acc * scale
    dk = torch.zeros((b, hkv, skv, dp))
    dv = torch.zeros((b, hkv, skv, dp))
    for col0 in range(0, skv, 64):
        cols = torch.arange(col0, min(col0 + 64, skv))
        qt_last = (sq - 1) // qr
        if window:
            qt_last = min(qt_last, (min(col0 + 63, skv - 1) + window - 1) // qr)
        kacc = torch.zeros((b, hkv, len(cols), dp))
        vacc = torch.zeros((b, hkv, len(cols), dp))
        for j in range(group):  # the group's heads, then its q tiles
            heads = torch.arange(hkv) * group + j
            kh, vh = kp[:, heads][:, :, cols], vp[:, heads][:, :, cols]
            for qt in range(col0 // qr, qt_last + 1):
                rows = torch.arange(qt * qr, min(qt * qr + qr, sq))
                qh, gh = qp[:, heads][:, :, rows], gp[:, heads][:, :, rows]
                st_ = _prod(kh, qh.transpose(-1, -2), passes)
                pt = torch.where(
                    _attends(rows, cols, skv, window).T,
                    torch.exp2(st_ * sl2 - l2[:, heads][:, :, None, rows]),
                    0.0)
                vacc += _prod(pt, gh, passes)
                dpt = _prod(vh, gh.transpose(-1, -2), passes)
                ph, pl = tfa.tf32_split(pt)  # P^T read back as hi + lo
                dst = (ph + pl) * (dpt - delta[:, heads][:, :, None, rows])
                kacc += _prod(dst, qh, passes)
        dk[:, :, cols] = kacc * scale
        dv[:, :, cols] = vacc
    return dq[..., :d], dk[..., :d], dv[..., :d]


@functools.lru_cache(maxsize=None)
def _emulated(case, seed=0, passes=3):
    q, k, v, g = map(torch.from_numpy, _inputs(case, seed))
    out, lse = emulate_k1(q, k, v, case[-1], passes)
    grads = emulate_k2(q, k, v, g, out, lse, case[-1], passes)
    return tuple(x.numpy() for x in (out, lse, *grads))


@functools.lru_cache(maxsize=None)
def _jax(case, seed=0):
    return _jax_kernels(*_inputs(case, seed), case[-1])


# -- tf32_split ----------------------------------------------------------------

MAX_FINITE_HI = 2.0 ** 128 - 2.0 ** 114  # above, hi rounds to inf


@settings(max_examples=400, deadline=None)
@given(st.floats(width=32, allow_nan=True, allow_infinity=True,
                 allow_subnormal=True))
def test_tf32_split_reproduces_x_across_exponents(x):
    """hi and lo are TF32 values (low 13 bits 0) whose sum is x within
    2^-22 |x| (2^-21 is the stated bound), or within half a TF32 step
    (2^-137) where x - hi is subnormal; NaN and +-inf pass through hi, and
    +-0 splits into itself and 0."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = tfa.tf32_split(t)
    for part in (hi, lo):
        if torch.isfinite(part).all():
            assert int(part.view(torch.int32)) & 0x1FFF == 0
    if math.isnan(x):
        assert math.isnan(float(hi))
        return
    if math.isinf(x):
        assert float(hi) == x
        return
    if abs(x) >= MAX_FINITE_HI:
        assert math.isinf(float(hi))
        return
    if x == 0:
        assert float(hi) == 0 and float(lo) == 0
        assert math.copysign(1, float(hi)) == math.copysign(1, x)
        return
    err = abs(float(t.double()) - (float(hi.double()) + float(lo.double())))
    assert err <= max(2.0 ** -21 * abs(x), 2.0 ** -137)
    assert err <= max(2.0 ** -22 * abs(x), 2.0 ** -137)


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi against float64 arithmetic: the nearest TF32 value, a tie going
    away from zero (cvt.rna)."""
    one = 2.0 ** -10  # a TF32 step at 1
    xs = np.array([1 + one / 2, 1 + 3 * one / 2, -(1 + one / 2), 1 + one / 4,
                   1 + 3 * one / 4, 3.0, 1e-3, -7.123456, 2.0 ** -126,
                   3.0e38], dtype=np.float32)
    hi, lo = tfa.tf32_split(torch.from_numpy(xs))
    x64 = xs.astype(np.float64)
    e = np.floor(np.log2(np.abs(x64)))
    step = 2.0 ** (e - 10)
    ref = np.sign(x64) * np.floor(np.abs(x64) / step + 0.5) * step
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), ref)
    assert hi[0] == 1 + one and hi[2] == -(1 + one) and hi[3] == 1
    # lo is the remainder, itself rounded to TF32
    rem = x64 - ref
    np.testing.assert_allclose(lo.numpy(), rem, rtol=2.0 ** -11, atol=0)


def test_route_names_the_body_of_each_dtype_and_head_dim():
    assert tfa.route(torch.bfloat16, 128) == "wgmma"
    assert [tfa.route(torch.float32, d) for d in (40, 64, 100, 128)] == \
        ["split_tf32"] * 4
    assert [tfa.route(torch.float32, d) for d in (129, 256)] == \
        ["fp32_tile"] * 2
    assert tfa.route(torch.bfloat16, 256) == "wgmma"


# -- the emulation against the JAX kernels ------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_emulated_forward_matches_the_jax_kernel(name):
    want, got = _jax(CASES[name]), _emulated(CASES[name])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_backward_matches_the_jax_kernel(name):
    want, got = _jax(CASES[name]), _emulated(CASES[name])
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_allclose(g, w, **TOL)


def test_emulated_rows_without_a_column():
    """The emulation gives rows that attend no column out = 0, lse = 0 and
    dq = 0, and matches the JAX kernel given the live rows alone (as
    tests/test_torch_flash_attention.py holds the plain version)."""
    q, k, v, g = _inputs(NO_COLUMN, seed=1)
    live = 64 + 64 - 1
    want = _jax_kernels(q[:, :, :live], k, v, g[:, :, :live], 64)
    got = _emulated(NO_COLUMN, seed=1)
    for x, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(x[:, :, :live], w, **TOL)
        assert not x[:, :, live:].any()
    np.testing.assert_allclose(got[3], want[3], **TOL)
    np.testing.assert_allclose(got[4], want[4], **TOL)


def test_emulated_unread_kv_rows_get_exact_zero_gradients():
    """Skv 160 over Sq 100 at hd 64: kv rows 100.. are read by no q row."""
    got = _emulated((1, 2, 2, 100, 160, 64, None))
    assert not got[3][:, :, 100:].any() and not got[4][:, :, 100:].any()
    assert np.abs(got[3][:, :, :100]).min() > 0


# -- the accuracy gate ----------------------------------------------------------

def _reference64(q, k, v, g, window):
    """(out, lse, dq, dk, dv) in float64 (the plain version's formulas)."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    group = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(group, 1) for t in (k, v))
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    ok = _attends(torch.arange(sq), torch.arange(skv), skv, window)
    s = torch.where(ok, q @ kr.transpose(-1, -2) / math.sqrt(d), -math.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = p @ vr
    dpr = g @ vr.transpose(-1, -2)
    ds = p * (dpr - (g * out).sum(-1, keepdim=True))
    dq = ds @ kr / math.sqrt(d)
    fold = lambda t: t.unflatten(1, (k.shape[1], group)).sum(2)
    dk = fold(ds.transpose(-1, -2) @ q) / math.sqrt(d)
    dv = fold(p.transpose(-1, -2) @ g)
    return out, lse, dq, dk, dv


def _plain_tf32(q, k, v, g, window):
    """The plain version with TF32 products: the same formulas in fp32 with
    every matrix product's operands rounded to TF32."""
    hi = lambda t: tfa.tf32_split(t)[0]
    mm = lambda a, b: hi(a) @ hi(b)
    group = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(group, 1) for t in (k, v))
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    ok = _attends(torch.arange(sq), torch.arange(skv), skv, window)
    s = torch.where(ok, mm(q, kr.transpose(-1, -2)) / math.sqrt(d), NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / l
    out = mm(p, vr)
    lse = (m + torch.log(l))[..., 0]
    ds = p * (mm(g, vr.transpose(-1, -2)) - (g * out).sum(-1, keepdim=True))
    dq = mm(ds, kr) / math.sqrt(d)
    fold = lambda t: t.unflatten(1, (k.shape[1], group)).sum(2)
    dk = fold(mm(ds.transpose(-1, -2), q)) / math.sqrt(d)
    dv = fold(mm(p.transpose(-1, -2), g))
    return out, lse, dq, dk, dv


GATE_CASES = {"hd64": (1, 4, 2, 256, 256, 64, None),
              "hd128": (1, 4, 2, 192, 192, 128, 100)}
NAMES = ("out", "lse", "dq", "dk", "dv")


@functools.lru_cache(maxsize=None)
def _gate_errors(name, passes):
    """(emulation error, plain TF32 error) of each output against float64."""
    case = GATE_CASES[name]
    q, k, v, g = map(torch.from_numpy, _inputs(case, seed=7))
    ref = _reference64(q, k, v, g, case[-1])
    tf32 = _plain_tf32(q, k, v, g, case[-1])
    got = _emulated(case, seed=7, passes=passes)
    err = lambda a, r: float((torch.as_tensor(a).double() - r).abs().max())
    return [(err(x, r), err(y, r)) for x, y, r in zip(got, tf32, ref)]


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_split_tf32_passes_the_accuracy_gate(name):
    """Each output within 1/64 of the TF32 plain version's error."""
    for what, (e, e_tf32) in zip(NAMES, _gate_errors(name, 3)):
        assert e <= e_tf32 / 64, (what, e, e_tf32)


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_single_pass_tf32_fails_the_accuracy_gate(name):
    """One TF32 pass is as coarse as the TF32 plain version: the gate
    tells the two apart on every output."""
    for what, (e, e_tf32) in zip(NAMES, _gate_errors(name, 1)):
        assert e > e_tf32 / 64, (what, e, e_tf32)
