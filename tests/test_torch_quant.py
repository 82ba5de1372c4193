"""Port parity: the quantizers and quantized GEMMs of kfunca_tpu_torch.

The same numpy inputs go through kfunca_tpu/ops/quant.py and
kfunca_tpu_torch/ops/quant.py.  Quantizers are compared bit for bit (int8
values and fp32 scales).  On CPU tensors the port's `matmul_q8` runs its
plain version (the CUDA kernel is held against that plain version on the
card by chip_smoke.py and tests/test_torch_cuda.py); here the plain version
is held against the JAX Pallas kernel in interpret mode, against
matmul_q8_xla, and against an int64 numpy oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.ops import quant as jq
from kfunca_tpu_torch.ops import quant as tq


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, shape):
    """Normal values with the awkward cases mixed in: an all-zero row and
    column (scale 1), and values that land exactly on a .5 tie after the
    division (the row's absmax is 127, so x / scale == x)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[1, :] = 0.0
    x[:, 2] = 0.0
    x[0, :] = np.resize(np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                    63.5], np.float32), shape[1])
    x[0, 2] = 0.0
    return x


@pytest.mark.parametrize("name", ["quantize_cols", "quantize_rows",
                                  "quantize_vecs"])
def test_quantizers_are_bit_equal_to_jax(name):
    x = _inputs(0, (24, 40))
    if name == "quantize_cols":
        x = np.ascontiguousarray(x.T)  # ties and absmax 127 down a column
    if name == "quantize_vecs":
        x = x.reshape(4, 6, 40)
    got_q, got_s = getattr(tq, name)(_t(x))
    want_q, want_s = getattr(jq, name)(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the ties went to the even neighbour, the zero vectors got scale 1
    flat_q = got_q.numpy().reshape(-1, 40) if name != "quantize_cols" \
        else got_q.numpy().T
    assert flat_q[0, :8].tolist() == [127, 0, 0, 2, 0, -2, -2, 64]
    assert (got_s.numpy().reshape(-1)[1] == 1.0
            if name != "quantize_cols" else got_s.numpy()[1] == 1.0)


def test_quantizers_divide_by_the_scale():
    """x / scale and x * (1 / scale) differ in the last bit, and for a few
    values in a million that bit decides which side of .5 the quotient
    lands on.  The JAX package divides; so must the port, or its int8
    values differ.  This input holds two such values per row quantizer."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((256, 2048)) * 3).astype(np.float32)
    scale = np.abs(x).max(axis=1) / np.float32(127.0)
    flips = np.round(x / scale[:, None]) != np.round(
        x * (np.float32(1.0) / scale)[:, None])
    assert flips.sum() >= 2  # the input does tell the two apart
    for name, arg in (("quantize_rows", x), ("quantize_vecs", x),
                      ("quantize_cols", np.ascontiguousarray(x.T))):
        got_q, got_s = getattr(tq, name)(_t(arg))
        want_q, want_s = getattr(jq, name)(jnp.asarray(arg))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantizers_take_bf16_like_jax():
    x = _t(_inputs(1, (8, 16))).bfloat16()
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    for name in ("quantize_cols", "quantize_rows", "quantize_vecs"):
        got_q, got_s = getattr(tq, name)(x)
        want_q, want_s = getattr(jq, name)(xj)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("group", [128, 16, 2])
def test_quantize_cols_int4_is_bit_equal_to_jax(group):
    x = _inputs(2, (256, 24))
    x[:16, 5] = 0.0  # an all-zero group: scale 1
    x[16:32, 6] = np.resize(np.asarray([7.0, 0.5, 1.5, -2.5], np.float32), 16)
    got_q, got_s = tq.quantize_cols_int4(_t(x), group=group)
    want_q, want_s = jq.quantize_cols_int4(jnp.asarray(x), group=group)
    assert got_q.dtype == torch.uint8 and got_q.shape == (128, 24)
    np.testing.assert_array_equal(tq.unpack_int4(got_q).numpy(),
                                  np.asarray(want_q.astype(jnp.int8)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # half the bytes of the int8 form
    assert got_q.numel() * got_q.element_size() * 2 == x.size


def test_int4_packing_roundtrips_every_value():
    vals = torch.arange(-8, 8, dtype=torch.int8)
    q = torch.stack([vals, vals.flip(0)], dim=0).repeat(3, 1)  # (6, 16)
    packed = tq.pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 16)
    assert torch.equal(tq.unpack_int4(packed), q)
    with pytest.raises(ValueError, match="even k"):
        tq.pack_int4(q[:5])


def _q8_case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sa = rng.uniform(0.01, 0.1, m).astype(np.float32)
    sb = rng.uniform(0.01, 0.1, n).astype(np.float32)
    return a, b, sa, sb


@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (1, 96, 40), (37, 300, 129)])
def test_matmul_q8_is_exact_against_the_int64_oracle(m, k, n):
    """fp32 output: the same integers multiplied by the same two scales in
    the same order, so the port, JAX's XLA expression and the numpy oracle
    agree bit for bit; the interpreted Pallas kernel too."""
    a, b, sa, sb = _q8_case(3, m, k, n)
    got = tq.matmul_q8(_t(a), _t(b), _t(sa), _t(sb), out_dtype=torch.float32)
    acc = a.astype(np.int64) @ b.astype(np.int64)
    oracle = (acc.astype(np.float32) * sa[:, None]) * sb[None, :]
    np.testing.assert_array_equal(got.numpy(), oracle)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa), jnp.asarray(sb))
    xla = jq.matmul_q8_xla(*args, out_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    pallas = jq.matmul_q8(*args, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_matmul_q8_bf16_output_rounds_once():
    a, b, sa, sb = _q8_case(4, 8, 128, 64)
    t = (_t(a), _t(b), _t(sa), _t(sb))
    got = tq.matmul_q8(*t)  # bf16 is the default, as in the JAX package
    assert got.dtype == torch.bfloat16
    want = tq.matmul_q8(*t, out_dtype=torch.float32).bfloat16()
    assert torch.equal(got, want)
    xla = jq.matmul_q8_xla(*(jnp.asarray(x) for x in (a, b, sa, sb)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(xla.astype(jnp.float32)))


def test_matmul_q8_extreme_values_fill_the_accumulator():
    """All -127 x 127 over k = 4096: |acc| = 66,064,384 stays exact."""
    a = np.full((2, 4096), 127, np.int8)
    b = np.full((4096, 3), -127, np.int8)
    one = np.ones
    got = tq.matmul_q8(_t(a), _t(b), _t(one(2, np.float32)),
                       _t(one(3, np.float32)), out_dtype=torch.float32)
    assert (got.numpy() == np.float32(-127 * 127 * 4096)).all()


def test_matmul_q8_checks_inputs():
    a, b, sa, sb = (_t(x) for x in _q8_case(5, 4, 16, 8))
    with pytest.raises(TypeError, match="int8"):
        tq.matmul_q8(a.int(), b, sa, sb)
    with pytest.raises(ValueError, match=r"\(m, k\) @ \(k, n\)"):
        tq.matmul_q8(a, b[:8], sa, sb)
    with pytest.raises(ValueError, match="scales"):
        tq.matmul_q8(a, b, sa[:2], sb)
    with pytest.raises(TypeError, match="out_dtype"):
        tq.matmul_q8(a, b, sa, sb, out_dtype=torch.float16)
    big = torch.zeros((1, tq.MAX_K_INT32 + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        tq.matmul_q8(big, torch.zeros((tq.MAX_K_INT32 + 1, 1),
                                      dtype=torch.int8), sa[:1], sb[:1])
    assert tq.MAX_K_INT32 * 127 * 127 < 2 ** 31 <= (tq.MAX_K_INT32 + 1) * 127 * 127


def test_cpu_tensors_run_the_plain_version_uncounted(monkeypatch):
    a, b, sa, sb = (_t(x) for x in _q8_case(6, 8, 64, 32))
    before = tq.matmul_q8.launches
    got = tq.matmul_q8(a, b, sa, sb, out_dtype=torch.float32)
    assert torch.equal(got, tq.matmul_q8_plain(a, b, sa, sb, torch.float32))
    # the port has one engine: the JAX package's knob changes nothing
    monkeypatch.setenv("KFUNCA_GEMM_ENGINE", "xla")
    assert torch.equal(got, tq.matmul_q8_auto(a, b, sa, sb, torch.float32))
    assert tq.matmul_q8.launches == before


def test_split_k_plan_fills_the_card_and_keeps_long_slices():
    """The decode shapes get enough blocks for 132 SMs, every block keeps
    at least 512 k-rows, and a large m needs no split."""
    for m, k, n in [(8, 4096, 6144), (8, 4096, 4096), (8, 4096, 14336),
                    (8, 14336, 4096), (8, 4096, 32000)]:
        split = tq.q8_split_k(m, k, n)
        assert 1 <= split <= 32 and k // split >= 512
        assert split * -(-n // 128) * -(-m // 8) >= 200
    assert tq.q8_split_k(300, 4096, 4096) == 1
    assert tq.q8_split_k(8, 100, 64) == 1


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on Python ints: result byte i is byte
    (sel >> 4i) & 7 of the 8 bytes {y:x}."""
    src = x.to_bytes(4, "little") + y.to_bytes(4, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)),
                          "little")


def test_kernel_byte_transpose_selectors():
    """The K5 kernel transposes a 4 x 4 byte block of b in registers with
    the selectors below, so that __dp4a gets one column's four k values;
    here the same selectors on Python ints."""
    rng = np.random.default_rng(7)
    block = rng.integers(0, 256, (4, 4))  # [k row][column]
    r = [int.from_bytes(bytes(block[j].tolist()), "little") for j in range(4)]
    t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[2], r[3], 0x5140)
    t2, t3 = _byte_perm(r[0], r[1], 0x7362), _byte_perm(r[2], r[3], 0x7362)
    cols = [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]
    for j, c in enumerate(cols):
        assert list(c.to_bytes(4, "little")) == block[:, j].tolist()


def test_gemm_w8_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((8, 256)).astype(np.float32)
    w = rng.standard_normal((256, 96)).astype(np.float32)
    wq, ws = tq.quantize_cols(_t(w))
    jwq, jws = jq.quantize_cols(jnp.asarray(w))
    got = tq.gemm_w8(_t(a), wq, ws)
    want = jq.gemm_w8(jnp.asarray(a), jwq, jws)
    assert got.dtype == torch.float32  # the activations' dtype by default
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    err = np.abs(got.numpy() - a @ w)
    assert err.max() < 0.08 * np.std(a @ w)


@pytest.mark.parametrize("group", [128, 32])
def test_w4_product_matches_jax(group):
    """Exact int32 inside each k-group on both sides; the fp32 sum across
    groups runs in another order (einsum against einsum), hence 1e-5
    relative to the output's scale."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((8, 256)).astype(np.float32)
    w = rng.standard_normal((256, 48)).astype(np.float32)
    wq, ws = tq.quantize_cols_int4(_t(w), group=group)
    jwq, jws = jq.quantize_cols_int4(jnp.asarray(w), group=group)
    aq, asc = tq.quantize_rows(_t(a))
    got = tq.matmul_w4(aq, wq, asc, ws, out_dtype=torch.float32)
    want = np.asarray(jq.matmul_w4_xla(
        jnp.asarray(aq.numpy()), jwq, jnp.asarray(asc.numpy()), jws,
        out_dtype=jnp.float32))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale, rtol=0)
    # the int64 oracle, group by group
    q = tq.unpack_int4(wq).numpy().astype(np.int64).reshape(-1, group, 48)
    ag = aq.numpy().astype(np.int64).reshape(8, -1, group)
    acc = np.einsum("mgk,gkn->gmn", ag, q).astype(np.float64)
    oracle = np.einsum("gmn,gn->mn", acc, ws.numpy().astype(np.float64)) \
        * asc.numpy()[:, None]
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5 * scale, rtol=0)
    full = tq.gemm_w4(_t(a), wq, ws)
    np.testing.assert_array_equal(full.numpy(), got.numpy())
    jfull = jq.gemm_w4(jnp.asarray(a), jwq, jws)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                               atol=1e-5 * scale, rtol=0)


def test_dequant_weight_matches_jax():
    rng = np.random.default_rng(10)
    w = rng.standard_normal((128, 40)).astype(np.float32)
    q8, s8 = tq.quantize_cols(_t(w))
    jq8, js8 = jq.quantize_cols(jnp.asarray(w))
    np.testing.assert_array_equal(tq.dequant_weight(q8, s8).numpy(),
                                  np.asarray(jq.dequant_weight(jq8, js8)))
    q4, s4 = tq.quantize_cols_int4(_t(w), group=32)
    jq4, js4 = jq.quantize_cols_int4(jnp.asarray(w), group=32)
    got = tq.dequant_weight(q4, s4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.dequant_weight(jq4, js4)))
    assert np.abs(got.numpy() - w).max() <= s4.max().item() * 0.5 + 1e-6
    assert tq.dequant_weight(q8, s8, torch.bfloat16).dtype == torch.bfloat16
