"""Port parity: the paged decode attention of kfunca_tpu_torch.

The port's `paged_decode_attention_dma` and `paged_decode_attention` run
their plain PyTorch version on CPU tensors (the CUDA kernel is held
against that same plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py).  Here the plain version is held against the JAX
package's Pallas kernels in interpret mode on the cases of
tests/test_paged_dma.py, for every pool form (fused and split, 4-D and
flat, fp32 and int8 with slot-major and head-major scales), atol 2e-5 (the
JAX suite's own tolerance: both take an fp32 softmax, in a different
summation order; int8 adds the order in which the scales are applied).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.ops.pallas_kernels.paged_attention import (
    paged_decode_attention as jax_k6,
    paged_decode_attention_dma as jax_dma,
)
from kfunca_tpu_torch.ops.pallas_kernels import paged_attention as tpa
from kfunca_tpu_torch.ops.pallas_kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_dma,
    paged_decode_attention_plain,
)
from kfunca_tpu_torch.ops.quant import quantize_vecs

ATOL = 2e-5


def _fused(rng, n_pages, page, hkv, hd):
    """(n_pages, page, 2*Hkv*hd) fused [k heads | v heads] rows."""
    k = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, hkv, hd)).astype(np.float32)
    return np.concatenate([k.reshape(n_pages, page, -1),
                           v.reshape(n_pages, page, -1)], axis=2)


def _case(h, hkv, hd=64):
    rng = np.random.default_rng(5)
    pool = _fused(rng, 16, 4, hkv, hd)
    tables = np.asarray([[1, 2, 3, 15], [4, 5, 15, 15], [6, 15, 15, 15]],
                        np.int32)
    positions = np.asarray([13, 6, 2], np.int32)
    q = (rng.standard_normal((3, h, hd)) / hd ** 0.5).astype(np.float32)
    return q, pool, tables, positions


def _port(q, pool, tables, positions, **kw):
    out = paged_decode_attention_dma(
        torch.from_numpy(q), torch.from_numpy(pool),
        torch.from_numpy(tables), torch.from_numpy(positions), **kw)
    return out.numpy()


def _jax(q, pool, tables, positions, **kw):
    return np.asarray(jax_dma(
        jnp.asarray(q), jnp.asarray(pool), None, jnp.asarray(tables),
        jnp.asarray(positions), depth=2, interpret=True, **kw))


@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("window", [None, 7])
def test_fused_pool_matches_jax_kernel(h, hkv, window):
    q, pool, tables, positions = _case(h, hkv)
    got = _port(q, pool, tables, positions, window=window)
    want = _jax(q, pool, tables, positions, window=window)
    assert got.shape == (3, h, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_page_base_reads_stacked_layer():
    rng = np.random.default_rng(9)
    layers, n_pages, page, hkv, hd = 3, 8, 4, 2, 64
    flat = np.concatenate([_fused(rng, n_pages, page, hkv, hd)
                           for _ in range(layers)])
    tables = np.asarray([[1, 2, 7], [4, 7, 7]], np.int32)
    positions = np.asarray([6, 3], np.int32)
    q = (rng.standard_normal((2, hkv, hd)) / hd ** 0.5).astype(np.float32)
    for li in range(layers):
        got = _port(q, flat, tables, positions, page_base=li * n_pages)
        want = _jax(q, flat, tables, positions, page_base=li * n_pages)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=li)
        # the layer's own pages alone give the same answer
        alone = _port(q, flat[li * n_pages:(li + 1) * n_pages], tables,
                      positions)
        np.testing.assert_allclose(got, alone, atol=0, rtol=0)


def test_dead_pages_never_leak_nan():
    """NaN in pages past the live ones (and in masked slots of the live
    page) must not reach the output."""
    n_pages, page, hkv, hd = 8, 4, 2, 64
    pool = np.full((n_pages, page, 2 * hkv * hd), np.nan, np.float32)
    pool[3, :3] = 1.0  # slot 3 of the live page is past the position: NaN
    tables = np.asarray([[3, 5, 6]], np.int32)  # pages 5, 6 are NaN
    positions = np.asarray([2], np.int32)  # only page 3 is live
    q = np.ones((1, hkv, hd), np.float32)
    got = _port(q, pool, tables, positions)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, 1.0, atol=ATOL, rtol=0)
    pool[3, 3] = 1.0  # the JAX kernel reads whole live pages
    np.testing.assert_allclose(got, _jax(q, pool, tables, positions),
                               atol=ATOL, rtol=0)


def _gather_reference(q, pool, tables, positions, window):
    """numpy attention over EVERY table slot <= position (and > position -
    window): the gather path's semantics (kfunca_tpu/models/serve.py
    _paged_block, XLA branch)."""
    bsz, h, hd = q.shape
    hkv = pool.shape[2] // (2 * hd)
    out = np.zeros_like(q, dtype=np.float64)
    for b in range(bsz):
        rows = pool[tables[b]].reshape(-1, 2, hkv, hd).astype(np.float64)
        slots = np.arange(rows.shape[0])
        ok = slots <= positions[b]
        if window is not None:
            ok &= slots > positions[b] - window
        for hh in range(h):
            kvh = hh // (h // hkv)
            s = rows[ok, 0, kvh] @ q[b, hh].astype(np.float64)
            p = np.exp(s - s.max())
            out[b, hh] = (p / p.sum()) @ rows[ok, 1, kvh]
    return out


@pytest.mark.parametrize("window", [None, 7])
def test_position_past_table_admits_every_slot(window):
    """An idle slot inside a decode burst keeps advancing its position
    past the table's width: every table slot is then admitted, as in the
    gather path (the JAX kernel's DMA loop would read past the table)."""
    rng = np.random.default_rng(3)
    hkv, hd, page = 2, 64, 4
    pool = _fused(rng, 12, page, hkv, hd)
    tables = np.asarray([[1, 2, 3], [4, 11, 11]], np.int32)
    positions = np.asarray([3 * page + 5, 5], np.int32)  # first is past
    q = (rng.standard_normal((2, 4, hd)) / hd ** 0.5).astype(np.float32)
    got = _port(q, pool, tables, positions, window=window)
    want = _gather_reference(q, pool, tables, positions, window)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_bf16_rounds_once_from_fp32():
    """bf16 inputs: the plain version computes in fp32 and rounds the
    output once, so it equals the fp32 result on the widened inputs,
    rounded to bf16."""
    q, pool, tables, positions = _case(4, 2)
    qb = torch.from_numpy(q).bfloat16()
    pb = torch.from_numpy(pool).bfloat16()
    t, p = torch.from_numpy(tables), torch.from_numpy(positions)
    got = paged_decode_attention_dma(qb, pb, t, p, window=7)
    assert got.dtype == torch.bfloat16
    want = paged_decode_attention_plain(qb.float(), pb.float(), t, p,
                                        window=7).bfloat16()
    assert torch.equal(got, want)


def test_wrapper_checks_inputs():
    q, pool, tables, positions = (torch.from_numpy(a)
                                  for a in _case(4, 2))
    with pytest.raises(ValueError, match="window"):
        paged_decode_attention_dma(q, pool, tables, positions, window=0)
    with pytest.raises(ValueError, match="fused pool"):
        paged_decode_attention_dma(q, pool[..., None], tables, positions)
    with pytest.raises(ValueError, match="do not hold"):
        paged_decode_attention_dma(q[..., :48], pool, tables, positions)
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention_dma(q, pool, tables.long(), positions)
    with pytest.raises(ValueError, match="positions"):
        paged_decode_attention_dma(q, pool, tables, positions[:2])
    with pytest.raises(ValueError, match="page_base"):
        paged_decode_attention_dma(q, pool, tables, positions, page_base=16)


def test_cpu_tensors_run_the_plain_version_uncounted():
    q, pool, tables, positions = (torch.from_numpy(a)
                                  for a in _case(2, 2))
    before = paged_decode_attention_dma.launches
    got = paged_decode_attention_dma(q, pool, tables, positions)
    want = paged_decode_attention_plain(q, pool, tables, positions)
    assert torch.equal(got, want)
    assert paged_decode_attention_dma.launches == before


# -- int8 KV, split pools and the second entry point ---------------------------


def _split_case(h, hkv, hd=64, layers=1, seed=5):
    """Split 4-D pools (layers*16 pages of 4 slots), their int8 form with
    slot-major scales, tables and positions (the cases of
    tests/test_paged_dma.py), and q."""
    rng = np.random.default_rng(seed)
    n = layers * 16
    pk = rng.standard_normal((n, 4, hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n, 4, hkv, hd)).astype(np.float32)
    qk, sk = (t.numpy() for t in quantize_vecs(torch.from_numpy(pk)))
    qv, sv = (t.numpy() for t in quantize_vecs(torch.from_numpy(pv)))
    tables = np.asarray([[1, 2, 3, 15], [4, 5, 15, 15], [6, 15, 15, 15]],
                        np.int32)
    positions = np.asarray([13, 6, 2], np.int32)
    q = (rng.standard_normal((3, h, hd)) / hd ** 0.5).astype(np.float32)
    return dict(pk=pk, pv=pv, qk=qk, qv=qv, sk=sk, sv=sv, tables=tables,
                positions=positions, q=q)


def _fuse(k, v):
    n, p = k.shape[:2]
    return np.concatenate([k.reshape(n, p, -1), v.reshape(n, p, -1)], axis=2)


def _fuse_scales(sk, sv, fill=0.0):
    """(n_pages, page, Hkv) pair -> the slot-major (n_pages, page, 128)
    rows [sk heads | sv heads | fill]."""
    sc = np.concatenate([sk, sv], axis=2)
    out = np.full(sc.shape[:2] + (128,), fill, np.float32)
    out[..., : sc.shape[2]] = sc
    return out


def _tt(x):
    if isinstance(x, tuple):
        return tuple(_tt(v) for v in x)
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _jj(x):
    if isinstance(x, tuple):
        return tuple(_jj(v) for v in x)
    return None if x is None else jnp.asarray(x)


def _forms(c):
    """{name: (pool, pool_v, scales, head_major)} for every pool form of
    `paged_decode_attention_dma`."""
    flat = lambda a: a.reshape(a.shape[0], a.shape[1], -1)
    hm = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    return {
        "fused fp": (_fuse(c["pk"], c["pv"]), None, None, False),
        "fused int8": (_fuse(c["qk"], c["qv"]), None,
                       _fuse_scales(c["sk"], c["sv"]), False),
        "split fp 4-D": (c["pk"], c["pv"], None, False),
        "split fp flat": (flat(c["pk"]), flat(c["pv"]), None, False),
        "split int8 slot-major": (c["qk"], c["qv"], (c["sk"], c["sv"]),
                                  False),
        "split int8 flat": (flat(c["qk"]), flat(c["qv"]),
                            (c["sk"], c["sv"]), False),
        "split int8 head-major": (c["qk"], c["qv"],
                                  (hm(c["sk"]), hm(c["sv"])), True),
    }


@pytest.mark.parametrize("form", ["fused fp", "fused int8", "split fp 4-D",
                                  "split fp flat", "split int8 slot-major",
                                  "split int8 flat", "split int8 head-major"])
@pytest.mark.parametrize("h,hkv,window", [(2, 2, None), (4, 2, None),
                                          (4, 2, 7)])
def test_every_pool_form_matches_jax_dma_kernel(form, h, hkv, window):
    c = _split_case(h, hkv)
    pool, pool_v, scales, head_major = _forms(c)[form]
    got = paged_decode_attention_dma(
        _tt(c["q"]), _tt(pool), _tt(c["tables"]), _tt(c["positions"]),
        window=window, pool_v=_tt(pool_v), scales=_tt(scales),
        head_major_scales=head_major).numpy()
    want = np.asarray(jax_dma(
        _jj(c["q"]), _jj(pool), _jj(pool_v), _jj(c["tables"]),
        _jj(c["positions"]), window=window, scales=_jj(scales),
        head_major_scales=head_major, depth=2, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # every form holds the same keys and values: one answer per dtype
    base = "fused int8" if "int8" in form else "fused fp"
    pool, pool_v, scales, head_major = _forms(c)[base]
    ref = paged_decode_attention_plain(
        _tt(c["q"]), _tt(pool), _tt(c["tables"]), _tt(c["positions"]),
        window=window, scales=_tt(scales)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("flat", [False, True], ids=["4-D", "flat"])
@pytest.mark.parametrize("h,hkv,window", [(2, 2, None), (4, 2, 7)])
def test_split_pool_entry_point_matches_jax_kernel(quantized, flat, h, hkv,
                                                   window):
    """`paged_decode_attention` against the JAX function of that name in
    interpret mode (its flat 3-D pools need mxu=True there; the port takes
    and ignores fanin and mxu)."""
    c = _split_case(h, hkv)
    pk, pv = (c["qk"], c["qv"]) if quantized else (c["pk"], c["pv"])
    if flat:
        pk, pv = (a.reshape(a.shape[0], a.shape[1], -1) for a in (pk, pv))
    scales = (c["sk"], c["sv"]) if quantized else None
    got = paged_decode_attention(
        _tt(c["q"]), _tt(pk), _tt(pv), _tt(c["tables"]), _tt(c["positions"]),
        window=window, scales=_tt(scales), fanin=2, mxu=flat).numpy()
    want = np.asarray(jax_k6(
        _jj(c["q"]), _jj(pk), _jj(pv), _jj(c["tables"]), _jj(c["positions"]),
        window=window, scales=_jj(scales), mxu=flat,
        fanin=1 if flat else None, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_int8_page_base_reads_stacked_layer(fused):
    layers = 3
    c = _split_case(4, 2, layers=layers, seed=9)
    for li in range(layers):
        base = li * 16
        if fused:
            args = (_fuse(c["qk"], c["qv"]), None,
                    _fuse_scales(c["sk"], c["sv"]))
            got = paged_decode_attention_dma(
                _tt(c["q"]), _tt(args[0]), _tt(c["tables"]),
                _tt(c["positions"]), page_base=base,
                scales=_tt(args[2])).numpy()
            want = np.asarray(jax_dma(
                _jj(c["q"]), _jj(args[0]), None, _jj(c["tables"]),
                _jj(c["positions"]), page_base=base, scales=_jj(args[2]),
                depth=2, interpret=True))
        else:
            scales = (c["sk"], c["sv"])
            got = paged_decode_attention(
                _tt(c["q"]), _tt(c["qk"]), _tt(c["qv"]), _tt(c["tables"]),
                _tt(c["positions"]), page_base=base,
                scales=_tt(scales)).numpy()
            want = np.asarray(jax_k6(
                _jj(c["q"]), _jj(c["qk"]), _jj(c["qv"]), _jj(c["tables"]),
                _jj(c["positions"]), page_base=base, scales=_jj(scales),
                interpret=True))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=li)
        # the layer's own pages alone give the same answer
        sl = slice(base, base + 16)
        alone = paged_decode_attention_plain(
            _tt(c["q"]), _tt(c["qk"][sl]), _tt(c["tables"]),
            _tt(c["positions"]), pool_v=_tt(c["qv"][sl]),
            scales=_tt((c["sk"][sl], c["sv"][sl]))).numpy()
        np.testing.assert_allclose(got, alone, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_dead_scale_rows_never_leak_nan(fused):
    """int8 pools: garbage data and NaN scales in the dead pages, in the
    masked tail of the live page and in the unused lanes of the fused
    scale rows must not reach the output."""
    n_pages, page, hkv, hd = 8, 4, 2, 64
    qk = np.full((n_pages, page, hkv, hd), 77, np.int8)  # garbage
    qv = np.full((n_pages, page, hkv, hd), -99, np.int8)
    sk = np.full((n_pages, page, hkv), np.nan, np.float32)
    sv = np.full((n_pages, page, hkv), np.nan, np.float32)
    qk[3, :3], qv[3, :3] = 10, 20  # the live slots: k = 0.5, v = 2.0
    sk[3, :3], sv[3, :3] = 0.05, 0.1
    tables = np.asarray([[3, 5, 6]], np.int32)
    positions = np.asarray([2], np.int32)  # only slots 0..2 of page 3
    q = np.ones((1, 4, hd), np.float32)
    if fused:
        got = paged_decode_attention_dma(
            _tt(q), _tt(_fuse(qk, qv)), _tt(tables), _tt(positions),
            scales=_tt(_fuse_scales(sk, sv, fill=np.nan)))
    else:
        got = paged_decode_attention(_tt(q), _tt(qk), _tt(qv), _tt(tables),
                                     _tt(positions), scales=_tt((sk, sv)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), 2.0, atol=ATOL, rtol=0)


def test_int8_position_past_table_admits_every_slot():
    c = _split_case(4, 2, seed=3)
    tables = np.asarray([[1, 2, 3], [4, 11, 11], [6, 7, 11]], np.int32)
    positions = np.asarray([3 * 4 + 5, 5, 14], np.int32)  # two are past
    fused = _fuse(c["qk"], c["qv"])
    deq = _fuse(c["qk"] * c["sk"][..., None], c["qv"] * c["sv"][..., None])
    for window in (None, 7):
        got = paged_decode_attention_dma(
            _tt(c["q"]), _tt(fused), _tt(tables), _tt(positions),
            window=window, scales=_tt(_fuse_scales(c["sk"], c["sv"]))).numpy()
        want = _gather_reference(c["q"], deq.astype(np.float32), tables,
                                 positions, window)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_canonical_views_carry_the_kernel_layout():
    """The strides and offsets the CUDA kernel is handed, per pool form."""
    c = _split_case(4, 2)
    hkv, hd, page = 2, 64, 4
    forms = _forms(c)
    k, v, sk, sv = tpa._canonical(_tt(c["q"]), _tt(forms["fused int8"][0]),
                                  None, _tt(forms["fused int8"][2]), False)
    row = 2 * hkv * hd
    assert k.stride() == v.stride() == (page * row, row, hd, 1)
    assert v.storage_offset() - k.storage_offset() == hkv * hd
    assert sk.stride() == sv.stride() == (page * 128, 128, 1)
    assert sv.storage_offset() - sk.storage_offset() == hkv
    for name in ("split int8 slot-major", "split int8 flat"):
        pool, pool_v, scales, _ = forms[name]
        k, v, sk, sv = tpa._canonical(_tt(c["q"]), _tt(pool), _tt(pool_v),
                                      _tt(scales), False)
        assert k.stride() == v.stride() == (page * hkv * hd, hkv * hd, hd, 1)
        assert sk.stride() == sv.stride() == (page * hkv, hkv, 1)
    pool, pool_v, scales, _ = forms["split int8 head-major"]
    _, _, sk, sv = tpa._canonical(_tt(c["q"]), _tt(pool), _tt(pool_v),
                                  _tt(scales), True)
    assert sk.shape == (16, page, hkv)
    assert sk.stride() == sv.stride() == (hkv * page, 1, page)


def test_plain_context_and_counters_on_cpu():
    c = _split_case(4, 2)
    args = (_tt(c["q"]), _tt(c["qk"]), _tt(c["qv"]), _tt(c["tables"]),
            _tt(c["positions"]))
    scales = _tt((c["sk"], c["sv"]))
    before = (paged_decode_attention.launches,
              paged_decode_attention_dma.launches)
    got = paged_decode_attention(*args, scales=scales)
    with tpa.plain_paged_attention():
        again = paged_decode_attention(*args, scales=scales)
    assert torch.equal(got, again)
    assert (paged_decode_attention.launches,
            paged_decode_attention_dma.launches) == before


def test_wrappers_check_pool_forms():
    c = _split_case(4, 2)
    q, tables, pos = _tt(c["q"]), _tt(c["tables"]), _tt(c["positions"])
    qk, qv, sk, sv = (_tt(c[n]) for n in ("qk", "qv", "sk", "sv"))
    with pytest.raises(TypeError, match="int8 pools need scales"):
        paged_decode_attention(q, qk, qv, tables, pos)
    with pytest.raises(TypeError, match="int8 pools need scales"):
        paged_decode_attention(q, _tt(c["pk"]), _tt(c["pv"]), tables, pos,
                               scales=(sk, sv))
    with pytest.raises(ValueError, match="scale pools must be"):
        paged_decode_attention(q, qk, qv, tables, pos,
                               scales=(sk[:, :2], sv[:, :2]))
    with pytest.raises(ValueError, match="fused scale pool"):
        paged_decode_attention_dma(q, _tt(_fuse(c["qk"], c["qv"])), tables,
                                   pos, scales=sk)
    with pytest.raises(ValueError, match="split pools"):
        paged_decode_attention(q, qk, qv[:8], tables, pos, scales=(sk, sv))
    with pytest.raises(ValueError, match="takes split pools"):
        paged_decode_attention(q, qk, None, tables, pos)
    with pytest.raises(TypeError, match="two dtypes"):
        paged_decode_attention(q, _tt(c["pk"]), qv, tables, pos)
    with pytest.raises(TypeError, match="float32"):
        paged_decode_attention(q, qk, qv, tables, pos,
                               scales=(sk.double(), sv.double()))


# -- the kernel's split-sequence design (csrc/paged_attention.cu) -------------
#
# A split pass: a block owns split_pages(page) pages of one (sequence, kv
# head) and up to four query heads; it scores the span's live slots (q
# scaled by log2 e, int8 scores times sk), takes one softmax over the span
# (m, l over the unscaled p; p times sv for int8) and writes (m, l, acc).
# A combine pass merges a sequence's live splits in split order.

LOG2E = 1.4426950408889634


def _live_pages(pos, page, max_pages, window):
    """The kernel's [first_live, n_live) pages of a sequence at pos."""
    end = min(pos // page + 1, max_pages)
    first = max(0, pos - window + 1) // page if window else 0
    return first, end


def _split_span(split, span, pos, page, max_pages, window):
    """Pages [lo, hi) the split block reads (hi <= lo: it returns at once)."""
    first, end = _live_pages(pos, page, max_pages, window)
    return max(split * span, first), min((split + 1) * span, end)


def _live_splits(pos, page, max_pages, window, span):
    """The splits the combine pass merges for a sequence at pos."""
    first, end = _live_pages(pos, page, max_pages, window)
    if first >= end:
        return range(0)
    return range(first // span, (end - 1) // span + 1)


def _k4_emulation(q, pool, tables, positions, window=None, page_base=0,
                  pool_v=None, scales=None, head_major_scales=False,
                  span=None):
    """The two passes in plain torch over the kernel's canonical views."""
    k, v, sk, sv = tpa._canonical(q, pool, pool_v, scales, head_major_scales)
    bsz, h, hd = q.shape
    n_pages, page, hkv, _ = k.shape
    group, max_pages = h // hkv, tables.shape[1]
    span = span or tpa.split_pages(page)
    n_splits = -(-max_pages // span)
    part = {}
    for b in range(bsz):
        pos = int(positions[b])
        for split in range(n_splits):
            lo, hi = _split_span(split, span, pos, page, max_pages, window)
            if lo >= hi:
                continue
            slots = torch.arange(lo * page, hi * page)
            ok = slots <= pos
            if window:
                ok &= slots > pos - window
            pid = (tables[b, slots // page].long() + page_base).clamp(
                0, n_pages - 1)
            within = slots % page
            for kvh in range(hkv):
                # masked slots are zero-filled on load, scales too
                kr = torch.where(ok[:, None], k[pid, within, kvh].float(), 0.0)
                vr = torch.where(ok[:, None], v[pid, within, kvh].float(), 0.0)
                for g in range(group):
                    hh = kvh * group + g
                    s = kr @ (q[b, hh].float() * LOG2E)
                    if sk is not None:
                        s = s * torch.where(ok, sk[pid, within, kvh], 0.0)
                    s = torch.where(ok, s, -torch.inf)
                    m = max(float(s.max()), -1e30)
                    p = torch.exp2(s - m)
                    l = p.sum()
                    if sv is not None:
                        p = p * torch.where(ok, sv[pid, within, kvh], 0.0)
                    part[b, hh, split] = (p @ vr, m, l)
    out = torch.zeros((bsz, h, hd))
    for b in range(bsz):
        live = _live_splits(int(positions[b]), page, max_pages, window, span)
        for hh in range(h):
            mx = max([part[b, hh, s][1] for s in live], default=-1e30)
            acc, l = torch.zeros(hd), torch.zeros(())
            for s in live:  # split order
                a, m, ls = part[b, hh, s]
                w = 2.0 ** (m - mx)
                acc, l = acc + w * a, l + w * ls
            out[b, hh] = acc / (l if l != 0 else 1.0)
    return out.to(q.dtype)


@pytest.mark.parametrize("page", [4, 16])
def test_k4_splits_visit_exactly_the_live_pages(page):
    """Over every position (one past the table too), window and split
    width: the pages the split blocks read are exactly those holding an
    attended slot, each in one block, and the combine merges exactly the
    splits that read a page."""
    for max_pages in (1, 5, 17, 40):
        for span in {tpa.split_pages(page), 1, 3}:
            n_splits = -(-max_pages // span)
            for window in (None, 1, 7, 37, 300):
                for pos in range(0, (max_pages + 2) * page, 3):
                    slot = torch.arange(max_pages * page)
                    att = slot <= pos
                    if window:
                        att &= slot > pos - window
                    want = set((slot[att] // page).tolist())
                    got, merged = [], set()
                    for split in range(n_splits):
                        lo, hi = _split_span(split, span, pos, page,
                                             max_pages, window)
                        got += range(lo, hi)
                        if lo < hi:
                            merged.add(split)
                    assert sorted(got) == sorted(want), (pos, window, span)
                    assert set(_live_splits(pos, page, max_pages, window,
                                            span)) == merged


def _long_case(page, max_pages, positions, layers=1, h=4, hkv=2, hd=64,
               seed=13):
    """_split_case's arrays over a wider table: each sequence owns
    max_pages distinct pages of a layers-deep stacked pool."""
    rng = np.random.default_rng(seed)
    b = len(positions)
    n = layers * (b * max_pages + 1)
    pk = rng.standard_normal((n, page, hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n, page, hkv, hd)).astype(np.float32)
    qk, sk = (t.numpy() for t in quantize_vecs(torch.from_numpy(pk)))
    qv, sv = (t.numpy() for t in quantize_vecs(torch.from_numpy(pv)))
    tables = rng.permutation(b * max_pages).reshape(b, max_pages).astype(
        np.int32)
    q = (rng.standard_normal((b, h, hd)) / hd ** 0.5).astype(np.float32)
    return dict(pk=pk, pv=pv, qk=qk, qv=qv, sk=sk, sv=sv, tables=tables,
                positions=np.asarray(positions, np.int32), q=q,
                base=(layers - 1) * (b * max_pages + 1))


@pytest.mark.parametrize("form", ["fused fp", "fused int8", "split fp 4-D",
                                  "split fp flat", "split int8 slot-major",
                                  "split int8 flat", "split int8 head-major"])
@pytest.mark.parametrize("page,window", [(4, None), (4, 7), (16, 37)])
def test_k4_split_emulation_matches_plain_and_jax(form, page, window):
    """The emulated two passes, at the kernel's split width and at 2 pages
    (several splits a sequence), against the plain version (phase 3's fp32
    limit, 2e-5) and the JAX DMA kernel in interpret mode, on ragged
    positions over a layer-stacked pool read through page_base."""
    max_pages = 24 if page == 4 else 6
    c = _long_case(page, max_pages, [max_pages * page - 1, 50, 7, 0],
                   layers=2)
    pool, pool_v, scales, head_major = _forms(c)[form]
    args = (_tt(c["q"]), _tt(pool), _tt(c["tables"]), _tt(c["positions"]))
    kw = dict(window=window, page_base=c["base"], pool_v=_tt(pool_v),
              scales=_tt(scales), head_major_scales=head_major)
    ref = paged_decode_attention_plain(*args, **kw)
    want = np.asarray(jax_dma(
        _jj(c["q"]), _jj(pool), _jj(pool_v), _jj(c["tables"]),
        _jj(c["positions"]), window=window, scales=_jj(scales),
        head_major_scales=head_major, page_base=c["base"], depth=2,
        interpret=True))
    for span in (None, 2):
        got = _k4_emulation(*args, span=span, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_k4_split_emulation_past_the_table_and_in_bf16(window, quantized):
    """A position past the table admits every table slot (as the plain
    version does; the JAX kernel would read past the table), and bf16 q and
    pools hold phase 3's bf16 limit, 2^-7 |ref| + 1e-6."""
    page, max_pages = 4, 24
    c = _long_case(page, max_pages, [max_pages * page + 5, 70, 3])
    form = "fused int8" if quantized else "split fp 4-D"
    pool, pool_v, scales, _ = _forms(c)[form]
    args = (_tt(c["q"]), _tt(pool), _tt(c["tables"]), _tt(c["positions"]))
    kw = dict(window=window, pool_v=_tt(pool_v), scales=_tt(scales))
    for span in (None, 5):
        np.testing.assert_allclose(
            _k4_emulation(*args, span=span, **kw).numpy(),
            paged_decode_attention_plain(*args, **kw).numpy(), atol=ATOL,
            rtol=0)
    if not quantized:
        qb, pb, pvb = (t.bfloat16() for t in (args[0], args[1], kw["pool_v"]))
        got = _k4_emulation(qb, pb, *args[2:], window=window, pool_v=pvb,
                            span=5).float()
        ref = paged_decode_attention_plain(qb, pb, *args[2:], window=window,
                                           pool_v=pvb).float()
        assert bool(((got - ref).abs() <= ref.abs() * 2.0 ** -7 + 1e-6).all())
