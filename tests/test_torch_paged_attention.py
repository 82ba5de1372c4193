"""Port parity: the paged decode attention of kfunca_tpu_torch.

The port's `paged_decode_attention_dma` runs its plain PyTorch version on
CPU tensors (the CUDA kernel is held against that same plain version on
the card by chip_smoke.py and tests/test_torch_cuda.py).  Here the plain
version is held against the JAX package's Pallas kernel in interpret mode
on the cases of tests/test_paged_dma.py, fp32, atol 2e-5 (the JAX suite's
own tolerance: both take an fp32 softmax, in a different summation
order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kfunca_tpu.ops.pallas_kernels.paged_attention import (
    paged_decode_attention_dma as jax_dma,
)
from kfunca_tpu_torch.ops.pallas_kernels.paged_attention import (
    paged_decode_attention_dma,
    paged_decode_attention_plain,
)

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
