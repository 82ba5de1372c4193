"""The port's CUDA kernels on the card (skipped where there is none).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at small shapes, with the tolerances stated below, and the
serving engine on the card is held against the same engine on the CPU.
This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from kfunca_tpu_torch.models import data, generate, serve, train, transformer
from kfunca_tpu_torch.ops import attention
from kfunca_tpu_torch.ops import quant as tq
from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as fa
from kfunca_tpu_torch.ops.pallas_kernels import paged_attention as pa
from kfunca_tpu_torch.ops.pallas_kernels.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_dma,
    paged_decode_attention_plain,
)

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512, max_seq_len=256, dtype="float32")
# fp32: the same fp32 softmax-weighted mean in another summation order.
# bf16: both round one fp32 result to bf16; a hair's difference can land
# on the neighbouring bf16 value, 2^-8 of the magnitude away.  fp16 the
# same at its step, 2^-10 of the magnitude (2^-9 allowed).
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-6, 2.0 ** -7),
       torch.float16: (1e-6, 2.0 ** -9)}
PAGED_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, dtype, positions, h=8, hkv=2, hd=128, page=16, max_pages=6,
          layers=1, seed=0):
    """Each sequence owns max_pages distinct pages of a layers-deep stacked
    pool; every page is NaN until a live slot of a sequence needs it."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(positions)
    n_pages = b * max_pages + 1
    pool = torch.full((layers * n_pages, page, 2 * hkv * hd), float("nan"),
                      dtype=dtype, device=dev)
    base = (layers - 1) * n_pages
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: b * max_pages].reshape(b, max_pages).int().contiguous()
    for i, p in enumerate(positions):
        live = min(p // page + 1, max_pages)
        rows = tables[i, :live].long() + base
        pool[rows] = torch.randn((live, page, 2 * hkv * hd), generator=gen,
                                 device=dev).to(dtype)
    q = (torch.randn((b, h, hd), generator=gen, device=dev)
         / math.sqrt(hd)).to(dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, pool, tables, pos, base


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("window", [None, 37, 7])
@pytest.mark.parametrize("layers", [1, 3])
def test_kernel_matches_plain(cuda, dtype, window, layers):
    q, pool, tables, pos, base = _case(cuda, dtype, [0, 15, 16, 40, 95],
                                       layers=layers)
    before = paged_decode_attention_dma.launches
    got = paged_decode_attention_dma(q, pool, tables, pos, window=window,
                                     page_base=base)
    torch.cuda.synchronize()
    assert paged_decode_attention_dma.launches == before + 1
    want = paged_decode_attention_plain(q, pool, tables, pos, window=window,
                                        page_base=base)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 7])
def test_position_past_the_table(cuda, window):
    """An idle slot's position runs past the table inside a burst: every
    table slot is admitted, as in the gather path (finite pages: the plain
    version reads the whole table)."""
    q, pool, tables, pos, _ = _case(cuda, torch.float32, [5, 6 * 16 + 9])
    pool = torch.nan_to_num(pool)
    got = paged_decode_attention_dma(q, pool, tables, pos, window=window)
    want = paged_decode_attention_plain(q, pool, tables, pos, window=window)
    _close(got, want, torch.float32)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, pool, tables, pos, _ = _case(cuda, torch.float32, [3, 20])
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        paged_decode_attention_dma(q.double(), pool.double(), tables, pos)
    with pytest.raises(TypeError, match="one dtype"):
        paged_decode_attention_dma(q, pool.bfloat16(), tables, pos)
    with pytest.raises(TypeError, match="one dtype"):
        paged_decode_attention_dma(q.half(), pool.bfloat16(), tables, pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention_dma(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), pool, tables, pos)
    with pytest.raises(ValueError, match="different devices"):
        paged_decode_attention_dma(q, pool, tables.cpu(), pos)
    q, pool, tables, pos, _ = _case(cuda, torch.bfloat16, [3, 20], hd=264)
    with pytest.raises(ValueError, match="limit of 256"):
        paged_decode_attention_dma(q, pool, tables, pos)


def _to(params, dev):
    if isinstance(params, dict):
        return {k: _to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, dev) for v in params]
    return params.to(dev)


def test_server_on_the_card_matches_the_cpu(cuda):
    """fp32 greedy serving through the kernel gives the CPU engine's
    tokens, log-probs within 1e-4, and launches the kernel once per layer
    per decode step."""
    cfg = transformer.TransformerConfig(**SMALL, attention_window=24)
    params = transformer.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (5, 17, 30, 9, 40)]
    kw = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10)
    out = {}
    for dev in ("cpu", "cuda"):
        srv = serve.InferenceServer(_to(params, dev), cfg, device=dev, **kw)
        rids = [srv.submit(pr, max_new=12) for pr in prompts]
        before = paged_decode_attention_dma.launches
        res = srv.run()
        launches = paged_decode_attention_dma.launches - before
        out[dev] = ([res[r] for r in rids],
                    [srv.requests[r].logprobs for r in rids])
        assert srv.pool.available == kw["n_pages"] - 1
        assert launches == (cfg.n_layers * srv.decode_steps
                            if dev == "cuda" else 0)
    assert out["cuda"][0] == out["cpu"][0]
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert max(abs(x - y) for x, y in zip(a, b)) <= 1e-4


@pytest.mark.parametrize("options", [{}, {"fused_pool": False},
                                     {"quantize_kv": True}],
                         ids=["fused", "split", "kv8"])
def test_fp16_server_runs_the_fp16_bodies(cuda, options):
    """fp16 activations and pools on the card: every decode step of every
    layer launches the fp16 body of its entry point, and the tokens are the
    plain path's on the card."""
    cfg = transformer.TransformerConfig(**{**SMALL, "dtype": "float16"})
    params = _to(transformer.init_params(0, cfg, device="cpu"), cuda)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (5, 17, 30)]
    kw = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10,
              **options)
    entry = (paged_decode_attention if options.get("fused_pool") is False
             else paged_decode_attention_dma)
    out = []
    for plain in (False, True):
        srv = serve.InferenceServer(params, cfg, **kw)
        data = srv.pools_k[0] if options.get("quantize_kv") else srv.pools_k
        assert data.dtype == (torch.int8 if options.get("quantize_kv")
                              else torch.float16)
        rids = [srv.submit(pr, max_new=8) for pr in prompts]
        before = entry.launches
        if plain:
            with pa.plain_paged_attention():
                res = srv.run()
            assert entry.launches == before
        else:
            res = srv.run()
            assert entry.launches - before == cfg.n_layers * srv.decode_steps
        out.append([res[r] for r in rids])
    assert out[0] == out[1]


# -- int8 KV (K4-int8), split pools (K6) and the int8 matmul (K5) --------------


def _forms_case(dev, dtype, positions, form, quantized, h=8, hkv=2, hd=128,
                page=16, max_pages=6, layers=2, seed=0):
    """One pool form on the card; dead pages and dead scale rows poisoned.
    Returns (q, pool, pool_v, scales, tables, positions, page_base)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(positions)
    n_pages = b * max_pages + 1
    total, base = layers * n_pages, (layers - 1) * n_pages
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: b * max_pages].reshape(b, max_pages).int().contiguous()
    pools = []
    for _ in range(2):
        if quantized:
            pool = torch.full((total, page, hkv, hd), 85, dtype=torch.int8,
                              device=dev)
        else:
            pool = torch.full((total, page, hkv, hd), float("nan"),
                              dtype=dtype, device=dev)
        for i, p in enumerate(positions):
            live = min(p // page + 1, max_pages)
            rows = tables[i, :live].long() + base
            vals = torch.randn((live, page, hkv, hd), generator=gen,
                               device=dev)
            pool[rows] = ((vals * 40).clamp(-127, 127).to(torch.int8)
                          if quantized else vals.to(dtype))
        pools.append(pool)
    scales = None
    if quantized:
        scales = []
        for _ in range(2):
            sc = torch.full((total, page, hkv), float("nan"), device=dev)
            for i, p in enumerate(positions):
                live = min(p // page + 1, max_pages)
                vals = torch.rand((live, page, hkv), generator=gen,
                                  device=dev) * 0.02 + 0.005
                slot = torch.arange(live * page, device=dev).reshape(live, page)
                vals[slot > p] = float("nan")  # never read
                sc[tables[i, :live].long() + base] = vals
            scales.append(sc)
        scales = tuple(scales)
    k, v = pools
    if form == "fused":
        pool = torch.cat([k.reshape(total, page, -1),
                          v.reshape(total, page, -1)], dim=-1).contiguous()
        pool_v = None
        if quantized:
            rows = torch.full((total, page, 128), float("nan"), device=dev)
            rows[..., :hkv], rows[..., hkv:2 * hkv] = scales
            scales = rows
    else:
        pool, pool_v = k, v
        if form == "split_flat":
            pool, pool_v = k.reshape(total, page, -1), v.reshape(total, page, -1)
        if form == "split_head_major":
            scales = tuple(t.transpose(1, 2).contiguous() for t in scales)
    q = (torch.randn((b, h, hd), generator=gen, device=dev)
         / math.sqrt(hd)).to(dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, pool, pool_v, scales, tables, pos, base


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("form,quantized", [
    ("fused", True), ("split", True), ("split_head_major", True),
    ("split", False), ("split_flat", False)])
def test_dma_kernel_pool_forms_match_plain(cuda, dtype, window, form,
                                           quantized):
    q, pool, pool_v, scales, tables, pos, base = _forms_case(
        cuda, dtype, [0, 15, 16, 40, 95], form, quantized)
    kw = dict(window=window, page_base=base, pool_v=pool_v, scales=scales,
              head_major_scales=form == "split_head_major")
    before = paged_decode_attention_dma.launches
    got = paged_decode_attention_dma(q, pool, tables, pos, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention_dma.launches == before + 1
    _close(got, paged_decode_attention_plain(q, pool, tables, pos, **kw),
           dtype)


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("form", ["split", "split_flat"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_split_pool_kernel_matches_plain(cuda, dtype, window, form, quantized):
    q, pool, pool_v, scales, tables, pos, base = _forms_case(
        cuda, dtype, [3, 31, 32, 95], form, quantized, h=4, hkv=4, hd=64)
    before = (paged_decode_attention.launches,
              paged_decode_attention_dma.launches)
    got = paged_decode_attention(q, pool, pool_v, tables, pos, window=window,
                                 scales=scales, page_base=base, fanin=4)
    torch.cuda.synchronize()
    assert (paged_decode_attention.launches,
            paged_decode_attention_dma.launches) == (before[0] + 1, before[1])
    want = paged_decode_attention_plain(q, pool, tables, pos, window=window,
                                        page_base=base, pool_v=pool_v,
                                        scales=scales)
    _close(got, want, dtype)
    with pa.plain_paged_attention():  # the plain context launches nothing
        again = paged_decode_attention(q, pool, pool_v, tables, pos,
                                       window=window, scales=scales,
                                       page_base=base)
    assert torch.equal(again, want)
    assert paged_decode_attention.launches == before[0] + 1


@pytest.mark.parametrize("dtype", PAGED_DTYPES)
@pytest.mark.parametrize("entry,form,quantized", [
    ("dma", "fused", False), ("dma", "fused", True), ("dma", "split", True),
    ("dma", "split_head_major", True), ("dma", "split_flat", False),
    ("k6", "split", False), ("k6", "split_flat", True)])
def test_paged_kernel_splits_long_sequences_bitwise_repeatably(
        cuda, dtype, entry, form, quantized):
    """Tables of 40 pages of 16 slots: the kernel splits a sequence over
    up to three blocks of 16 pages and merges them in order.  Every pool
    form and dtype against the plain version, with windows inside a split
    and across splits, and two calls give equal bits."""
    q, pool, pool_v, scales, tables, pos, base = _forms_case(
        cuda, dtype, [0, 255, 256, 300, 639, 17], form, quantized,
        max_pages=40)
    fn = (paged_decode_attention_dma if entry == "dma"
          else paged_decode_attention)
    for window in (None, 37, 300):
        if entry == "dma":
            kw = dict(window=window, page_base=base, pool_v=pool_v,
                      scales=scales,
                      head_major_scales=form == "split_head_major")
            a = fn(q, pool, tables, pos, **kw)
            b = fn(q, pool, tables, pos, **kw)
        else:
            kw = dict(window=window, page_base=base, scales=scales)
            a = fn(q, pool, pool_v, tables, pos, **kw)
            b = fn(q, pool, pool_v, tables, pos, **kw)
            kw["pool_v"] = pool_v
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        _close(a, paged_decode_attention_plain(q, pool, tables, pos, **kw),
               dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(16, 2), (10, 2), (3, 1)])
def test_paged_kernel_serves_groups_of_any_width(cuda, dtype, h, hkv):
    """A split block serves up to four query heads of its kv head: groups
    of 8 and 5 take two head blocks (the second one full or with one head),
    a group of 3 one block with a head slot to spare."""
    q, pool, tables, pos, base = _case(cuda, dtype, [0, 300, 17, 639],
                                       h=h, hkv=hkv, max_pages=40, layers=2)
    for window in (None, 37):
        got = paged_decode_attention_dma(q, pool, tables, pos, window=window,
                                         page_base=base)
        want = paged_decode_attention_plain(q, pool, tables, pos,
                                            window=window, page_base=base)
        _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 300])
def test_paged_kernel_past_a_wide_table(cuda, window):
    """An idle slot past a 40-page table, beside sequences of one and
    three splits: every table slot admitted, as in the gather path."""
    q, pool, tables, pos, _ = _case(cuda, torch.bfloat16,
                                    [40 * 16 + 9, 5, 600], max_pages=40)
    pool = torch.nan_to_num(pool)
    got = paged_decode_attention_dma(q, pool, tables, pos, window=window)
    want = paged_decode_attention_plain(q, pool, tables, pos, window=window)
    _close(got, want, torch.bfloat16)


def test_int8_kernel_raises_on_what_it_does_not_take(cuda):
    q, pool, pool_v, scales, tables, pos, _ = _forms_case(
        cuda, torch.float32, [3, 20], "split", True, hd=72)
    with pytest.raises(ValueError, match="head_dim % 16"):  # 16 int8 a load
        paged_decode_attention(q, pool, pool_v, tables, pos, scales=scales)
    q, pool, pool_v, scales, tables, pos, _ = _forms_case(
        cuda, torch.float32, [3, 20], "split", True)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, pool, pool_v, tables, pos, scales=(
            scales[0].transpose(1, 2).contiguous().transpose(1, 2), scales[1]))
    with pytest.raises(ValueError, match="different devices"):
        paged_decode_attention(q, pool, pool_v, tables, pos,
                               scales=(scales[0].cpu(), scales[1]))


@pytest.mark.parametrize("m,k,n", [
    (8, 512, 384), (1, 96, 40), (5, 130, 67), (37, 300, 129), (8, 0, 128),
    (300, 2048, 256), (8, 515, 67), (17, 1023, 130), (1, 77, 3),
    # the decode step's five products at Mistral-7B-v0.1 widths
    (8, 4096, 6144), (8, 4096, 4096), (8, 4096, 14336), (8, 14336, 4096),
    (8, 4096, 32000)])
def test_matmul_q8_kernel_is_bit_equal_to_plain(cuda, m, k, n):
    """fp32 output: the exact integer sum times the same two scales in the
    same order, so the kernel and the plain version agree bit for bit, and
    two launches give the same bits; bf16 output rounds that value once
    more (at most one bf16 step)."""
    gen = torch.Generator(device=cuda).manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda).to(torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda).to(torch.int8)
    sa = torch.rand(m, generator=gen, device=cuda) * 0.02 + 0.001
    sb = torch.rand(n, generator=gen, device=cuda) * 0.02 + 0.001
    before = tq.matmul_q8.launches
    got = tq.matmul_q8(a, b, sa, sb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tq.matmul_q8.launches == before + 1
    want = tq.matmul_q8_plain(a, b, sa, sb, out_dtype=torch.float32)
    assert torch.equal(got, want)
    oracle = ((a.cpu().long() @ b.cpu().long()).float() * sa.cpu()[:, None]) \
        * sb.cpu()[None, :]
    assert torch.equal(got.cpu(), oracle)
    assert torch.equal(tq.matmul_q8(a, b, sa, sb, out_dtype=torch.float32),
                       got)
    got16, want16 = tq.matmul_q8(a, b, sa, sb), tq.matmul_q8_plain(a, b, sa, sb)
    torch.testing.assert_close(got16.float(), want16.float(), atol=0,
                               rtol=2.0 ** -7)
    with tq.plain_matmul_q8():
        assert torch.equal(tq.matmul_q8(a, b, sa, sb, torch.float32), want)
    assert tq.matmul_q8.launches == before + 3


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (8, 14336, 4096),
                                   (5, 130, 67)])
def test_matmul_q8_is_one_kernel_a_product(cuda, m, k, n):
    """Split or not, a product is one launch of one kernel (the last block
    of a tile adds the slices), and every launch leaves the tile tickets
    at zero for the next."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda).to(torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda).to(torch.int8)
    sa, sb = torch.ones(m, device=cuda), torch.ones(n, device=cuda)
    want = tq.matmul_q8(a, b, sa, sb, torch.float32)  # allocates the tickets
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = tq.matmul_q8(a, b, sa, sb, torch.float32)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "q8_stream_kernel" in kernels[0], kernels
    assert torch.equal(got, want)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not tq._tickets[(a.device, stream)].any()


def test_matmul_q8_has_one_engine_and_wrapper_checks(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randint(-127, 128, (8, 256), generator=gen, device=cuda).to(torch.int8)
    b = torch.randint(-127, 128, (256, 64), generator=gen, device=cuda).to(torch.int8)
    sa, sb = torch.ones(8, device=cuda), torch.ones(64, device=cuda)
    want = tq.matmul_q8(a, b, sa, sb, torch.float32)
    before = tq.matmul_q8.launches
    # the JAX package's engine knob does not take CUDA tensors off the kernel
    monkeypatch.setenv("KFUNCA_GEMM_ENGINE", "xla")
    assert torch.equal(tq.matmul_q8_auto(a, b, sa, sb, torch.float32), want)
    assert tq.matmul_q8.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        tq.matmul_q8(a, b.t().contiguous().t(), sa, sb)
    with pytest.raises(ValueError, match="different devices"):
        tq.matmul_q8(a, b, sa.cpu(), sb)


@pytest.mark.parametrize("options", [
    dict(quantize_weights=True), dict(quantize_kv=True),
    dict(quantize_weights=True, quantize_kv=True),
    dict(quantize_weights="int4"), dict(fused_pool=False),
    dict(fused_pool=False, quantize_kv=True)],
    ids=["w8", "kv8", "w8kv8", "w4", "split", "split_kv8"])
def test_server_options_on_the_card_match_the_cpu(cuda, options):
    """Each serving option on the card against the same server on the CPU:
    the same greedy tokens; log-probs within 1e-4 unquantized and 0.05
    quantized (an int8 rounding can land on the other neighbour when the
    two devices sum in another order); each kernel launched as often as the
    option implies."""
    cfg = transformer.TransformerConfig(**SMALL, attention_window=24)
    params = transformer.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (5, 17, 30, 9, 40)]
    kw = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10)
    out = {}
    for dev in ("cpu", "cuda"):
        srv = serve.InferenceServer(_to(params, dev), cfg, device=dev, **kw,
                                    **options)
        rids = [srv.submit(pr, max_new=12) for pr in prompts]
        before = (paged_decode_attention_dma.launches,
                  paged_decode_attention.launches, tq.matmul_q8.launches)
        res = srv.run()
        got = (paged_decode_attention_dma.launches - before[0],
               paged_decode_attention.launches - before[1],
               tq.matmul_q8.launches - before[2])
        out[dev] = ([res[r] for r in rids],
                    [srv.requests[r].logprobs for r in rids])
        assert srv.pool.available == kw["n_pages"] - 1
        attn = cfg.n_layers * srv.decode_steps
        fused = options.get("fused_pool", True)
        q8 = ((5 * cfg.n_layers + 1) * srv.decode_steps
              if options.get("quantize_weights") in (True, "int8") else 0)
        assert got == ((attn if fused else 0, 0 if fused else attn, q8)
                       if dev == "cuda" else (0, 0, 0))
    assert out["cuda"][0] == out["cpu"][0]
    tol = 0.05 if (options.get("quantize_weights")
                   or options.get("quantize_kv")) else 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert max(abs(x - y) for x, y in zip(a, b)) <= tol


def test_server_features_on_the_card_match_the_cpu(cuda):
    """Chunked prefill, logit penalties and bias in bursts of 4, and an
    allowed_fn constraint on the card against the same server on the CPU:
    the same greedy tokens, log-probs within 1e-4 (fp32)."""
    cfg = transformer.TransformerConfig(**SMALL, attention_window=24)
    params = transformer.init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (5, 41, 30, 9)]
    allowed = np.zeros(256, bool)
    allowed[::3] = True
    kw = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10,
              prefill_chunk=16, decode_burst=4)
    out = {}
    for dev in ("cpu", "cuda"):
        srv = serve.InferenceServer(_to(params, dev), cfg, device=dev, **kw)
        rids = [srv.submit(prompts[0], max_new=12),
                srv.submit(prompts[1], max_new=12, repetition_penalty=1.5,
                           presence_penalty=0.5, frequency_penalty=0.25,
                           logit_bias={7: 3.0}),
                srv.submit(prompts[2], max_new=12,
                           allowed_fn=lambda toks, prompt: allowed),
                srv.submit(prompts[3], max_new=12, logit_bias={3: -40.0})]
        res = srv.run()
        out[dev] = ([res[r] for r in rids],
                    [srv.requests[r].logprobs for r in rids])
        assert all(allowed[t] for t in res[rids[2]])
        assert 3 not in res[rids[3]]
    assert out["cuda"][0] == out["cpu"][0]
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert max(abs(x - y) for x, y in zip(a, b)) <= 1e-4


def test_golden_checkpoints_on_the_card(cuda):
    """from_hf reads the committed golden checkpoints onto the card, and
    generate and the server (split pools: K6) give the golden tokens."""
    import json

    from kfunca_tpu_torch.models.hf import from_hf

    fixtures = Path(__file__).parent / "fixtures"
    golden = json.loads((fixtures / "golden_tokens.json").read_text())
    for name, g in golden.items():
        params, cfg = from_hf(fixtures / f"golden_{name}", dtype="float32")
        assert params["embed"].is_cuda
        out = generate.generate(params, torch.tensor([g["prompt"]],
                                                     device=cuda),
                                cfg, max_new=len(g["golden"]))
        assert out[0].tolist() == g["golden"]
        srv = serve.InferenceServer(params, cfg, batch_slots=2, page_size=8,
                                    n_pages=16, max_pages_per_seq=4)
        before = paged_decode_attention.launches
        rid = srv.submit(g["prompt"], max_new=len(g["golden"]))
        assert srv.run()[rid] == g["golden"]
        assert (paged_decode_attention.launches - before
                == cfg.n_layers * srv.decode_steps)


def test_api_server_and_speculative_decoding_on_the_card(cuda):
    """The HTTP front end's engine thread serves a server on the card (its
    current device entered), and greedy speculative decoding on the card
    gives generate's tokens."""
    import json
    import urllib.request

    from kfunca_tpu_torch.models.api_server import ApiServer
    from kfunca_tpu_torch.models.speculative import speculative_generate

    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device=cuda)
    kw = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10)
    prompt = list(range(3, 20))
    srv = serve.InferenceServer(params, cfg, **kw)
    rid = srv.submit(prompt, max_new=10)
    want = srv.run()[rid]
    api = ApiServer(serve.InferenceServer(params, cfg, **kw)).start()
    try:
        req = urllib.request.Request(
            f"http://{api.host}:{api.port}/v1/completions",
            data=json.dumps({"prompt": prompt, "max_tokens": 10}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    finally:
        api.shutdown()
    assert body["choices"][0]["tokens"] == want
    dcfg = transformer.TransformerConfig(**{**SMALL, "n_layers": 1})
    draft = {**params, "blocks": params["blocks"][:1]}
    p = torch.tensor([prompt], device=cuda)
    got, rounds = speculative_generate(params, cfg, draft, dcfg, p, 12, 3)
    assert torch.equal(got, generate.generate(params, p, cfg, 12))
    assert 3 <= rounds <= 12


def test_prefix_cache_and_generate_on_the_card(cuda):
    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device=cuda)
    gen = torch.Generator().manual_seed(4)
    prefix = torch.randint(0, 256, (24,), generator=gen).tolist()
    prompts = [prefix + torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (3, 9, 14)]
    kw = dict(batch_slots=2, page_size=8, n_pages=40, max_pages_per_seq=10)
    toks = {}
    for cache in (True, False):
        srv = serve.InferenceServer(params, cfg, prefix_cache=cache, **kw)
        rids = [srv.submit(p, max_new=8) for p in prompts]
        res = srv.run()
        toks[cache] = [res[r] for r in rids]
        assert (srv.throughput_stats()["prefix_hit_pages"] > 0) == cache
    assert toks[True] == toks[False]
    batch = torch.tensor([p[:27] for p in prompts], device=cuda)
    greedy = generate.generate(params, batch, cfg, 8)
    srv = serve.InferenceServer(params, cfg, **kw)
    rids = [srv.submit(p[:27], max_new=8) for p in prompts]
    res = srv.run()
    assert greedy.tolist() == [res[r] for r in rids]
    beams, scores = generate.beam_search(params, batch, cfg, 8, beam=1)
    assert torch.equal(beams[:, 0], greedy) and scores.is_cuda


# -- flash attention forward (K1) and backward (K2) ---------------------------

# (B, H, Hkv, Sq, Skv, D, window): MHA, ragged tiles, Sq != Skv both ways,
# head dims that need padding, GQA, windows inside and across tiles, and a
# window with Sq > Skv + window, which leaves rows with no valid column
FLASH_CASES = [
    (1, 2, 2, 128, 128, 128, None),
    (1, 1, 1, 35, 67, 40, None),
    (1, 2, 2, 100, 160, 64, None),
    (2, 4, 2, 160, 100, 64, None),
    (1, 6, 3, 200, 200, 128, 37),
    (1, 4, 2, 300, 300, 64, 130),
    (1, 2, 1, 300, 64, 64, 64),
]
# fp32: sums of up to a few hundred fp32 terms in another order, as the
# JAX kernel tests allow (1e-4).  bf16: both routes compute in fp32 from the
# same bf16 inputs and round once, so `out` agrees to one bf16 step of the
# element (2^-8 relative).  The gradients agree less closely: K2 takes
# delta = rowsum(dO * out) from the SAVED bf16 `out` (each element off by up
# to 2^-9 of itself, ~0.02 on a row's delta), while the plain version
# differentiates the unrounded fp32 forward; that moves dS, and with it
# every gradient element, by a few bf16 steps of the tensor's largest
# values: 2^-7 of max |ref|.
def _flash_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(
            got, ref, atol=2.0 ** -7 * float(ref.abs().max()), rtol=2.0 ** -7)


def _flash_inputs(dev, dtype, case, seed=0):
    b, h, hkv, sq, skv, d, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    return mk(b, h, sq, d), mk(b, hkv, skv, d), mk(b, hkv, skv, d), mk(b, h, sq, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, case):
    window = case[-1]
    q, k, v, g = _flash_inputs(cuda, dtype, case)
    n1, n2 = (fa.flash_attention_fwd_stats.launches,
              fa.flash_attention_backward.launches)
    n1w = fa.flash_attention_fwd_stats.launches_wgmma
    n2w = fa.flash_attention_backward.launches_wgmma
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse,
                                             window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_stats.launches == n1 + 1
    assert fa.flash_attention_backward.launches == n2 + 1
    # every head dim here is at most 128: bf16 takes the bf16 wgmma bodies,
    # fp32 the split-TF32 ones
    assert fa.flash_attention_fwd_stats.launches_wgmma == n1w + 1
    assert fa.flash_attention_backward.launches_wgmma == n2w + 1
    want_out, want_lse = fa.flash_attention_plain(q, k, v, window)
    want = fa.flash_attention_backward_plain(q, k, v, g, window)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _flash_close(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _flash_close(got, ref, dtype)
    no_stats, none = fa.flash_attention_fwd_stats(q, k, v, save_stats=False,
                                                  window=window)
    assert none is None and torch.equal(no_stats, out)


# every built bf16 tile at both head dims, on cases with ragged tiles, GQA,
# windows and rows without a column
TILE_CASES = [FLASH_CASES[1], FLASH_CASES[3], FLASH_CASES[4], FLASH_CASES[5],
              FLASH_CASES[6], (1, 4, 2, 333, 333, 128, None)]


@pytest.mark.parametrize("tile", range(len(fa.FWD_TILES)))
def test_every_forward_tile_matches_plain(cuda, tile):
    for case in TILE_CASES:
        if fa.FWD_TILES[tile] not in fa.fwd_tiles(case[5]):
            continue  # a tile built for head dims up to 64
        q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, case)
        window = case[-1]
        out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window,
                                                **fa.FWD_TILES[tile])
        again = fa.flash_attention_fwd_stats(q, k, v, window=window,
                                             **fa.FWD_TILES[tile])
        torch.cuda.synchronize()
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        want_out, want_lse = fa.flash_attention_plain(q, k, v, window)
        _flash_close(out, want_out, torch.bfloat16)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("tile", range(len(fa.BWD_TILES)))
def test_every_backward_tile_matches_plain(cuda, tile):
    for case in TILE_CASES:
        q, k, v, g = _flash_inputs(cuda, torch.bfloat16, case)
        window = case[-1]
        out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
        got = fa.flash_attention_backward(q, k, v, g, out, lse, window=window,
                                          **fa.BWD_TILES[tile])
        again = fa.flash_attention_backward(q, k, v, g, out, lse,
                                            window=window,
                                            **fa.BWD_TILES[tile])
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        want = fa.flash_attention_backward_plain(q, k, v, g, window)
        for x, ref in zip(got, want):
            assert torch.isfinite(x).all()
            _flash_close(x, ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rows_without_a_column_and_unread_kv_rows(cuda, dtype):
    """Window 64 with Sq 300 over Skv 64: rows >= 127 see no column and get
    out = 0, lse = 0 and dq = 0.  Skv 160 over Sq 100: kv rows >= 100 are
    read by no q row and get exact-zero dk/dv."""
    q, k, v, g = _flash_inputs(cuda, dtype, (1, 2, 1, 300, 64, 64, 64))
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=64)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse, window=64)
    assert not out[:, :, 127:].any() and not lse[:, :, 127:].any()
    assert not dq[:, :, 127:].any() and out[:, :, :127].abs().min() > 0
    q, k, v, g = _flash_inputs(cuda, dtype, (1, 2, 2, 100, 160, 64, 0))
    out, lse = fa.flash_attention_fwd_stats(q, k, v)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse)
    assert not dk[:, :, 100:].any() and not dv[:, :, 100:].any()
    assert dk[:, :, :100].abs().min() > 0


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_backward_is_bitwise_repeatable(cuda, hd):
    """Two runs of the bf16 (wgmma) body give equal bits: each output
    element is summed by one block in a fixed order, no atomics."""
    q, k, v, g = _flash_inputs(cuda, torch.bfloat16, (1, 8, 2, 512, 512, hd, 200))
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=200)
    n = fa.flash_attention_backward.launches_wgmma
    a = fa.flash_attention_backward(q, k, v, g, out, lse, window=200)
    b = fa.flash_attention_backward(q, k, v, g, out, lse, window=200)
    assert fa.flash_attention_backward.launches_wgmma == n + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_forward_is_bitwise_repeatable(cuda, hd):
    """Two runs of the bf16 (wgmma) forward give equal bits, out and lse:
    each row is computed by one consumer over its tiles in order."""
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16,
                               (2, 8, 2, 700, 700, hd, 200))
    n = fa.flash_attention_fwd_stats.launches_wgmma
    a = fa.flash_attention_fwd_stats(q, k, v, window=200)
    b = fa.flash_attention_fwd_stats(q, k, v, window=200)
    assert fa.flash_attention_fwd_stats.launches_wgmma == n + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want_out, want_lse = fa.flash_attention_plain(q, k, v, 200)
    _flash_close(a[0], want_out, torch.bfloat16)
    torch.testing.assert_close(a[1], want_lse, atol=1e-4, rtol=1e-5)


def test_flash_autograd_takes_transposed_views_and_fp16(cuda):
    """q, k, v as the model hands them over (transposed views of one fused
    projection), through make_flash_attention and autograd."""
    cfg = transformer.TransformerConfig(**SMALL)
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((2, 96, cfg.qkv_out), generator=gen, device=cuda,
                      requires_grad=True)
    fn = attention.make_flash_attention(24)
    out = fn(*transformer.split_qkv(qkv, cfg))
    (grad,) = torch.autograd.grad(out.square().sum(), qkv)
    with attention.plain_attention():
        ref = fn(*transformer.split_qkv(qkv, cfg))
        (gref,) = torch.autograd.grad(ref.square().sum(), qkv)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(grad, gref, atol=1e-4, rtol=1e-4)
    q, k, v, _ = _flash_inputs(cuda, torch.float16, (1, 2, 2, 64, 64, 64, 0))
    half = attention.causal_attention_fn(q, k, v)
    assert half.dtype == torch.float16
    torch.testing.assert_close(
        half.float(), fa.flash_attention_plain(q.float(), k.float(),
                                               v.float())[0],
        atol=1e-3, rtol=1e-3)


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, g = _flash_inputs(cuda, torch.float32, (1, 2, 2, 16, 16, 64, 0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd_stats(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_fwd_stats(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="limit of 256"):
        big = torch.zeros((1, 1, 8, 257), device=cuda)
        fa.flash_attention_fwd_stats(big, big, big)
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention_fwd_stats(q, k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd_stats(q, k, v, window=0)


# -- K1 and K2 on fp32: the split-TF32 wgmma bodies at head dims 64 and
# 128, the fp32 tile at 256 ----------------------------------------------------

FP32_CASES = [
    (1, 8, 2, 512, 512, 64, 100),
    (1, 6, 3, 200, 200, 128, 37),
    (1, 2, 1, 300, 64, 128, 64),
    (2, 4, 2, 160, 100, 128, None),
    (1, 4, 2, 256, 256, 256, None),
]


@pytest.mark.parametrize("case", FP32_CASES, ids=str)
def test_flash_fp32_bodies_match_plain_bitwise_repeatably(cuda, case):
    """fp32 K1 / K2 on the body `route` names (one launch each, counted),
    within the fp32 tolerance of the plain versions, rows without a column
    at zero, and a second run of each bit for bit."""
    window, hd = case[-1], case[5]
    body = fa.route(torch.float32, hd)
    counter = "launches_fp32_tile" if body == "fp32_tile" else "launches_wgmma"
    q, k, v, g = _flash_inputs(cuda, torch.float32, case, seed=4)
    n1 = getattr(fa.flash_attention_fwd_stats, counter)
    n2 = getattr(fa.flash_attention_backward, counter)
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
    grads = fa.flash_attention_backward(q, k, v, g, out, lse, window=window)
    torch.cuda.synchronize()
    assert getattr(fa.flash_attention_fwd_stats, counter) == n1 + 1
    assert getattr(fa.flash_attention_backward, counter) == n2 + 1
    assert body == ("split_tf32" if hd <= 128 else "fp32_tile")
    again = fa.flash_attention_fwd_stats(q, k, v, window=window)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert all(torch.equal(x, y) for x, y in zip(
        grads, fa.flash_attention_backward(q, k, v, g, out, lse,
                                           window=window)))
    want_out, want_lse = fa.flash_attention_plain(q, k, v, window)
    _flash_close(out, want_out, torch.float32)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, ref in zip(grads, fa.flash_attention_backward_plain(q, k, v, g,
                                                                 window)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        _flash_close(got, ref, torch.float32)
    if window and case[3] > case[4] + window - 1:  # rows with no column
        dead = case[4] + window - 1
        assert not out[:, :, dead:].any() and not lse[:, :, dead:].any()
        assert not grads[0][:, :, dead:].any()


def _attention64(q, k, v, g, window):
    """(out, lse, dq, dk, dv) of K1 / K2's function in float64."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    group = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(group, dim=1) for t in (k, v))
    row = torch.arange(q.shape[2], device=q.device)[:, None]
    col = torch.arange(k.shape[2], device=q.device)[None, :]
    ok = (col <= row) if window is None else (col <= row) & (col > row - window)
    scale = 1.0 / math.sqrt(q.shape[3])
    s = torch.where(ok, q @ kr.transpose(-1, -2) * scale, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = p @ vr
    ds = p * (g @ vr.transpose(-1, -2) - (g * out).sum(-1, keepdim=True))
    fold = lambda t: t.unflatten(1, (k.shape[1], group)).sum(2)
    return (out, lse, ds @ kr * scale, fold(ds.transpose(-1, -2) @ q) * scale,
            fold(p.transpose(-1, -2) @ g))


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_fp32_holds_fp32_accuracy(cuda, hd):
    """The accuracy gate of chip_smoke.py's phase 93 at a small shape: each
    of out, lse, dq, dk and dv within 1/64 of the error the plain version
    makes with TF32 products, both against float64 (one TF32 pass would
    not pass)."""
    case = (1, 4, 2, 512, 512, hd, None)
    q, k, v, g = _flash_inputs(cuda, torch.float32, case, seed=5)
    ref = _attention64(q, k, v, g, None)
    out, lse = fa.flash_attention_fwd_stats(q, k, v)
    got = (out, lse, *fa.flash_attention_backward(q, k, v, g, out, lse))
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = (*fa.flash_attention_plain(q, k, v),
                *fa.flash_attention_backward_plain(q, k, v, g))
    finally:
        torch.set_float32_matmul_precision(precision)
    for name, x, y, r in zip(("out", "lse", "dq", "dk", "dv"), got, tf32,
                             ref):
        e = float((x.double() - r).abs().max())
        e_tf32 = float((y.double() - r).abs().max())
        assert e <= e_tf32 / 64, (name, e, e_tf32)


# -- K1 and K2 at head dim 256 (129-256 padded): Gemma's MQA 8:1, GQA 4:2
# with a window and Sq != Skv both ways, rows without a column ------------

FLASH_CASES_256 = [
    (1, 8, 1, 256, 256, 256, None),
    (1, 4, 2, 200, 150, 160, 37),
    (2, 4, 2, 160, 260, 200, None),
    (1, 2, 1, 300, 64, 256, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES_256, ids=str)
def test_flash_kernels_match_plain_at_head_dim_256(cuda, dtype, case):
    """The hd-256 instances (the wgmma bodies' on bf16, the fp32 tile's with
    its shared streamed tile) against the plain versions, on the kernels:
    one launch each, bf16 on the wgmma bodies."""
    window = case[-1]
    q, k, v, g = _flash_inputs(cuda, dtype, case)
    n1w = fa.flash_attention_fwd_stats.launches_wgmma
    n1t = fa.flash_attention_fwd_stats.launches_fp32_tile
    n2 = fa.flash_attention_backward.launches
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse,
                                             window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n2 + 1
    assert fa.flash_attention_fwd_stats.launches_wgmma == (
        n1w + (dtype == torch.bfloat16))
    assert fa.flash_attention_fwd_stats.launches_fp32_tile == (
        n1t + (dtype == torch.float32))
    want_out, want_lse = fa.flash_attention_plain(q, k, v, window)
    want = fa.flash_attention_backward_plain(q, k, v, g, window)
    _flash_close(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got).all()
        _flash_close(got, ref, dtype)


@pytest.mark.parametrize("kind,tile", [("fwd", i) for i in range(
    len(fa.FWD_TILES_256))] + [("bwd", i) for i in range(
        len(fa.BWD_TILES_256))])
def test_every_hd256_tile_matches_plain_bitwise_repeatably(cuda, kind, tile):
    for case in FLASH_CASES_256:
        q, k, v, g = _flash_inputs(cuda, torch.bfloat16, case, seed=1)
        window = case[-1]
        if kind == "fwd":
            params = fa.FWD_TILES_256[tile]
            got = fa.flash_attention_fwd_stats(q, k, v, window=window,
                                               **params)
            again = fa.flash_attention_fwd_stats(q, k, v, window=window,
                                                 **params)
            want = fa.flash_attention_plain(q, k, v, window)
            _flash_close(got[0], want[0], torch.bfloat16)
            torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
        else:
            params = fa.BWD_TILES_256[tile]
            out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
            got = fa.flash_attention_backward(q, k, v, g, out, lse,
                                              window=window, **params)
            again = fa.flash_attention_backward(q, k, v, g, out, lse,
                                                window=window, **params)
            want = fa.flash_attention_backward_plain(q, k, v, g, window)
            for x, ref in zip(got, want):
                _flash_close(x, ref, torch.bfloat16)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_dma_kernel_at_gemma_decode_width(cuda, dtype, quantized):
    """K4 and K4-int8 at head dim 256 over one kv head (Gemma's MQA: a
    fused page row of 2 x 256), no window and window 37, bitwise
    repeatable."""
    q, pool, pool_v, scales, tables, pos, base = _forms_case(
        cuda, dtype, [0, 15, 16, 40, 95], "fused", quantized, h=8, hkv=1,
        hd=256)
    for window in (None, 37):
        kw = dict(window=window, page_base=base, pool_v=pool_v,
                  scales=scales)
        got = paged_decode_attention_dma(q, pool, tables, pos, **kw)
        again = paged_decode_attention_dma(q, pool, tables, pos, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close(got, paged_decode_attention_plain(q, pool, tables, pos, **kw),
               dtype)


def test_head_dim_257_raises_head_dim_error(cuda):
    """Above 256 (wgmma's largest N) K1, K2, K12 and K12b raise the named
    error on the card; the plain versions take any head dim."""
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh

    q = torch.zeros((1, 2, 16, 257), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(fa.HeadDimError, match="limit of 256"):
        fa.flash_attention_fwd_stats(q, q, q)
    lse = torch.zeros((1, 2, 16), device=cuda)
    with pytest.raises(fa.HeadDimError, match="limit of 256"):
        fa.flash_attention_backward(q, q, q, q, q, lse)
    carry = rh.hop_carry_init(1, 2, 16, 257, device=cuda)
    with pytest.raises(fa.HeadDimError, match="limit of 256"):
        rh.flash_attention_hop(q, q, q, *carry, 0, 0)
    stats = (lse.reshape(2, 16), lse.reshape(2, 16))
    accs = rh.bwd_carry_init(1, 2, 16, 16, 257, device=cuda)
    with pytest.raises(fa.HeadDimError, match="limit of 256"):
        rh.flash_attention_bwd_hop(q, q, q, q, *stats, *accs, 0, 0)


# -- the training step on the card -------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"remat": True}, {"dtype": "bfloat16"},
    {"n_kv_heads": 4, "attention_window": None}])
def test_train_step_on_the_card_matches_the_cpu(cuda, kw):
    """Two AdamW steps from the same params on the CPU (plain attention)
    and on the card (K1/K2): the losses agree, fp32 to 1e-4 and bf16
    activations to 0.05 (bf16 rounds at other places in the two matmul
    routes), and the card launches K1 and K2 once a layer a step, remat's
    recomputed forward included."""
    cfg = transformer.TransformerConfig(**{**SMALL, "attention_window": 24,
                                           **kw})
    oc = train.OptConfig(lr=1e-3, clip_norm=1.0)
    rng = np.random.default_rng(0)
    window = rng.integers(0, 256, (2, 2, 65)).astype(np.int32)
    losses = {}
    for dev in ("cpu", "cuda"):
        params = _to(transformer.init_params(0, cfg, device="cpu"), dev)
        opt = train.init_opt_state(params, oc, device=dev)
        step = train.make_train_step(cfg, oc, device=dev)
        n1, n2 = (fa.flash_attention_fwd_stats.launches,
                  fa.flash_attention_backward.launches)
        out = []
        for w in window:
            params, opt, loss = step(params, opt, w[:, :-1], w[:, 1:])
            out.append(float(loss))
        losses[dev] = out
        fwd = fa.flash_attention_fwd_stats.launches - n1
        bwd = fa.flash_attention_backward.launches - n2
        per_step = 2 if cfg.remat else 1  # remat runs the forward again
        assert (fwd, bwd) == ((cfg.n_layers * 2 * per_step, cfg.n_layers * 2)
                              if dev == "cuda" else (0, 0))
    tol = 1e-4 if cfg.dtype == "float32" else 0.05
    assert losses["cuda"] == pytest.approx(losses["cpu"], abs=tol)
    assert losses["cuda"][1] != losses["cuda"][0]  # the update took hold


def test_prefetcher_stages_batches_on_the_card(cuda):
    corpus = (np.arange(5000) % 251).astype(np.int32)
    ds = data.TokenDataset(corpus, 32, 4, seed=1)
    twin = data.TokenDataset(corpus, 32, 4, seed=1)
    assert ds.device.type == "cuda"
    pf = data.Prefetcher(ds)
    try:
        for _ in range(4):
            tokens, targets = pf.next()
            want = twin.sample_batch()
            assert tokens.is_cuda and tokens.dtype == torch.int32
            torch.cuda.synchronize()
            np.testing.assert_array_equal(tokens.cpu().numpy(), want[0])
            np.testing.assert_array_equal(targets.cpu().numpy(), want[1])
    finally:
        pf.close()


# -- the eager Tensor API's kernels: K3, K7, K8, K9 -----------------------------


def _eager_kernels():
    from kfunca_tpu_torch.ops.pallas_kernels import (
        elementwise, matmul, reduce, welford)
    return elementwise, matmul, reduce, welford


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16,
                                   torch.int32, torch.int64])
def test_elementwise_kernel_matches_plain(cuda, dtype):
    """K9: exact against its plain version (exp within 1 ulp of its type:
    the same expf rounds once more into a 16-bit type), integer division
    with XLA's x / 0 = -1 and INT_MIN / -1 = INT_MIN."""
    ew = _eager_kernels()[0]
    gen = torch.Generator(device=cuda).manual_seed(21)
    if dtype.is_floating_point:
        a = torch.randn((33, 71), generator=gen, device=cuda).to(dtype)
        b = (torch.rand((33, 71), generator=gen, device=cuda) + 0.5).to(dtype)
        acc = torch.float32
        ops = ew.OPS
    else:
        a = torch.randint(-50, 50, (33, 71), generator=gen, device=cuda, dtype=dtype)
        b = torch.randint(-3, 4, (33, 71), generator=gen, device=cuda, dtype=dtype)
        a[0, 0], b[0, 0] = torch.iinfo(dtype).min, -1
        acc = torch.int64
        ops = ("add", "sub", "mul", "div", "copy", "neg", "abs")
    for op in ops:
        args = (a, b) if op in ("add", "sub", "mul", "div") else (a,)
        before = ew.elementwise.launches
        got = ew.elementwise(op, *args, acc_dt=acc, out_dt=dtype)
        torch.cuda.synchronize()
        assert ew.elementwise.launches == before + 1
        want = ew.elementwise_plain(op, *args, acc_dt=acc, out_dt=dtype)
        if op == "exp":
            tol = torch.finfo(dtype).eps * want.double().abs()
            assert bool(((got.double() - want.double()).abs() <= tol).all())
        else:
            assert torch.equal(got, want), op


@pytest.mark.parametrize("shape", [(1, 1), (300, 70), (1000, 333)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_kernels_match_plain(cuda, shape, dtype):
    """K8 (sum, mean, max) and K7 (fp32) against their plain versions:
    fp32 sums in other orders within 1e-5 of the column's sum of |x|
    (bf16 out: plus one bf16 step); max exact."""
    _, _, rd, wf = _eager_kernels()
    gen = torch.Generator(device=cuda).manual_seed(22)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 1).to(dtype)
    mass = x.float().abs().sum(0, keepdim=True).double()
    for op in ("sum", "mean", "max"):
        got, want = rd.reduce_2d(x, op), rd.reduce_2d_plain(x, op)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        if op == "max":
            assert torch.equal(got, want)
            continue
        tol = 1e-5 * mass * (1.0 if op == "sum" else 1.0 / shape[0])
        if dtype != torch.float32:
            tol = tol + want.double().abs() * 2.0 ** -8
        assert bool((err <= tol).all()), (op, err.max().item())
    if dtype == torch.float32:
        m, s = wf.welford_norm_stat(x)
        pm, ps = wf.welford_norm_stat_plain(x)
        torch.cuda.synchronize()
        assert (m - pm).abs().max().item() <= 1e-5 * x.abs().mean().item()
        assert ((s - ps).abs() / ps).max().item() <= 1e-4


@pytest.mark.parametrize("shape", [
    (1, 4096), (5, 1), (31, 16387), (1000, 333), (16387, 16387),
    (1041, 16387),  # S = 65 splits of 17 rows: 62-64 hold none, 61 four
    (17, 4096),     # S = 2 splits of 9 rows, each shorter than a chunk
], ids=str)
def test_welford_kernel_matches_plain_and_repeats(cuda, shape):
    """K7's split-row kernel against its plain (two-pass) version: mean
    within 1e-5 of mean |x|, invstd within 1e-4 relative (Welford against
    two passes, fp32 in other orders); two calls bitwise equal (the splits
    come from the shape and merge in a fixed order)."""
    _, _, _, wf = _eager_kernels()
    gen = torch.Generator(device=cuda).manual_seed(shape[0] + shape[1])
    x = torch.randn(shape, generator=gen, device=cuda) * 3.0 + 1.0
    before = wf.welford_norm_stat.launches
    m, s = wf.welford_norm_stat(x)
    m2, s2 = wf.welford_norm_stat(x)
    pm, ps = wf.welford_norm_stat_plain(x)
    torch.cuda.synchronize()
    assert wf.welford_norm_stat.launches == before + 2
    assert (m - pm).abs().max().item() <= 1e-5 * x.abs().mean().item()
    assert ((s - ps).abs() / ps).max().item() <= 1e-4
    assert torch.equal(m, m2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("offset,n", [(0, 4096 * 33 + 5), (1, 4096 * 33 + 5),
                                      (0, 3), (8, 1000)], ids=str)
def test_elementwise_vector_body_matches_plain(cuda, dtype, offset, n):
    """K9's vector body (same dtype, 16-byte aligned) and the generic body
    it gives way to at an odd element offset: exact against the plain
    version, exp within 1 ulp; numels that leave a scalar tail and fall
    short of one vector; each launch counted in its body's count."""
    ew = _eager_kernels()[0]
    gen = torch.Generator(device=cuda).manual_seed(31)
    a = torch.randn(n + offset, generator=gen, device=cuda).to(dtype)[offset:]
    b = (torch.rand(n + offset, generator=gen, device=cuda) + 0.5).to(dtype)[offset:]
    for op in ("add", "sub", "mul", "div", "neg", "abs", "exp"):
        args = (a, b) if op in ("add", "sub", "mul", "div") else (a,)
        body = ew.route(op, tuple(x.dtype for x in args), dtype, 0,
                        (a.data_ptr(), b.data_ptr(), 0))
        assert body == ("vector" if a.data_ptr() % 16 == 0 else "generic")
        before = (ew.elementwise.launches, ew.elementwise.launches_vector)
        got = ew.elementwise(op, *args, acc_dt=torch.float32, out_dt=dtype)
        torch.cuda.synchronize()
        assert (ew.elementwise.launches - before[0],
                ew.elementwise.launches_vector - before[1]) == (1, int(body == "vector"))
        want = ew.elementwise_plain(op, *args, acc_dt=torch.float32, out_dt=dtype)
        if op == "exp":
            tol = torch.finfo(dtype).eps * want.double().abs()
            assert bool(((got.double() - want.double()).abs() <= tol).all())
        else:
            assert torch.equal(got, want), (op, body)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_elementwise_vector_body_writes_an_operand_in_place(cuda, dtype):
    """out=a on the vector body (the `+=` of the eager API): each element is
    read before it is written, by one thread, so the result is the plain
    version's; the same for out=b."""
    ew = _eager_kernels()[0]
    gen = torch.Generator(device=cuda).manual_seed(32)
    n = 1 << 20
    a = torch.randn(n + 3, generator=gen, device=cuda).to(dtype)
    b = torch.randn(n + 3, generator=gen, device=cuda).to(dtype)
    want_a = ew.elementwise_plain("add", a, b, acc_dt=torch.float32, out_dt=dtype)
    want_b = ew.elementwise_plain("div", a, b, acc_dt=torch.float32, out_dt=dtype)
    before = ew.elementwise.launches_vector
    b_copy = b.clone()
    got = ew.elementwise("div", a, b, acc_dt=torch.float32, out_dt=dtype, out=b)
    assert got is b
    ew.elementwise("add", a, b_copy, acc_dt=torch.float32, out_dt=dtype, out=a)
    torch.cuda.synchronize()
    assert ew.elementwise.launches_vector == before + 2
    assert torch.equal(b, want_b) and torch.equal(a, want_a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16,
                                   torch.float16, torch.int64, torch.int32,
                                   torch.int16, torch.int8, torch.uint8, torch.bool],
                         ids=str)
def test_elementwise_byte_copy_is_bitwise(cuda, dtype):
    """K9's same-dtype copy is a byte copy: bitwise the plain version, NaN
    payloads included, at every offset pair of the source and the target
    (16, 8, 4, 2 and 1 byte widths), counted in launches_copy."""
    ew = _eager_kernels()[0]
    n = 4099
    size = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=cuda).manual_seed(33)
    raw = torch.randint(0, 256, ((n + 16) * size,), generator=gen, device=cuda,
                        dtype=torch.uint8)
    src_all = raw.view(dtype) if dtype != torch.bool else raw % 2 == 1
    for src_off, dst_off in ((0, 0), (1, 0), (0, 3), (2, 6), (5, 1)):
        src = src_all[src_off:src_off + n]
        dst_all = torch.zeros(n + 16, dtype=dtype, device=cuda)
        dst = dst_all[dst_off:dst_off + n]
        before = (ew.elementwise.launches, ew.elementwise.launches_copy)
        got = ew.elementwise("copy", src, acc_dt=dtype, out_dt=dtype, out=dst)
        fresh = ew.elementwise("copy", src, acc_dt=dtype, out_dt=dtype)
        torch.cuda.synchronize()
        assert (ew.elementwise.launches - before[0],
                ew.elementwise.launches_copy - before[1]) == (2, 2)
        want = ew.elementwise_plain("copy", src, acc_dt=dtype, out_dt=dtype)
        as_bytes = (lambda t: t.view(torch.uint8)) if dtype != torch.bool else \
            (lambda t: t.to(torch.uint8))
        assert got is dst and torch.equal(as_bytes(got), as_bytes(want))
        assert torch.equal(as_bytes(fresh), as_bytes(want))
        assert not dst_all[:dst_off].any() and not dst_all[dst_off + n:].any()


@pytest.mark.parametrize("shape,dtype", [
    ((16387, 16387), torch.float32), ((4096, 4096), torch.bfloat16),
    ((1000, 333), torch.float32), ((1000, 333), torch.float16),
    ((1041, 16387), torch.float32),  # S = 65 splits of 17 rows: 62-64 empty
    ((17, 4096), torch.bfloat16), ((3, 70000), torch.float16),
], ids=str)
def test_reduce_split_kernel_matches_plain_and_repeats(cuda, shape, dtype):
    """K8's split-row kernel at the phase-21 shapes, 16-bit pairs and single
    columns, empty splits: within 1e-5 of the column's sum of |x| (16-bit
    out: plus one step), max exact, two calls bitwise equal, one launch
    counted per call."""
    _, _, rd, _ = _eager_kernels()
    gen = torch.Generator(device=cuda).manual_seed(shape[0] + shape[1])
    x = (torch.randn(shape, generator=gen, device=cuda) * 2.0 + 0.5).to(dtype)
    mass = x.float().abs().sum(0, keepdim=True).double()
    for op in ("sum", "mean", "max"):
        before = rd.reduce_2d.launches
        got, again = rd.reduce_2d(x, op), rd.reduce_2d(x, op)
        want = rd.reduce_2d_plain(x, op)
        torch.cuda.synchronize()
        assert rd.reduce_2d.launches == before + 2
        assert torch.equal(got, again)
        if op == "max":
            assert torch.equal(got, want)
            continue
        err = (got.double() - want.double()).abs()
        tol = 1e-5 * mass * (1.0 if op == "sum" else 1.0 / shape[0])
        if dtype != torch.float32:
            tol = tol + want.double().abs() * 2.0 ** -8
        assert bool((err <= tol).all()), (op, err.max().item())
    del x


def test_reduce_split_kernel_max_keeps_nan_and_its_floor(cuda):
    """max through both passes: a NaN in any split sticks, a column of -inf
    ends at -3.4e38, an odd-offset 16-bit view reads one column a thread."""
    _, _, rd, _ = _eager_kernels()
    x = torch.full((5000, 4098), -float("inf"), device=cuda)
    x[4321, 7] = float("nan")
    x[:, 8:] = torch.randn((5000, 4090), device=cuda)
    odd = x.half().flatten()[1:1 + 4999 * 4098].reshape(4999, 4098)  # 2-byte offset
    assert not rd.pairs(odd) and rd.pairs(x.bfloat16())
    for t in (x, x.bfloat16(), odd):
        got = rd.reduce_2d(t, "max", out_dt=torch.float32)
        want = rd.reduce_2d_plain(t, "max", out_dt=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mkn", [(1, 64, 8), (37, 100, 53), (130, 45, 137),
                                 (256, 512, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_matmul_kernel_matches_plain(cuda, mkn, dtype):
    """K3 with every epilogue: fp32 within 1e-4 x max(1, max |ref|), 16-bit
    within 2^-7 of max |ref|; int8 exact."""
    mm = _eager_kernels()[1]
    m, k, n = mkn
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / 8).to(dtype)
    bias = torch.randn(n, generator=gen, device=cuda)
    res = torch.randn((m, n), generator=gen, device=cuda)
    for epi in ("", "bias", "relu", "bias_gelu", "silu", "bias_silu_res"):
        kw = dict(bias=bias if "bias" in epi else None,
                  residual=res if "res" in epi else None, epilogue=epi)
        got, want = mm.matmul(a, b, **kw), mm.matmul_plain(a, b, **kw)
        torch.cuda.synchronize()
        top = want.double().abs().max().item()
        tol = 1e-4 * max(1.0, top) if dtype == torch.float32 else 2.0 ** -7 * top
        assert got.dtype == dtype
        assert (got.double() - want.double()).abs().max().item() <= tol, epi
    a8 = torch.randint(-128, 128, (m, k), generator=gen, device=cuda, dtype=torch.int8)
    b8 = torch.randint(-128, 128, (k, n), generator=gen, device=cuda, dtype=torch.int8)
    assert torch.equal(mm.matmul(a8, b8), mm.matmul_plain(a8, b8))


# K3's bodies by shape (the route rule, ops/pallas_kernels/matmul.route):
# ragged m, n and k that still give 16-byte row strides take wgmma (k and n
# multiples of 8, any m, m = 1 among them); k or n not a multiple of 8 take
# mma.sync
K3_WGMMA_SHAPES = [(1, 64, 8), (130, 72, 136), (300, 200, 520), (257, 1000, 264)]
K3_MMA_SHAPES = [(130, 45, 137), (64, 100, 64), (33, 64, 72)]


def _held_16bit(got, want):
    top = want.double().abs().max().item()
    assert (got.double() - want.double()).abs().max().item() <= 2.0 ** -7 * top


@pytest.mark.parametrize("tile", _eager_kernels()[1].TILES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_matmul_kernel_every_tile_matches_plain(cuda, tile, dtype):
    """K3's wgmma body at each built tile, ragged m / n / k that meet the
    route rule and m = 1, every epilogue and every output dtype: within
    2^-7 of max |ref| (one rounding of an fp32 sum); each launch counted
    on the wgmma body."""
    mm = _eager_kernels()[1]
    gen = torch.Generator(device=cuda).manual_seed(31)
    for m, k, n in K3_WGMMA_SHAPES:
        a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
        b = (torch.randn((k, n), generator=gen, device=cuda) / 8).to(dtype)
        bias = torch.randn(n, generator=gen, device=cuda)
        res = torch.randn((m, n), generator=gen, device=cuda)
        for epi in ("", "bias", "relu", "bias_gelu", "silu", "bias_silu_res",
                    "res"):
            for out_dtype in (dtype, torch.float32, torch.int32):
                kw = dict(bias=bias if "bias" in epi else None,
                          residual=res if "res" in epi else None, epilogue=epi,
                          out_dtype=out_dtype)
                before = (mm.matmul.launches_wgmma, mm.matmul.launches_mma)
                got = mm.matmul(a, b, bm=tile[0], bn=tile[1], **kw)
                want = mm.matmul_plain(a, b, **kw)
                torch.cuda.synchronize()
                assert (mm.matmul.launches_wgmma - before[0],
                        mm.matmul.launches_mma - before[1]) == (1, 0)
                assert got.dtype == out_dtype
                if out_dtype == torch.int32:  # the saturating store
                    assert (got.double() - want.double()).abs().max() <= 1
                else:
                    _held_16bit(got, want)


@pytest.mark.parametrize("mkn", K3_MMA_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_matmul_mma_body_takes_the_other_strides(cuda, mkn, dtype):
    """Shapes TMA cannot take (k or n not a multiple of 8, or an operand
    off 16 bytes) run the mma.sync body, whatever tile is asked for."""
    mm = _eager_kernels()[1]
    m, k, n = mkn
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = (torch.randn((k, n), generator=gen, device=cuda) / 8).to(dtype)
    if k % 8 == 0 and n % 8 == 0:  # aligned shape: offset a by 8 bytes
        a = torch.randn((m * k + 4,), generator=gen, device=cuda).to(dtype)
        a = a[4:].view(m, k)
    assert mm.route(m, k, n, dtype, a.data_ptr(), b.data_ptr()) == "mma"
    for tile in mm.TILES:
        before = (mm.matmul.launches_wgmma, mm.matmul.launches_mma)
        got = mm.matmul(a, b, bm=tile[0], bn=tile[1], epilogue="relu")
        want = mm.matmul_plain(a, b, epilogue="relu")
        torch.cuda.synchronize()
        assert (mm.matmul.launches_wgmma - before[0],
                mm.matmul.launches_mma - before[1]) == (0, 1)
        _held_16bit(got, want)


def _eager_mlp_step(kfunca, dev, x, w1, w2):
    xs, a1, a2 = (kfunca.from_numpy(v, dev).set_requires_grad(True) for v in (x, w1, w2))
    z = kfunca.gemm(kfunca.gemm(xs, a1).relu(), a2) + xs
    m = z.mean(0)
    m.backward(kfunca.from_numpy(np.ones((1, x.shape[1]), np.float32), dev))
    return [t.to_torch().cpu() for t in (z, m, xs.grad(), a1.grad(), a2.grad())]


def test_eager_api_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One eager MLP step with the three knobs at `pallas`: the card (K3 six
    times, K8 once, K9 nine times) against the CPU's plain versions, fp32
    within 1e-4 of each tensor's largest value."""
    import kfunca_tpu_torch as kfunca

    ew, mm, rd, wf = _eager_kernels()
    for knob in ("KFUNCA_GEMM_ENGINE", "KFUNCA_REDUCE_ENGINE",
                 "KFUNCA_ELEMENTWISE_ENGINE"):
        monkeypatch.setenv(knob, "pallas")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    w1 = (rng.standard_normal((256, 512)) / 16).astype(np.float32)
    w2 = (rng.standard_normal((512, 256)) / 23).astype(np.float32)
    counts = lambda: (mm.matmul.launches, rd.reduce_2d.launches,  # noqa: E731
                      ew.elementwise.launches, ew.elementwise.launches_vector,
                      ew.elementwise.launches_copy)
    before = counts()
    card = _eager_mlp_step(kfunca, 0, x, w1, w2)
    torch.cuda.synchronize()
    # K9: the forward add and x's second gradient on the vector body, the
    # tape's 7 gradient clones on the byte copy
    assert tuple(a - b for a, b in zip(counts(), before)) == (6, 1, 9, 2, 7)
    cpu = _eager_mlp_step(kfunca, "cpu", x, w1, w2)
    for got, want in zip(card, cpu):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_eager_norm_stat_and_attention_launch_their_kernels(cuda):
    import kfunca_tpu_torch as kfunca

    _, _, _, wf = _eager_kernels()
    x = np.random.default_rng(6).standard_normal((500, 70)).astype(np.float32)
    before = wf.welford_norm_stat.launches
    m, s = kfunca.from_numpy(x, 0).norm_stat(0)
    assert wf.welford_norm_stat.launches == before + 1
    cm, cs = kfunca.from_numpy(x, "cpu").norm_stat(0)
    assert np.allclose(m.numpy(), cm.numpy(), atol=1e-5)
    assert np.allclose(s.numpy(), cs.numpy(), rtol=1e-4)
    qkv = [np.random.default_rng(i).standard_normal((1, 2, 40, 64)).astype(np.float32)
           for i in range(4)]
    f0, b0 = fa.flash_attention_fwd_stats.launches, fa.flash_attention_backward.launches
    grads = {}
    for dev in (0, "cpu"):
        q, k, v = (kfunca.from_numpy(t, dev).set_requires_grad(True) for t in qkv[:3])
        out = kfunca.causal_attention(q, k, v)
        out.backward(kfunca.from_numpy(qkv[3], dev))
        grads[dev] = [t.numpy() for t in (out, q.grad(), k.grad(), v.grad())]
    # K1 twice: the forward, and the backward's recompute of (out, lse)
    assert fa.flash_attention_fwd_stats.launches == f0 + 2
    assert fa.flash_attention_backward.launches == b0 + 1
    for got, want in zip(grads[0], grads["cpu"]):
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_eager_kernel_engines_raise_rather_than_fall_back(cuda, monkeypatch):
    import kfunca_tpu_torch as kfunca

    ew, mm, rd, wf = _eager_kernels()
    with pytest.raises(TypeError, match="share one of"):
        mm.matmul(torch.ones((4, 4), device=cuda, dtype=torch.float64),
                  torch.ones((4, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        rd.reduce_2d(torch.ones((4, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError, match="2-D float32"):
        wf.welford_norm_stat(torch.ones((4, 4), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="share one shape"):
        ew.elementwise("add", torch.ones(4, device=cuda), torch.ones(3, device=cuda),
                       acc_dt=torch.float32, out_dt=torch.float32)
    from kfunca_tpu_torch.ops.pallas_kernels import bitonic_sort as bs

    with pytest.raises(TypeError, match="float32 or int32"):
        bs.bitonic_sort_pairs(torch.ones((2, 4), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="exceed"):
        bs.bitonic_sort_pairs(torch.ones((1, bs.MAX_N + 1), device=cuda))
    # the sort knob on the card launches K10; CPU tensors run its plain version
    monkeypatch.setenv("KFUNCA_PALLAS_SORT", "1")
    before = bs.bitonic_sort_pairs.launches
    t = kfunca.from_numpy(np.arange(10, dtype=np.float32), 0)
    vals, _ = t.sort(0, True)
    assert bs.bitonic_sort_pairs.launches == before + 1
    assert vals.numpy().tolist() == list(range(9, -1, -1))
    vals, _ = kfunca.from_numpy(np.arange(10, dtype=np.float32), "cpu").sort(0, True)
    assert vals.numpy().tolist() == list(range(9, -1, -1))
    assert bs.bitonic_sort_pairs.launches == before + 1


def test_device_info_and_launcher_modes_on_the_card(cuda, capsys):
    """device_info measures the card's copy bandwidth and bf16 matmul rate;
    profiling mode times every eager op with CUDA events; sync mode
    synchronizes after each op."""
    import kfunca_tpu_torch as kfunca
    from kfunca_tpu_torch.utils.profiling import PROFILER

    kfunca.device_info()
    out = capsys.readouterr().out
    assert torch.cuda.get_device_name(0) in out
    bw = float(out.split("measured copy bandwidth :")[1].split()[0])
    tf = float(out.split("measured bf16 matmul    :")[1].split()[0])
    assert bw > 100 and tf > 10
    t = kfunca.from_numpy(np.ones((512, 512), np.float32), 0)
    PROFILER.records.clear()
    kfunca.launcher.set_profiling_mode(True)
    try:
        (t + t).sum(0)
    finally:
        kfunca.launcher.set_profiling_mode(False)
    assert [r.name for r in PROFILER.records] == ["add", "sum"]
    assert all(r.seconds > 0 for r in PROFILER.records)
    kfunca.launcher.set_sync_mode(True)
    try:
        assert (t * 2.0).numpy()[0, 0] == 2.0
    finally:
        kfunca.launcher.set_sync_mode(False)
    assert kfunca.device_count() == torch.cuda.device_count()
    with pytest.raises(IndexError):
        kfunca.from_numpy(np.ones(2, np.float32), torch.cuda.device_count())


def test_eager_attention_gradient_ignores_an_edit_of_its_result(cuda):
    """The backward recomputes (out, lse) from q, k and v with K1, as the
    JAX package's backward does: an in-place op on the returned tensor
    before backward reaches no gradient."""
    import kfunca_tpu_torch as kfunca

    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal((1, 2, 64, 64)).astype(np.float32)
                  for _ in range(4))
    grads = []
    for edit in (False, True):
        ts = [kfunca.from_numpy(x, 0).set_requires_grad(True) for x in (q, k, v)]
        out = kfunca.causal_attention(*ts)
        if edit:
            out += 5.0
        out.backward(kfunca.from_numpy(g, 0))
        grads.append([t.grad().numpy() for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)


def test_from_torch_lands_on_the_card_by_default(cuda):
    """from_torch, like the JAX package's from_jax(arr, device=0), puts a
    CPU torch tensor on the card unless "cpu" is asked for."""
    import kfunca_tpu_torch as kfunca

    t = kfunca.from_torch(torch.arange(6.0).reshape(2, 3))
    assert t.torch_device().type == "cuda" and t.device() != "cpu"
    assert t.to_torch().cpu().tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    assert kfunca.from_torch(torch.ones(3), "cpu").device() == "cpu"


def test_elementwise_kernel_counts_no_launch_for_an_empty_operand(cuda):
    """K9 launches nothing for empty operands, so its count stays."""
    ew = _eager_kernels()[0]
    before = ew.elementwise.launches
    e = torch.empty((0, 5), device=cuda)
    got = ew.elementwise("add", e, e, acc_dt=torch.float32, out_dt=torch.float32)
    assert got.shape == (0, 5) and ew.elementwise.launches == before


@pytest.mark.parametrize("shape", [(0, 4), (4, 0)], ids=str)
def test_welford_kernel_answers_empty_matrices_without_a_launch(cuda, shape):
    """K7 of an empty matrix answers as the reference does -- NaN mean and
    invstd of (1, C) for no rows, (1, 0) outputs for no columns -- on the
    card, launching and counting nothing; so does norm_stat through the
    eager API, whose default engine is K7."""
    import kfunca_tpu_torch as kfunca

    wf = _eager_kernels()[3]
    before = wf.welford_norm_stat.launches
    m, s = wf.welford_norm_stat(torch.empty(shape, device=cuda))
    tm, ts = kfunca.from_numpy(np.zeros(shape, np.float32), 0).norm_stat(0)
    torch.cuda.synchronize()
    assert wf.welford_norm_stat.launches == before
    for got in (m, s, tm.to_torch(), ts.to_torch()):
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert tuple(got.shape) == (1, shape[1]) and bool(got.isnan().all())


# -- K11: the selective scan --------------------------------------------------

SSM_SHAPES = [  # (B, L, di, N, lb)
    (2, 64, 64, 16, 16),
    (1, 1, 33, 16, 16),
    (2, 37, 45, 5, 8),
    (1, 100, 96, 16, 32),
    (3, 19, 5152, 16, 16),
    (2, 40, 64, 32, 16),  # two groups of 16 states
    (1, 37, 45, 20, 8),  # a ragged second group
    # several chunks of the backward's segments (8 x 16 steps, 8 x 32 at
    # lb 32), the last one ragged, with ragged di and N = 16 and 32
    (1, 300, 45, 16, 16),
    (2, 257, 70, 32, 8),
    (1, 600, 33, 16, 32),
    # the forward's ring of 32-step stages: L over several stages at di
    # 5152, ending inside one; the TMA fill with N = 8 (a box wider than
    # N) and with a ragged second group of states; B 1 with L 1 on TMA
    (2, 129, 5152, 16, 32),
    (1, 70, 64, 8, 8),
    (2, 45, 96, 20, 16),
    (1, 1, 64, 16, 8),
]


def _ssm_case(dev, b, L, di, n, seed=0, dt_scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = torch.nn.functional.softplus(normal(b, L, di) - 4.0) * dt_scale
    u = normal(b, L, di)
    bm, c = normal(b, L, n), normal(b, L, n)
    a_t = -torch.arange(1, n + 1, dtype=torch.float32, device=dev)[:, None] \
        .expand(n, di).contiguous()
    return dt, u, bm, c, a_t, normal(b, L, di)


def _ssm_close(got, want, what):
    # fp32: the same recurrence with sums in other orders
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert torch.isfinite(got).all(), what
    torch.testing.assert_close(got, want, atol=tol, rtol=1e-4, msg=what)


@pytest.mark.parametrize("shape", SSM_SHAPES, ids=str)
def test_ssm_scan_kernels_match_plain(cuda, shape):
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss

    b, L, di, n, lb = shape
    dt, u, bm, c, a_t, dy = _ssm_case(cuda, b, L, di, n)
    y, hb = ss.ssm_scan_fwd(dt, u, bm, c, a_t, lb)
    ref_y, ref_hb = ss.ssm_scan_plain(dt, u, bm, c, a_t, lb)
    torch.cuda.synchronize()
    _ssm_close(y, ref_y, "y")
    _ssm_close(hb, ref_hb, "h_bound")
    got = ss.ssm_scan_bwd(dt, u, bm, c, a_t, hb, dy, lb)
    want = ss.ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy, lb)
    for g, w, name in zip(got, want, ("ddt", "du", "dbm", "dc", "da_t")):
        _ssm_close(g, w, name)
    again = ss.ssm_scan_bwd(dt, u, bm, c, a_t, hb, dy, lb)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("shape", [(2, 100, 5152, 16, 16),  # TMA fill
                                   (2, 37, 45, 5, 8),  # ordinary loads
                                   (1, 75, 96, 32, 32)], ids=str)
def test_ssm_scan_forward_is_bitwise_repeatable(cuda, shape):
    """Two forward calls give the same bits, on both fills of the ring."""
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss

    b, L, di, n, lb = shape
    dt, u, bm, c, a_t, _ = _ssm_case(cuda, b, L, di, n, seed=3)
    y, hb = ss.ssm_scan_fwd(dt, u, bm, c, a_t, lb)
    y2, hb2 = ss.ssm_scan_fwd(dt, u, bm, c, a_t, lb)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(hb, hb2)
    ref_y, ref_hb = ss.ssm_scan_plain(dt, u, bm, c, a_t, lb)
    _ssm_close(y, ref_y, "y")
    _ssm_close(hb, ref_hb, "h_bound")


def test_ssm_scan_kernels_with_an_underflowing_decay(cuda):
    """dt * A so negative that exp underflows to 0: finite, as plain."""
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss

    dt, u, bm, c, a_t, dy = _ssm_case(cuda, 1, 40, 64, 16, dt_scale=1e4)
    assert float(torch.exp(dt[..., None] * a_t.t()).min()) == 0.0
    y, hb = ss.ssm_scan_fwd(dt, u, bm, c, a_t)
    _ssm_close(y, ss.ssm_scan_plain(dt, u, bm, c, a_t)[0], "y")
    got = ss.ssm_scan_bwd(dt, u, bm, c, a_t, hb, dy)
    for g, w in zip(got, ss.ssm_scan_bwd_plain(dt, u, bm, c, a_t, dy)):
        _ssm_close(g, w, "grad")


def test_ssm_scan_refuses_what_the_kernels_do_not_take(cuda):
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss

    dt, u, bm, c, a_t, dy = _ssm_case(cuda, 1, 8, 32, 16)
    with pytest.raises(ValueError, match="lb"):
        ss.ssm_scan_fwd(dt, u, bm, c, a_t, lb=4)
    empty = torch.zeros((1, 8, 0), device=cuda)
    with pytest.raises(ValueError, match="non-empty"):
        ss.ssm_scan_fwd(dt, u, empty, empty, torch.zeros((0, 32), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        ss.ssm_scan_fwd(dt.bfloat16(), u, bm, c, a_t)


def test_mamba_step_launches_the_scan_once_a_layer(cuda):
    """One train step of a 3-layer Mamba on the card: K11 forward and
    backward each launch once a layer, and the loss equals the plain
    engine's; KFUNCA_SSM_ENGINE=xla launches neither."""
    import os

    from kfunca_tpu_torch.models import mamba
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss

    cfg = mamba.MambaConfig(vocab_size=128, d_model=48, n_layers=3,
                            d_state=16, dtype="float32")
    params = mamba.init_mamba_params(0, cfg, device=cuda)
    tokens = torch.randint(0, 128, (2, 40), device=cuda)
    targets = torch.roll(tokens, -1, 1)
    losses = {}
    for eng in ("pallas", "xla"):
        os.environ["KFUNCA_SSM_ENGINE"] = eng
        try:
            ss.ssm_scan_fwd.launches = ss.ssm_scan_bwd.launches = 0
            opt = train.init_opt_state(params, device=cuda)
            p = {k: (v.clone() if torch.is_tensor(v) else
                     [{n: t.clone() for n, t in layer.items()} for layer in v])
                 for k, v in params.items()}
            _, _, loss = mamba.make_mamba_train_step(cfg)(p, opt, tokens,
                                                          targets)
            torch.cuda.synchronize()
            losses[eng] = float(loss)
            want = 3 if eng == "pallas" else 0
            assert (ss.ssm_scan_fwd.launches, ss.ssm_scan_bwd.launches) == (
                want, want)
        finally:
            del os.environ["KFUNCA_SSM_ENGINE"]
    assert abs(losses["pallas"] - losses["xla"]) < 1e-5


def test_mamba_with_32_states_runs_k11_forward_and_backward(cuda):
    """MambaConfig(d_state=32), 2 layers: loss and every gradient through
    K11 (one forward and one backward launch a layer) against the chunked
    scan (KFUNCA_SSM_ENGINE=xla), fp32 within 1e-4 of each leaf's max."""
    import os

    from kfunca_tpu_torch.models import mamba
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss
    from kfunca_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    cfg = mamba.MambaConfig(vocab_size=128, d_model=64, n_layers=2,
                            d_state=32, dtype="float32")
    params = mamba.init_mamba_params(1, cfg, device=cuda)
    tokens = torch.randint(0, 128, (2, 45), device=cuda)
    targets = torch.roll(tokens, -1, 1)
    out = {}
    for eng in ("pallas", "xla"):
        os.environ["KFUNCA_SSM_ENGINE"] = eng
        try:
            before = (ss.ssm_scan_fwd.launches, ss.ssm_scan_bwd.launches)
            views = [p.detach().requires_grad_(True)
                     for p in tree_leaves(params)]
            loss = mamba.loss_fn(tree_unflatten(params, views), tokens,
                                 targets, cfg)
            grads = torch.autograd.grad(loss, views)
            torch.cuda.synchronize()
            n = (ss.ssm_scan_fwd.launches - before[0],
                 ss.ssm_scan_bwd.launches - before[1])
            assert n == ((2, 2) if eng == "pallas" else (0, 0))
            out[eng] = (float(loss), grads)
        finally:
            del os.environ["KFUNCA_SSM_ENGINE"]
    assert abs(out["pallas"][0] - out["xla"][0]) < 1e-5
    for gk, gp in zip(out["pallas"][1], out["xla"][1]):
        assert torch.isfinite(gk).all()
        assert (gk - gp).abs().max() <= 1e-4 * gp.abs().max().clamp_min(1e-30)


# -- K10: the bitonic sort, and the sort engine --------------------------------


def _k10_keys(cuda, rows, n, dtype, gen):
    if dtype == torch.int32:
        k = torch.randint(-50, 50, (rows, n), generator=gen, device=cuda,
                          dtype=torch.int32)
        k[:, ::11] = torch.iinfo(torch.int32).max
        k[:, 1::13] = torch.iinfo(torch.int32).min
    else:
        k = torch.randn((rows, n), generator=gen, device=cuda)
        k[:, ::9] = float("nan")
        k[:, 1::10] = -float("nan")
        k[:, 2::11] = -0.0
        k[:, 3::11] = 0.0
        k[:, 4::12] = float("inf")
        k[:, 5::12] = -float("inf")
    k[:, ::7] = k[:, :1].clone()  # duplicates
    return k


@pytest.mark.parametrize("rows,n", [(3, 1), (5, 129), (40, 512), (7, 1000),
                                    (2, 4096), (2, 8192), (8192, 128),
                                    (8192, 256), (4096, 2048)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32], ids=str)
def test_bitonic_sort_kernel_matches_plain(cuda, rows, n, dtype):
    """K10 against its plain version (a stable torch.sort of the keys):
    keys and indices bitwise, NaN after every number with ties by index,
    -0.0 tied with 0.0, INT32_MAX before the pads."""
    from kfunca_tpu_torch.ops.pallas_kernels import bitonic_sort as bs

    gen = torch.Generator(device=cuda).manual_seed(rows * n)
    keys = _k10_keys(cuda, rows, n, dtype, gen)
    before = bs.bitonic_sort_pairs.launches
    got_k, got_i = bs.bitonic_sort_pairs(keys)
    want_k, want_i = bs.bitonic_sort_pairs_plain(keys)
    torch.cuda.synchronize()
    assert bs.bitonic_sort_pairs.launches == before + 1
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))


def test_sort_engine_on_the_card_matches_the_default_engine(cuda, monkeypatch):
    """kfunca sort / topk with KFUNCA_PALLAS_SORT=1 (K10) against the
    default engine, bitwise, in every dtype the engine takes and along a
    non-last dim; rows that pad past 1024 launch no K10."""
    import kfunca_tpu_torch as kfunca
    from kfunca_tpu_torch.ops.pallas_kernels import bitonic_sort as bs

    gen = torch.Generator(device=cuda).manual_seed(7)
    base = torch.randn((6, 300), generator=gen, device=cuda) * 50
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                  torch.int16, torch.int8, torch.uint8):
        x = kfunca.from_torch(base.to(dtype) if dtype.is_floating_point
                              else base.clamp(0 if dtype == torch.uint8 else -100,
                                              100).to(dtype))
        for dim, desc in ((1, False), (1, True), (0, True)):
            monkeypatch.delenv("KFUNCA_PALLAS_SORT", raising=False)
            want = [r.to_torch() for r in x.sort(dim, desc)]
            wtop = [r.to_torch() for r in x.topk(280, 1, desc)]
            monkeypatch.setenv("KFUNCA_PALLAS_SORT", "1")
            before = bs.bitonic_sort_pairs.launches
            got = [r.to_torch() for r in x.sort(dim, desc)]
            gtop = [r.to_torch() for r in x.topk(280, 1, desc)]
            assert bs.bitonic_sort_pairs.launches == before + 2
            for g, w in zip(got + gtop, want + wtop):
                assert torch.equal(g, w), (dtype, dim, desc)
    long_row = kfunca.from_torch(torch.randn((2, 1025), device=cuda))
    before = bs.bitonic_sort_pairs.launches
    long_row.sort(1, False)
    assert bs.bitonic_sort_pairs.launches == before


def test_native_core_is_loaded_on_the_card(cuda):
    """The card's machine has g++ (nvcc needs it): the core builds and
    loads by default, and the eager API and the server run through it."""
    import kfunca_tpu_torch as kfunca
    from kfunca_tpu_torch.runtime import _native

    lib = _native.get_lib()
    assert lib is not None and _native.library_path().exists()
    assert serve.PagePool(4)._lib is lib
    a = kfunca.from_numpy(np.ones((3, 1), np.float32), 0)
    b = kfunca.from_numpy(np.ones((1, 4), np.int32), 0)
    assert list((a + b).sizes()) == [3, 4]
    assert len(serve.PrefixIndex().hash_chain(list(range(32)), 8, 0)[0]) == 2


# -- K12: the ring-attention hop, and the ring on one card ---------------------

# (B, H, Sq, Skv, D, q_off, kv_off): diagonal, past, wholly future, ragged
# shards with unaligned offsets, head dim 40 (padded to 64), and a hop that
# leaves q rows 0..63 with no column (a whole consumer of the bf16 body);
# then the hd-256 instances: past and ragged at 256, head dim 160 (padded
# to 256), and the row-less consumer at 256
HOP_CASES = [
    (1, 4, 256, 256, 128, 256, 256),
    (2, 3, 128, 128, 64, 128, 0),
    (1, 2, 128, 128, 128, 0, 128),
    (1, 2, 200, 200, 64, 200, 0),
    (1, 3, 130, 100, 128, 37, 50),
    (1, 2, 96, 96, 40, 96, 96),
    (1, 2, 128, 128, 128, 0, 64),
    (1, 4, 256, 256, 256, 256, 0),
    (1, 4, 200, 200, 256, 400, 200),
    (1, 3, 130, 100, 160, 37, 50),
    (1, 2, 128, 128, 256, 0, 64),
]


def _hop_case(dev, dtype, case, seed=0):
    b, h, sq, skv, d, _, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=dev)
    q = (mk(b, h, sq, d) / math.sqrt(d)).to(dtype)
    k, v, g = mk(b, h, skv, d).to(dtype), mk(b, h, skv, d).to(dtype), \
        mk(b, h, sq, d).to(dtype)
    # a carry from an earlier (past) hop, and a global lse / delta
    carry = (mk(b * h, sq), mk(b * h, sq).abs() + 1, mk(b * h, sq, d))
    stats = (mk(b * h, sq) + 3, mk(b * h, sq))
    accs = (mk(b * h, sq, d), mk(b * h, skv, d), mk(b * h, skv, d))
    return q, k, v, g, carry, stats, accs


# A hop's outputs are fp32 whatever its inputs.  On fp32 inputs both routes
# keep p and ds in fp32 and differ by the order of fp32 sums (the kernel
# merges the carry a tile at a time, the plain version the hop at once):
# 1e-4 x max(1, max |ref|).  On bf16 inputs the kernel's wgmma body rounds p
# and ds to bf16 before the second products, as K1's and K2's do and the
# plain version does not (`rounded`): acc, dq, dk and dv, and the ring's
# results, are held to the 16-bit kernel-vs-plain limit, 2^-7 of max |ref|
# (m and l sum the fp32 p and keep 1e-4).  The ring's bf16 results are
# rounded to bf16 once more, where a difference can land on the
# neighbouring value, up to 2^-7 of the element away.
def _hop_close(got, want, rounded=False):
    got, want = got.detach(), want.detach()
    top = float(want.abs().max())
    tol = 2.0 ** -7 * top if rounded else 1e-4 * max(1.0, top)
    assert torch.isfinite(got).all()
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", HOP_CASES, ids=str)
def test_ring_hop_kernels_match_plain(cuda, dtype, case):
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh

    q_off, kv_off = case[-2:]
    sq, skv = case[2:4]
    q, k, v, g, carry, (lse, delta), accs = _hop_case(cuda, dtype, case)
    n1, n2 = rh.flash_attention_hop.launches, rh.flash_attention_bwd_hop.launches
    w1, w2 = (rh.flash_attention_hop.launches_wgmma,
              rh.flash_attention_bwd_hop.launches_wgmma)
    got = [t.clone() for t in carry]
    rh.flash_attention_hop(q, k, v, *got, q_off, kv_off)
    want = [t.clone() for t in carry]
    rh.flash_attention_hop_plain(q, k, v, *want, q_off, kv_off)
    gacc = [t.clone() for t in accs]
    rh.flash_attention_bwd_hop(q, k, v, g, lse, delta, *gacc, q_off, kv_off)
    wacc = [t.clone() for t in accs]
    rh.flash_attention_bwd_hop_plain(q, k, v, g, lse, delta, *wacc, q_off,
                                     kv_off)
    torch.cuda.synchronize()
    assert rh.flash_attention_hop.launches == n1 + 1
    assert rh.flash_attention_bwd_hop.launches == n2 + 1
    bf16 = dtype == torch.bfloat16
    assert rh.flash_attention_hop.launches_wgmma == w1 + bf16
    assert rh.flash_attention_bwd_hop.launches_wgmma == w2 + bf16
    for i, (a, w) in enumerate(zip(got + gacc, want + wacc)):
        _hop_close(a, w, rounded=bf16 and i >= 2)  # acc, dq, dk, dv
    if kv_off > q_off + sq - 1:  # a wholly-future hop changes nothing
        assert all(torch.equal(a, t) for a, t in zip(got + gacc,
                                                     list(carry + accs)))
    # q rows that see no column keep their carry and dq bit for bit, and kv
    # rows that no q row reads keep dk and dv
    idle = torch.arange(sq, device=cuda) + q_off < kv_off
    for a, t in zip(got + gacc[:1], list(carry + accs)[:4]):
        assert torch.equal(a[:, idle], t[:, idle])
    unread = torch.arange(skv, device=cuda) + kv_off > q_off + sq - 1
    for a, t in zip(gacc[1:], accs[1:]):
        assert torch.equal(a[:, unread], t[:, unread])


def test_ring_hop_backward_is_bitwise_repeatable(cuda):
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh

    q, k, v, g, _, (lse, delta), accs = _hop_case(
        cuda, torch.bfloat16, (1, 8, 512, 512, 128, 512, 0))
    runs = []
    for _ in range(2):
        runs.append([t.clone() for t in accs])
        rh.flash_attention_bwd_hop(q, k, v, g, lse, delta, *runs[-1], 512, 0)
    assert all(torch.equal(a, b_) for a, b_ in zip(*runs))


def test_ring_hop_is_bitwise_repeatable_at_head_dim_256(cuda):
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh

    q, k, v, g, carry, (lse, delta), accs = _hop_case(
        cuda, torch.bfloat16, (1, 8, 512, 512, 256, 512, 0))
    runs = []
    for _ in range(2):
        runs.append([t.clone() for t in carry + accs])
        rh.flash_attention_hop(q, k, v, *runs[-1][:3], 512, 0)
        rh.flash_attention_bwd_hop(q, k, v, g, lse, delta, *runs[-1][3:], 512,
                                   0)
    assert all(torch.equal(a, b_) for a, b_ in zip(*runs))


def test_ring_hop_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh

    q, k, v, g, carry, _, _ = _hop_case(cuda, torch.float32,
                                        (1, 2, 16, 16, 64, 0, 0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rh.flash_attention_hop(q.half(), k.half(), v.half(), *carry, 0, 0)
    with pytest.raises(ValueError, match="limit of 256"):
        big = torch.zeros((1, 1, 8, 257), device=cuda)
        rh.flash_attention_hop(big, big, big, *rh.hop_carry_init(
            1, 1, 8, 257, device=cuda), 0, 0)
    with pytest.raises(ValueError, match="is on cpu"):
        rh.flash_attention_hop(q, k, v, carry[0].cpu(), *carry[1:], 0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4])
def test_local_ring_with_the_kernels_matches_the_plain_ring(cuda, dtype, n):
    """LocalRing(n) on the card: K12 against the plain hops, forward and
    the three gradients, n^2 launches of each hop a pass, and the result
    against causal attention over the gathered sequence.  In fp32 it is
    also held, gradients included, against the einsum oracle
    (`_ring_einsum` under autograd), which shares no code with the hop
    loop."""
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh
    from kfunca_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, g = (torch.randn((1, 4, 64 * n + 32 * n, 128), generator=gen,
                              device=cuda).to(dtype) for _ in range(4))
    ring = ra.LocalRing(n)
    res = {}
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n1, n2 = (rh.flash_attention_hop.launches,
                  rh.flash_attention_bwd_hop.launches)
        out = ra.ring_attention_spmd(*leaves, ring=ring, use_kernel=use_kernel)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        launched = (rh.flash_attention_hop.launches - n1,
                    rh.flash_attention_bwd_hop.launches - n2)
        assert launched == ((n * n, n * n) if use_kernel else (0, 0))
        res[use_kernel] = (out, *grads)
    for a, w in zip(res[True], res[False]):
        assert a.dtype == dtype
        _hop_close(a, w, rounded=dtype == torch.bfloat16)
    if dtype == torch.float32:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ra._ring_einsum(*leaves, ring)
        oracle = (out, *torch.autograd.grad(out, leaves, g))
        for a, w in zip(res[True], oracle):
            _hop_close(a, w)
    ref = attention._sdpa_xla(q.float(), k.float(), v.float())
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7 * float(ref.abs().max())
    assert float((res[True][0].detach().float() - ref).abs().max()) < tol


@pytest.mark.parametrize("n", [1, 4])
def test_ring_on_cuda_takes_the_kernels_whatever_the_dtype(cuda, n):
    """The default route (use_kernel=None) on CUDA tensors: fp16 runs K12
    widened to fp32 (n^2 launches of each hop a pass) and comes back in
    fp16, equal to the fp32 ring rounded; fp64 reaches the wrapper and is
    refused there, never run by the plain hops."""
    from kfunca_tpu_torch.ops.pallas_kernels import ring_hop as rh
    from kfunca_tpu_torch.parallel import ring_attention as ra

    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, g = (torch.randn((1, 4, 96 * n, 64), generator=gen, device=cuda)
                  .half() for _ in range(4))
    fn = ra.make_ring_attention(ra.LocalRing(n))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n1, n2 = rh.flash_attention_hop.launches, rh.flash_attention_bwd_hop.launches
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (rh.flash_attention_hop.launches - n1,
            rh.flash_attention_bwd_hop.launches - n2) == (n * n, n * n)
    assert out.dtype == torch.float16
    assert all(t.dtype == torch.float16 for t in grads)
    wide = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = fn(*wide)
    want_grads = torch.autograd.grad(want, wide, g.float())
    for a, w in zip((out, *grads), (want, *want_grads)):
        assert torch.equal(a, w.detach().half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(q.double(), k.double(), v.double())


def test_process_group_ring_over_nccl_matches_the_local_ring(cuda, tmp_path):
    """make_ring_attention over a 4-card `cp` DeviceMesh (NCCL, one process
    a card, K12 on each) gives the bits of LocalRing(4) on one card: the
    same hops on the same shards in the same order.  Needs four cards."""
    import sys

    from kfunca_tpu_torch.parallel import ring_attention as ra

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ring_ranks

    n = 4
    rng = np.random.default_rng(11)
    arrays = {name: rng.standard_normal((1, 8, n * 512, 128)).astype(np.float32)
              for name in "qkv"}
    np.savez(tmp_path / "inputs.npz", **arrays)
    torch.multiprocessing.start_processes(
        torch_ring_ranks.run_rank,
        args=(n, str(tmp_path / "store"), str(tmp_path / "inputs.npz"),
              str(tmp_path), "nccl", "bfloat16"),
        nprocs=n, join=True, start_method="spawn")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(n)]
    leaves = [torch.from_numpy(arrays[name]).to(cuda, torch.bfloat16)
              .requires_grad_(True) for name in "qkv"]
    out = ra.make_ring_attention(ra.LocalRing(n))(*leaves)
    grads = torch.autograd.grad(torch.sin(out.float()).sum(), leaves)
    for key, want in zip(("out", "dq", "dk", "dv"), (out, *grads)):
        got = np.concatenate([r[key] for r in ranks], axis=2)
        assert np.array_equal(got, want.detach().float().cpu().numpy()), key


# -- parallel/: the kernels at a tensor-parallel rank's shapes, the sharded
# step and tp serving on the card, and both over NCCL ---------------------------

MESH = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=256, max_seq_len=64, dtype="float32")


def _mesh_ranks():
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_mesh_ranks

    return torch_mesh_ranks


def test_flash_kernels_at_a_tp_rank_shape(cuda):
    """K1 and K2 on the wgmma bodies at a tp = 2 rank's share of Mistral's
    heads (16 over 4 kv heads of 128): 2^-7 of max |ref|, as the bf16
    flash tests."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, g = (torch.randn((1, h, 1024, 128), generator=gen, device=cuda)
                  .to(torch.bfloat16) for h in (16, 4, 4, 16))
    f, b = fa.flash_attention_fwd_stats, fa.flash_attention_backward
    n = (f.launches_wgmma, b.launches_wgmma)
    out, lse = f(q, k, v, window=512)
    grads = b(q, k, v, g, out, lse, window=512)
    assert (f.launches_wgmma, b.launches_wgmma) == (n[0] + 1, n[1] + 1)
    group = lambda t: t.repeat_interleave(4, dim=1)
    ref_out = fa.flash_attention_plain(q, group(k), group(v), 512)[0]
    ref = fa.flash_attention_backward_plain(q, group(k), group(v), g, 512)
    ref = (ref[0], *(r.reshape(1, 4, 4, 1024, 128).sum(2) for r in ref[1:]))
    for got, want in ((out, ref_out), *zip(grads, ref)):
        top = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= (
            2.0 ** -7 * top * 2)


@pytest.mark.parametrize("k,n", [(4096, 3072), (2048, 4096), (4096, 7168),
                                 (7168, 4096), (4096, 16000)])
def test_matmul_q8_at_a_tp_rank_shapes(cuda, k, n):
    """K5 at a tp = 2 rank's decode products: bit-equal in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    a = torch.randint(-127, 128, (8, k), generator=gen, device=cuda).to(
        torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda).to(
        torch.int8)
    sa = torch.rand(8, generator=gen, device=cuda) + 0.01
    sb = torch.rand(n, generator=gen, device=cuda) + 0.01
    assert torch.equal(tq.matmul_q8(a, b, sa, sb, torch.float32),
                       tq.matmul_q8_plain(a, b, sa, sb, torch.float32))


def test_sharded_step_on_the_card_matches_the_cpu(cuda):
    """LocalMesh(2, 2) on the card (K1/K2 per rank) against the same mesh
    on the CPU, two fp32 sgd steps: params within 1e-5 of each leaf's
    largest entry, losses within 1e-5."""
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = transformer.TransformerConfig(**MESH)
    oc = train.OptConfig(algo="sgd", lr=1e-2)
    params = transformer.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 33)) for _ in range(2)]
    runs = []
    for dev in ("cpu", cuda):
        mesh = meshlib.LocalMesh(2, 2, dev)
        sp = meshlib.shard_params(tree_map(lambda t: t.to(dev), params),
                                  mesh, True, cfg=cfg)
        st = train.init_opt_state(sp, oc)
        step = train.make_sharded_train_step(cfg, mesh, oc, fsdp=True,
                                             grad_accum=2)
        losses = []
        for w in batches:
            sp, st, loss = step(sp, st, w[:, :-1], w[:, 1:])
            losses.append(float(loss))
        runs.append(([x.cpu() for x in tree_leaves(
            meshlib.gather_params(sp))], losses))
    for a, b in zip(*(r[0] for r in runs)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    np.testing.assert_allclose(runs[0][1], runs[1][1], atol=1e-5)


def test_tp_server_on_the_card_matches_the_single_device_server(cuda):
    """tp = 2 w8 + kv8 on the card (K5 and K6 per rank, a rank's heads)
    against the single-device server on the card: the same tokens, and K5
    and K6 launched by every rank every decode step."""
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.utils.tree import tree_map

    cfg = transformer.TransformerConfig(**MESH)
    params = tree_map(lambda t: t.to(cuda),
                      transformer.init_params(0, cfg, device="cpu"))
    kw = dict(batch_slots=2, page_size=16, n_pages=16, max_pages_per_seq=4,
              quantize_weights=True, quantize_kv=True, fused_pool=False)
    prompts = [[3, 5, 7], list(range(1, 30))]

    def run(mesh=None):
        srv = serve.InferenceServer(params, cfg, mesh=mesh, **kw)
        rids = [srv.submit(p, max_new=8) for p in prompts]
        out = srv.run()
        return [out[r] for r in rids], srv.decode_steps

    want, _ = run()
    pa.paged_decode_attention.launches = tq.matmul_q8.launches = 0
    got, steps = run(meshlib.LocalMesh(1, 2, cuda))
    assert got == want
    assert pa.paged_decode_attention.launches == 2 * 2 * steps
    assert tq.matmul_q8.launches == 2 * (5 * 2 + 1) * steps


def _spawn_nccl(task, spec, n, dp, tp, tmp_path):
    ranks = _mesh_ranks()
    torch.multiprocessing.start_processes(
        ranks.run_rank, args=(n, str(tmp_path / "store"), task, spec,
                              str(tmp_path), dp, tp, "nccl"),
        nprocs=n, join=True, start_method="spawn")
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(n)]


def _cards():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards (NCCL takes one rank a card)")
    return 4 if n >= 4 else 2


def test_sharded_step_over_nccl_matches_the_local_mesh(cuda, tmp_path):
    """make_sharded_train_step over a DeviceMesh, one process a card (NCCL;
    (2, 2) on four cards, (1, 2) on two), against LocalMesh of the same
    shape on one card: the step tolerance of test_torch_sharded_train.py."""
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.utils.tree import tree_leaves, tree_map

    n = _cards()
    dp, tp = (2, 2) if n == 4 else (1, 2)
    rng = np.random.default_rng(0)
    w = rng.integers(0, 256, (2, 4, 17))
    np.savez(tmp_path / "batches.npz", tokens=w[:, :, :-1],
             targets=w[:, :, 1:])
    spec = dict(cfg=MESH, oc=dict(algo="adamw", clip_norm=0.5), seed=3,
                batches=str(tmp_path / "batches.npz"), fsdp=True,
                grad_accum=2)
    ranks = _spawn_nccl("train", spec, n, dp, tp, tmp_path)
    cfg = transformer.TransformerConfig(**MESH)
    oc = train.OptConfig(**spec["oc"])
    mesh = meshlib.LocalMesh(dp, tp, cuda)
    sp = meshlib.shard_params(tree_map(
        lambda t: t.to(cuda), transformer.init_params(3, cfg, device="cpu")),
        mesh, True, cfg=cfg)
    st = train.init_opt_state(sp, oc)
    step = train.make_sharded_train_step(cfg, mesh, oc, fsdp=True,
                                         grad_accum=2)
    losses = []
    for tok, tgt in zip(w[:, :, :-1], w[:, :, 1:]):
        sp, st, loss = step(sp, st, tok, tgt)
        losses.append(float(loss))
    want = [x.cpu().numpy() for x in tree_leaves(meshlib.gather_params(sp))]
    got = ranks[0]
    extra = 2 * 1e-2 * oc.lr
    for i, x in enumerate(want):
        np.testing.assert_allclose(got[f"p{i}"], x, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(x).max()) + extra)
    np.testing.assert_allclose(got["losses"], losses, atol=1e-5)


def test_tp_serving_over_nccl_matches_the_local_mesh(cuda, tmp_path):
    """InferenceServer over a tp DeviceMesh, one process a card (NCCL),
    w8 + kv8: every rank gives the LocalMesh server's tokens."""
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.utils.tree import tree_map

    n = _cards()
    server = dict(batch_slots=2, page_size=16, n_pages=16,
                  max_pages_per_seq=4, quantize_weights=True,
                  quantize_kv=True)
    prompts = [[3, 5, 7], list(range(1, 30))]
    spec = dict(cfg=MESH, seed=0, server=server, prompts=prompts, max_new=8)
    ranks = _spawn_nccl("serve", spec, n, 1, n, tmp_path)
    cfg = transformer.TransformerConfig(**MESH)
    params = tree_map(lambda t: t.to(cuda),
                      transformer.init_params(0, cfg, device="cpu"))
    srv = serve.InferenceServer(params, cfg, mesh=meshlib.LocalMesh(1, n, cuda),
                                **server)
    rids = [srv.submit(p, max_new=8) for p in prompts]
    out = srv.run()
    for r in ranks:
        for i, rid in enumerate(rids):
            assert r[f"t{i}"].tolist() == out[rid]


# -- pipeline, zero-bubble and expert parallelism; the tp Mamba -------------

PIPE = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
            n_layers=4, d_ff=512, max_seq_len=128, dtype="bfloat16")


def _pipe_blocks(dev):
    from kfunca_tpu_torch.utils.tree import tree_map

    cfg = transformer.TransformerConfig(**PIPE)
    params = transformer.init_params(0, cfg, device="cpu")
    return tree_map(lambda t: t.to(dev), params["blocks"]), cfg


def _bf16_close(got, want, scale=2.0 ** -6):
    """Within `scale` of the reference's largest entry: the kernels and
    their plain versions round bf16 partial results in other places, and
    four blocks carry those roundings on."""
    top = float(want.float().abs().max())
    assert float((got.float().cpu() - want.float().cpu()).abs().max()) <= (
        scale * top)


def _pipeline_run(dev):
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.parallel import pipeline as pl

    blocks, cfg = _pipe_blocks(dev)
    mesh = meshlib.LocalMesh(axes={"pp": 2}, device=dev)
    sp = pl.stage_shards(pl.stack_stages(blocks, 2), mesh)
    trees = [{k: v.detach().requires_grad_(True) for k, v in t.items()}
             for t in sp.local]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 1, 128, 256), generator=gen).to(torch.bfloat16).to(dev)
    fn = pl.make_pipelined_forward(
        lambda p, h: transformer._block(h, p, cfg), mesh)
    ys = fn(trees, x)
    grads = torch.autograd.grad(sum((y.float() ** 2).sum() for y in ys),
                                [t["wqkv"] for t in trees])
    return ys[0].detach(), grads


def test_flash_kernels_inside_a_pipeline_stage(cuda):
    """GPipe over LocalMesh(pp = 2) on the card, 4 bf16 blocks, M = 2: K1 a
    block and a microbatch forward, K2 the same backward, all on the wgmma
    bodies; output and wqkv gradients against the same pipeline on the
    CPU (the kernels' plain versions)."""
    f, b = fa.flash_attention_fwd_stats, fa.flash_attention_backward
    before = (f.launches, b.launches, f.launches_wgmma, b.launches_wgmma)
    out, grads = _pipeline_run(cuda)
    after = (f.launches, b.launches, f.launches_wgmma, b.launches_wgmma)
    assert [a - c for a, c in zip(after, before)] == [8, 8, 8, 8]
    want_out, want_grads = _pipeline_run("cpu")
    _bf16_close(out, want_out)
    for g, w in zip(grads, want_grads):
        _bf16_close(g, w)


def _zb_run(dev, v):
    from kfunca_tpu_torch.parallel import mesh as meshlib
    from kfunca_tpu_torch.parallel import pipeline as pl
    from kfunca_tpu_torch.parallel import zero_bubble as zb

    blocks, cfg = _pipe_blocks(dev)
    mesh = meshlib.LocalMesh(axes={"pp": 2}, device=dev)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 1, 128, 256), generator=gen).to(torch.bfloat16).to(dev)

    def loss(y, i):
        return (y.float() ** 2).sum()

    if v:
        sp = pl.stage_shards(zb.stack_stages_v(blocks, 2), mesh)
        step = zb.make_zbv_train_step(
            lambda p, h: transformer._block(h, p, cfg), loss, mesh, n_micro=2)
    else:
        sp = pl.stage_shards(pl.stack_stages(blocks[:2], 2), mesh)
        step = zb.make_zb_train_step(
            lambda p, h: transformer._block(
                h, {k: t[0] for k, t in p.items()}, cfg), loss, mesh,
            n_micro=2)
    return step(sp, x)


@pytest.mark.parametrize("v", [False, True], ids=["zb_h1", "zb_v"])
def test_zero_bubble_launch_counts_on_the_card(cuda, v):
    """F, then B and W each re-running the stage: K1 = 3 x blocks x M and
    K2 = 2 x blocks x M, all on the wgmma bodies; loss and gradients
    against the same step on the CPU."""
    f, b = fa.flash_attention_fwd_stats, fa.flash_attention_backward
    before = (f.launches, b.launches, f.launches_wgmma, b.launches_wgmma)
    loss, grads = _zb_run(cuda, v)
    after = (f.launches, b.launches, f.launches_wgmma, b.launches_wgmma)
    blocks = 4 if v else 2
    want = [3 * blocks * 2, 2 * blocks * 2] * 2
    assert [a - c for a, c in zip(after, before)] == want
    want_loss, want_grads = _zb_run("cpu", v)
    assert abs(float(loss) - float(want_loss)) <= 2.0 ** -6 * abs(
        float(want_loss))
    for g, w in zip(grads, want_grads):
        for k in ("wqkv", "w_down"):
            _bf16_close(g[k], w[k])


def test_ssm_kernel_on_a_tp_rank_slice(cuda):
    """K11 and K11b on a tp = 2 rank's half of d_inner against their plain
    version; then the tp Mamba forward on the card (K11 once a layer and a
    rank) against the same forward on the CPU, fp32: 1e-4 x max(1, max
    |ref|)."""
    from kfunca_tpu_torch.models import mamba
    from kfunca_tpu_torch.ops.pallas_kernels import ssm_scan as ss
    from kfunca_tpu_torch.parallel import mesh as meshlib

    gen = torch.Generator(device=cuda).manual_seed(5)
    b, L, di, n = 2, 96, 256, 16
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(mk(b, L, di)) * 0.1
    u, bm, c = mk(b, L, di), mk(b, L, n), mk(b, L, n)
    a_t = -torch.exp(mk(n, di) * 0.5)
    half = slice(di // 2, di)
    args = [t[..., half].contiguous() for t in (dt, u)] + [bm, c]
    at = a_t[:, half].contiguous()
    leaves = [t.requires_grad_(True) for t in args]
    y = ss.ssm_scan(*leaves, at, 16)
    g = mk(b, L, di // 2)
    got = torch.autograd.grad(y, leaves, g)
    # the plain version: the same wrapper on CPU copies
    ref_leaves = [t.detach().cpu().requires_grad_(True) for t in args]
    ref = ss.ssm_scan(*ref_leaves, at.cpu(), 16)
    want = torch.autograd.grad(ref, ref_leaves, g.cpu())
    for x, w in ((y, ref), *zip(got, want)):
        x, w = x.detach().cpu(), w.detach()
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((x - w).abs().max()) <= tol
    cfg = mamba.MambaConfig(vocab_size=64, d_model=64, n_layers=2,
                            d_state=16, dtype="float32")
    params = mamba.init_mamba_params(0, cfg, device="cpu")
    tok = torch.randint(0, 64, (2, 48), generator=torch.Generator()
                        .manual_seed(0))
    outs = []
    for dev in (cuda, "cpu"):
        from kfunca_tpu_torch.utils.tree import tree_map

        mesh = meshlib.LocalMesh(1, 2, dev)
        sp = mamba.shard_mamba_params(tree_map(lambda t: t.to(dev), params),
                                      mesh)
        n0 = ss.ssm_scan_fwd.launches
        outs.append(mamba.forward(sp, tok, cfg).cpu())
        if dev == cuda:
            assert ss.ssm_scan_fwd.launches - n0 == cfg.n_layers * 2
    tol = 1e-4 * max(1.0, float(outs[1].abs().max()))
    assert float((outs[0] - outs[1]).abs().max()) <= tol


def test_moe_and_pipeline_lm_on_the_card_match_the_cpu(cuda):
    """make_moe_ffn_ep over LocalMesh(ep = 4) and one fp32 pipeline_lm
    step over (1, 2, 2) on the card against the same on the CPU: 1e-5 of
    each result's largest entry (the loss 1e-5)."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_pipeline_ranks as ranks

    for task in ("ep", "plm"):
        got = ranks.local_results(task, 4, cuda)
        want = ranks.local_results(task, 4, "cpu")
        for r in want:
            for key, w in want[r].items():
                tol = 1e-5 * max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[r][key], w, rtol=0, atol=tol,
                                           err_msg=f"{task} {r} {key}")


def test_pipeline_paths_over_nccl_match_the_local_mesh(cuda, tmp_path):
    """shift, all_to_all, the ZB-H1 / ZB-V / GPipe steps, the expert-parallel
    forward and a pipeline_lm step over a DeviceMesh, one process a card
    (NCCL; 4 ranks on four cards, 2 on two), against a LocalMesh of the
    same shape on one card: 1e-5 of each array's largest entry (NCCL adds
    in its own order)."""
    import sys

    n = _cards()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_pipeline_ranks as ranks

    torch.multiprocessing.start_processes(
        ranks.run_rank, args=(n, str(tmp_path / "store"), str(tmp_path),
                              "nccl"),
        nprocs=n, join=True, start_method="spawn")
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]
    for task in ranks.tasks(n):
        local = ranks.local_results(task, n, cuda)
        for r in range(n):
            for key, w in local[r].items():
                tol = 1e-5 * max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[r][f"{task}.{key}"], w,
                                           rtol=0, atol=tol,
                                           err_msg=f"rank {r} {task} {key}")


# -- MoE and MLA blocks on the card ---------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)])
def test_matmul_q8_over_routed_rows_at_mixtral_expert_shapes(cuda, m, k, n):
    """K5 at the products a routed Mixtral-8x7B-v0.1 expert runs in the
    decode step: m = the rows routed to it (1 to 8 slots) against its
    4096 x 14336 gate / up and 14336 x 4096 down; bit for bit the plain
    version (the exact integer sum times the same scales)."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + k)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda).to(torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda).to(torch.int8)
    sa = torch.rand(m, generator=gen, device=cuda) * 0.02 + 0.001
    sb = torch.rand(n, generator=gen, device=cuda) * 0.02 + 0.001
    before = tq.matmul_q8.launches
    got = tq.matmul_q8(a, b, sa, sb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tq.matmul_q8.launches == before + 1
    assert torch.equal(got, tq.matmul_q8_plain(a, b, sa, sb,
                                               out_dtype=torch.float32))


def test_moe_decode_runs_k5_over_each_experts_routed_rows(cuda):
    """A w8 MoE server's decode step launches K5 three times for each
    expert that got a row, with m = its routed rows, plus wqkv, wo a layer
    and the head; the tokens equal the same server on the CPU."""
    cfg = transformer.TransformerConfig(**dict(SMALL, n_experts=4,
                                               moe_top_k=2))
    params = transformer.init_params(0, cfg, device="cpu")
    params["embed"] = params["embed"] * 40
    prompts = ([3, 5, 7], [9, 1, 4, 4, 7])

    def drive(dev):
        p = _to(params, dev)
        srv = serve.InferenceServer(p, cfg, batch_slots=2, page_size=16,
                                    n_pages=16, max_pages_per_seq=2,
                                    quantize_weights=True, device=dev)
        rids = [srv.submit(pr, max_new=4) for pr in prompts]
        return srv, [srv.run()[r] for r in rids]

    rows = []
    real = tq.gemm_w8

    def spy(a, *args, **kw):
        rows.append(a.shape[0])
        return real(a, *args, **kw)

    _, want = drive("cpu")
    before = tq.matmul_q8.launches
    serve.gemm_w8, saved = spy, serve.gemm_w8
    try:
        srv, got = drive(cuda)
    finally:
        serve.gemm_w8 = saved
    torch.cuda.synchronize()
    assert got == want
    assert tq.matmul_q8.launches - before == len(rows)
    assert all(1 <= m <= 2 for m in rows)  # 2 slots, an expert's share
    steps = srv.decode_steps
    assert (len(rows) - (2 * cfg.n_layers + 1) * steps) % 3 == 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_block_with_equal_head_dims_runs_k1_k2(cuda, dtype):
    """An MLA block whose head dims are equal (qk_nope 64 + qk_rope 64 =
    v 128) runs K1 forward and K2 backward once each; its output and
    gradients stand within the flash kernels' tolerances of the plain
    attention path (ops.attention.plain_attention) over the same weights."""
    from kfunca_tpu_torch.models import mla

    cfg = transformer.TransformerConfig(
        vocab_size=64, d_model=256, n_heads=4, n_layers=1, d_ff=128,
        dtype="float32" if dtype == torch.float32 else "bfloat16",
        attention="mla", q_lora_rank=96, kv_lora_rank=64)
    params = transformer.init_params(0, cfg, device=cuda)
    blk = params["blocks"][0]
    gen = torch.Generator(device=cuda).manual_seed(1)
    y = torch.randn((2, 200, 256), generator=gen, device=cuda).to(dtype)

    def run():
        leaves = [blk[k] for k in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv",
                                   "wo")]
        for t in leaves:
            t.requires_grad_(True)
        yy = y.detach().requires_grad_(True)
        out = mla.mla_attention(yy, blk, cfg)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [yy] + leaves)
        for t in leaves:
            t.requires_grad_(False)
        return out, grads

    n1, n2 = (fa.flash_attention_fwd_stats.launches,
              fa.flash_attention_backward.launches)
    out, grads = run()
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_stats.launches == n1 + 1
    assert fa.flash_attention_backward.launches == n2 + 1
    with attention.plain_attention():
        want, want_g = run()
    # fp32: the kernels' 1e-4; bf16: the flash kernels' 2^-7 of max |ref|,
    # widened by the projections' own bf16 roundings on both paths
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    for got, ref in zip((out,) + grads, (want,) + want_g):
        ref = ref.float()
        torch.testing.assert_close(got.float(), ref, rtol=tol,
                                   atol=tol * float(ref.abs().max()))


# -- the finetuning stack: LoRA, QLoRA, multi-LoRA serving, distillation ------


def _lora_case(cfg, dev, targets, seed=1, b_std=0.02):
    from kfunca_tpu_torch.models import lora

    gen = torch.Generator(device=dev).manual_seed(seed)
    ad = lora.init_lora(gen, cfg, rank=4, targets=targets, alpha=8.0)
    for blk in ad["blocks"]:
        for ab in blk.values():
            ab["B"] = torch.randn(ab["B"].shape, generator=gen,
                                  device=dev) * b_std
    return ad


def test_lora_step_on_the_kernels_matches_the_plain_path(cuda):
    """Two LoRA steps (all five targets, fp32) on K1/K2 against the same
    steps with the attention on its plain version: losses within 1e-5,
    adapters within 1e-4; K1 and K2 once a layer a step; the base gets no
    gradient."""
    from kfunca_tpu_torch.models import lora
    from kfunca_tpu_torch.utils.tree import tree_leaves

    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device=cuda)
    targets = ("wqkv", "wo", "w_gate", "w_up", "w_down")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (2, 65)) for _ in range(2)]

    def run():
        ad = _lora_case(cfg, cuda, targets)
        oc = train.OptConfig(lr=1e-2, weight_decay=0.0)
        opt = train.init_opt_state(ad["blocks"], oc)
        step = lora.make_lora_train_step(params, cfg, oc)
        losses = []
        for w in batches:
            ad, opt, loss = step(ad, opt, w[:, :-1], w[:, 1:])
            losses.append(float(loss))
        return losses, tree_leaves(ad["blocks"])

    n1, n2 = (fa.flash_attention_fwd_stats.launches,
              fa.flash_attention_backward.launches)
    got, got_ad = run()
    assert fa.flash_attention_fwd_stats.launches - n1 == cfg.n_layers * 2
    assert fa.flash_attention_backward.launches - n2 == cfg.n_layers * 2
    with attention.plain_attention():
        want, want_ad = run()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for g, w in zip(got_ad, want_ad):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(1.0, float(w.abs().max())))
    assert all(t.grad is None for t in tree_leaves(params))


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_backward_saves_only_the_quantized_pairs(cuda, bits):
    """A bf16 block over a quantize_base block keeps no float tensor of a
    weight's shape for its backward and no more memory than the bf16
    block (whose saved weights are the params themselves); its input
    gradient is that of the dequantized weights'."""
    from kfunca_tpu_torch.models import lora
    from kfunca_tpu_torch.ops.quant import dequant_weight

    cfg = transformer.TransformerConfig(**dict(SMALL, dtype="bfloat16"))
    params = transformer.init_params(0, cfg, device=cuda,
                                     dtype=torch.bfloat16)
    blk = params["blocks"][0]
    qblk = lora.quantize_base(params, bits)["blocks"][0]
    names = ("wqkv", "wo", "w_gate", "w_up", "w_down")
    shapes = {tuple(blk[k].shape) for k in names}
    x = torch.randn((2, 128, cfg.d_model), device=cuda).to(torch.bfloat16)

    def graph(p):
        floats = []

        def pack(t):
            if t.is_floating_point() and tuple(t.shape) in shapes:
                floats.append(tuple(t.shape))
            return t

        xx = x.detach().requires_grad_(True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = transformer._block(xx, p, cfg)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        out.float().sum().backward()
        return grown, floats, xx.grad

    fp_grown, _, _ = graph(blk)
    q_grown, q_floats, dx = graph(qblk)
    assert q_floats == []
    assert q_grown <= fp_grown
    deq = {k: dequant_weight(*qblk[k], torch.bfloat16) for k in names}
    _, _, want = graph({**blk, **deq})
    torch.testing.assert_close(dx.float(), want.float(), rtol=0,
                               atol=1e-6 * float(want.float().abs().max()))


@pytest.mark.parametrize("kw", [{}, dict(quantize_weights=True,
                                         quantize_kv=True)],
                         ids=["fp32", "w8kv8"])
def test_multi_lora_decode_on_the_kernels_matches_the_plain_path(cuda, kw):
    """A mixed-adapter batch decoded on K4 (K4-int8 and K5 with w8kv8)
    against the plain kernels' versions on the card and against the same
    server on the CPU: equal tokens; K4 once a layer a step, and with w8
    weights K5 (5 x layers + 1) times a step."""
    from kfunca_tpu_torch.models import lora

    cfg = transformer.TransformerConfig(**SMALL)
    params = transformer.init_params(0, cfg, device="cpu")
    ads = [lora.to_serving(_lora_case(cfg, "cpu", ("wqkv",), seed=s,
                                      b_std=0.2)) for s in (1, 2)]
    prompts = [[3, 5, 7], list(range(1, 30)), [9, 9, 2, 4], [4, 1, 6]]
    ids = [0, 1, 2, 1]

    def drive(dev, plain=False):
        srv = serve.InferenceServer(_to(params, dev), cfg, batch_slots=4,
                                    page_size=16, n_pages=32,
                                    max_pages_per_seq=4, max_loras=2,
                                    lora_rank=4, device=dev, **kw)
        for a in ads:
            srv.register_lora(a)
        rids = [srv.submit(p, max_new=8, lora_id=i)
                for p, i in zip(prompts, ids)]
        if plain:
            with pa.plain_paged_attention(), tq.plain_matmul_q8():
                out = srv.run()
        else:
            out = srv.run()
        return [out[r] for r in rids], srv.decode_steps

    want, _ = drive("cpu")
    plain, _ = drive(cuda, plain=True)
    pa.paged_decode_attention_dma.launches = tq.matmul_q8.launches = 0
    got, steps = drive(cuda)
    assert got == plain == want
    assert pa.paged_decode_attention_dma.launches == cfg.n_layers * steps
    assert tq.matmul_q8.launches == ((5 * cfg.n_layers + 1) * steps
                                     if kw else 0)


def test_chunked_kd_kl_on_the_card_matches_the_cpu(cuda):
    """chunked_kd_kl's value and student gradients on the card (vocab 1000
    in chunks of 384, tau 2) against the CPU's: 1e-5 and 1e-4 of
    max(1, max |ref|)."""
    from kfunca_tpu_torch.models.distill import chunked_kd_kl

    gen = torch.Generator().manual_seed(0)
    x_s, w_s = torch.randn(96, 48, generator=gen), torch.randn(
        48, 1000, generator=gen) * 0.2
    x_t, w_t = torch.randn(96, 64, generator=gen), torch.randn(
        64, 1000, generator=gen) * 0.2
    g = torch.randn(96, generator=gen)

    def run(dev):
        xs = x_s.to(dev).clone().requires_grad_(True)
        ws = w_s.to(dev).clone().requires_grad_(True)
        kl = chunked_kd_kl(xs, ws, x_t.to(dev), w_t.to(dev), 384, 2.0)
        (kl * g.to(dev)).sum().backward()
        return [t.detach().cpu() for t in (kl, xs.grad, ws.grad)]

    want = run("cpu")
    got = run(cuda)
    for g_, w_, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        torch.testing.assert_close(g_, w_, rtol=0,
                                   atol=tol * max(1.0, float(w_.abs().max())))


def _grads_on_both_paths(loss_fn, params):
    """(loss, grads) through K1/K2 and through the plain attention, with
    the kernels' launches of the first run."""
    from kfunca_tpu_torch.utils.tree import tree_leaves

    n = (fa.flash_attention_fwd_stats.launches,
         fa.flash_attention_backward.launches,
         fa.flash_attention_fwd_stats.launches_wgmma,
         fa.flash_attention_backward.launches_wgmma)
    loss, _, grads = train.value_and_grad_aux(lambda p: (loss_fn(p), None),
                                              params)
    took = (fa.flash_attention_fwd_stats.launches - n[0],
            fa.flash_attention_backward.launches - n[1],
            fa.flash_attention_fwd_stats.launches_wgmma - n[2],
            fa.flash_attention_backward.launches_wgmma - n[3])
    with attention.plain_attention():
        ref, _, ref_grads = train.value_and_grad_aux(
            lambda p: (loss_fn(p), None), params)
    return (loss, tree_leaves(grads)), (ref, tree_leaves(ref_grads)), took


def _hold_step_parity(dtype, loss, grads, ref, ref_grads, took):
    """K1 and K2 once a layer (2 layers), bf16 on the wgmma bodies; fp32:
    the loss within 1e-5 of the plain path's and every gradient within
    1e-4 of its leaf's largest entry; bf16 (whose products round another
    way on each path, carried through the blocks): the loss within 2^-7
    and every gradient finite."""
    bf16 = int(dtype == "bfloat16")
    assert took == (2, 2, 2 * bf16, 2 * bf16)
    assert all(torch.isfinite(g).all() for g in grads)
    if bf16:
        assert abs(float(loss) - float(ref)) <= 2.0 ** -7
        return
    assert abs(float(loss) - float(ref)) <= 1e-5
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-4 * max(
            float(r.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multimodal_step_runs_k1_k2_on_its_text_blocks(cuda, dtype):
    """The multimodal prefix LM's text blocks take K1 and K2 once a layer
    over N + T positions (bf16 on the wgmma bodies), held against the plain
    attention path as _hold_step_parity says."""
    from kfunca_tpu_torch.models import vision

    vit = vision.ViTConfig(image_size=32, patch_size=8, d_model=64,
                           n_heads=2, n_layers=1, d_ff=128, dtype=dtype)
    text = transformer.TransformerConfig(vocab_size=128, d_model=128,
                                         n_heads=2, n_layers=2, d_ff=256,
                                         max_seq_len=64, dtype=dtype)
    cfg = vision.MultimodalConfig(vit=vit, text=text)
    params = vision.init_multimodal_params(0, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    images = torch.randn((2, 32, 32, 3), generator=gen, device=cuda)
    tokens = torch.randint(0, 128, (2, 24), generator=gen, device=cuda)
    (loss, grads), (ref, ref_grads), took = _grads_on_both_paths(
        lambda p: vision.multimodal_loss(p, images, tokens, tokens, cfg),
        params)
    _hold_step_parity(dtype, loss, grads, ref, ref_grads, took)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_text_tower_runs_k1_k2(cuda, dtype):
    """CLIP's text tower (transformer.hidden_states) takes K1 and K2 once a
    layer, held against the plain attention path as _hold_step_parity
    says."""
    from kfunca_tpu_torch.models import clip, vision

    vit = vision.ViTConfig(image_size=32, patch_size=16, d_model=64,
                           n_heads=2, n_layers=1, d_ff=128, dtype=dtype)
    text = transformer.TransformerConfig(vocab_size=128, d_model=128,
                                         n_heads=2, n_layers=2, d_ff=256,
                                         max_seq_len=32, dtype=dtype)
    cfg = clip.ClipConfig(vit=vit, text=text, embed_dim=32)
    params = clip.init_clip_params(0, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    images = torch.randn((8, 32, 32, 3), generator=gen, device=cuda)
    tokens = torch.randint(0, 128, (8, 17), generator=gen, device=cuda)
    (loss, grads), (ref, ref_grads), took = _grads_on_both_paths(
        lambda p: clip.clip_loss(p, images, tokens, cfg)[0], params)
    _hold_step_parity(dtype, loss, grads, ref, ref_grads, took)


def test_mamba2_gradients_are_finite_at_chunk_256(cuda):
    """32 heads (A = -1..-32) and chunk 256 over 256 tokens: where the JAX
    reference's decay square overflows and its gradients turn NaN, the
    port's are finite on the card, and its fp32 forward is the CPU's."""
    from kfunca_tpu_torch.models import mamba2
    from kfunca_tpu_torch.utils.tree import tree_leaves

    cfg = mamba2.Mamba2Config(vocab_size=64, d_model=64, n_layers=1,
                              n_heads=32, head_dim=4, d_state=16,
                              chunk_size=256, dtype="float32")
    params = mamba2.init_mamba2_params(1, cfg, device=cuda)
    tokens = torch.randint(0, 64, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(3))
    loss, _, grads = train.value_and_grad_aux(
        lambda p: (mamba2.loss_fn(p, tokens[:, :-1], tokens[:, 1:], cfg),
                   None), params)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    cpu = [t.cpu() for t in tree_leaves(params)]
    from kfunca_tpu_torch.utils.tree import tree_unflatten

    want = mamba2.forward(tree_unflatten(params, cpu), tokens.cpu(), cfg)
    got = mamba2.forward(params, tokens, cfg).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


def test_serving_examples_run_on_the_card(cuda):
    """serve_lm and serve_hf (its hermetic tiny Llama, w8kv8) through
    main(argv) on the card: every request completes, K4 runs layers x
    decode steps times, and serve_hf's int8 products K5 (5 x layers + 1)
    x decode steps times."""
    from kfunca_tpu_torch.examples import serve_hf, serve_lm

    out = serve_lm.main(["--requests", "6", "--max-new", "8"])
    steps = out["stats"]["decode_steps"]
    assert out["stats"]["completed"] == 6 and steps > 0
    assert out["launches"]["K4"] == 4 * steps
    out = serve_hf.main(["--requests", "3", "--max-new", "8"])
    steps = out["stats"]["decode_steps"]
    assert out["stats"]["completed"] == 3 and steps > 0
    assert out["launches"]["K4"] == 4 * steps
    assert out["launches"]["K5"] == (5 * 4 + 1) * steps
