"""The port's CUDA kernels on the card (skipped where there is none).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at small shapes, with the tolerances stated below, and the
serving engine on the card is held against the same engine on the CPU.
This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

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
# on the neighbouring bf16 value, 2^-8 of the magnitude away.
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-6, 2.0 ** -7)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_decode_attention_dma(q.half(), pool.half(), tables, pos)
    with pytest.raises(TypeError, match="one dtype"):
        paged_decode_attention_dma(q, pool.bfloat16(), tables, pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention_dma(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), pool, tables, pos)
    with pytest.raises(ValueError, match="different devices"):
        paged_decode_attention_dma(q, pool, tables.cpu(), pos)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("m,k,n", [(8, 512, 384), (1, 96, 40), (5, 130, 67),
                                   (37, 300, 129), (300, 2048, 256),
                                   (8, 4096, 4096)])
def test_matmul_q8_kernel_is_bit_equal_to_plain(cuda, m, k, n):
    """fp32 output: the exact integer sum times the same two scales in the
    same order, so the kernel and the plain version agree bit for bit;
    bf16 output rounds that value once more (at most one bf16 step)."""
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
    got16, want16 = tq.matmul_q8(a, b, sa, sb), tq.matmul_q8_plain(a, b, sa, sb)
    torch.testing.assert_close(got16.float(), want16.float(), atol=0,
                               rtol=2.0 ** -7)
    with tq.plain_matmul_q8():
        assert torch.equal(tq.matmul_q8(a, b, sa, sb, torch.float32), want)
    assert tq.matmul_q8.launches == before + 2


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
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse,
                                             window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_stats.launches == n1 + 1
    assert fa.flash_attention_backward.launches == n2 + 1
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


def test_flash_rows_without_a_column_and_unread_kv_rows(cuda):
    """Window 64 with Sq 300 over Skv 64: rows >= 127 see no column and get
    out = 0, lse = 0 and dq = 0.  Skv 160 over Sq 100: kv rows >= 100 are
    read by no q row and get exact-zero dk/dv."""
    q, k, v, g = _flash_inputs(cuda, torch.float32, (1, 2, 1, 300, 64, 64, 64))
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=64)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse, window=64)
    assert not out[:, :, 127:].any() and not lse[:, :, 127:].any()
    assert not dq[:, :, 127:].any() and out[:, :, :127].abs().min() > 0
    q, k, v, g = _flash_inputs(cuda, torch.float32, (1, 2, 2, 100, 160, 64, 0))
    out, lse = fa.flash_attention_fwd_stats(q, k, v)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse)
    assert not dk[:, :, 100:].any() and not dv[:, :, 100:].any()
    assert dk[:, :, :100].abs().min() > 0


def test_flash_backward_is_bitwise_repeatable(cuda):
    q, k, v, g = _flash_inputs(cuda, torch.bfloat16, (1, 8, 2, 512, 512, 128, 200))
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=200)
    a = fa.flash_attention_backward(q, k, v, g, out, lse, window=200)
    b = fa.flash_attention_backward(q, k, v, g, out, lse, window=200)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


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
    with pytest.raises(ValueError, match="limit of 128"):
        big = torch.zeros((1, 1, 8, 160), device=cuda)
        fa.flash_attention_fwd_stats(big, big, big)
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention_fwd_stats(q, k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd_stats(q, k, v, window=0)


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
    before = (mm.matmul.launches, rd.reduce_2d.launches, ew.elementwise.launches)
    card = _eager_mlp_step(kfunca, 0, x, w1, w2)
    torch.cuda.synchronize()
    after = (mm.matmul.launches, rd.reduce_2d.launches, ew.elementwise.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (6, 1, 9)
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
    monkeypatch.setenv("KFUNCA_PALLAS_SORT", "1")
    t = kfunca.from_numpy(np.arange(10, dtype=np.float32), 0)
    with pytest.raises(NotImplementedError, match="K10"):
        t.sort(0, False)
    # CPU tensors take the default sort, as the JAX package off the TPU
    vals, _ = kfunca.from_numpy(np.arange(10, dtype=np.float32), "cpu").sort(0, True)
    assert vals.numpy().tolist() == list(range(9, -1, -1))


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
