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

from kfunca_tpu_torch.models import data, serve, train, transformer
from kfunca_tpu_torch.ops import attention
from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as fa
from kfunca_tpu_torch.ops.pallas_kernels.paged_attention import (
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
