"""The port's CUDA kernels on the card (skipped where there is none).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at small shapes, with the tolerances stated below, and the
serving engine on the card is held against the same engine on the CPU.
This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from kfunca_tpu_torch.models import serve, transformer
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
