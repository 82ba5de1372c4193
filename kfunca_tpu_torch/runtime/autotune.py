"""Per-card launch-parameter autotuning cache.

Counterpart of kfunca_tpu/runtime/autotune.py: a JSON cache keyed by
(card, op, shape class, dtype) records the best-measured launch
parameters; `autotune_defaults.json` beside this module ships only entries
that chip_smoke.py's autotune phase measured on the card (the JAX
package's v5e entries do not carry over), and the user cache overlays it;
callers consult `lookup()` at dispatch time, so a later `record()` changes
later launches.

The card is named by torch.cuda.get_device_name (spaces as dashes), "cpu"
without one.  The cache is KFUNCA_AUTOTUNE_CACHE, or else
~/.cache/kfunca_tpu_torch_autotune.json, never the JAX package's file.

`autotune(op, *shape)` sweeps the launch parameters the port's kernels
take, at the JAX package's shape arguments and cache keys:
  * "gemm" (m, k, n): K3's output tile (bm, bn) of its wgmma body
    (csrc/matmul.cu, ops/pallas_kernels/matmul.TILES); ops/gemm.matmul_2d
    under KFUNCA_GEMM_ENGINE=pallas reads the winner;
  * "gemm_q8" (m, k, n), keyed "int8": K5's split-k plan
    (ops/quant.q8_plan: the blocks it aims at, `wave`, and the fewest
    64-row stages a k slice is cut to, `min_stages`); ops/quant.
    matmul_q8_auto (and so gemm_w8) reads the winner.  Integer sums are
    exact, so every candidate gives the same bits;
  * "attn_fwd" / "attn_bwd" (b, h, s, d), keyed by shape_bucket(s, s, d):
    K1's and K2's bf16 tiles built for the head dim d (ops/pallas_kernels/
    flash_attention.fwd_tiles(d), bwd_tiles(d): the kv / q rows a stage
    streams and the ring's depth); ops/attention.causal_attention_fn and
    the eager causal_attention read the winners, as the JAX package's
    _tuned_blocks;
    the windowed make_flash_attention reads nothing, as the JAX package's;
  * "reduce" / "welford" (r, c), keyed "float32": the blocks K8's and K7's
    split count aims at (ops/pallas_kernels/welford.split_count's
    `target`); reduce_2d and welford_norm_stat read the winner through
    welford.split_target (the JAX package's reductions take no tuned
    blocks, so this reader is the port's own);
  * "decode_page" (slots, Hkv * hd, context): the KV page size of K4, the
    fused-pool paged decode attention (csrc/paged_attention.cu);
    InferenceServer(page_size=None) reads the winner, else takes 16.
An unknown op raises ValueError, as does a dtype whose kernel has one tile
(K3 in fp32, K1 and K2 in fp32).  Candidates run in turns (a round over all
of them, `reps` rounds) and each keeps its median: on the card each time
is CUDA events around `iters` launches after a warm-up; on the CPU, where
the plain versions run and take no launch parameter, the host clock (the
machinery, not a device time).

A caller that consults the cache on every launch goes through `tuned()`,
which memoizes the looked-up parameters per (op, shape, dtype); record()
clears the memo, so a later record() changes later launches.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

import numpy as np
import torch

from ..ops.pallas_kernels.flash_attention import (BWD_TILES, FWD_TILES,
                                                 bwd_tiles, fwd_tiles)
from ..ops.pallas_kernels.matmul import TILES as K3_TILES
from ..ops.pallas_kernels.welford import TARGET_BLOCKS
from ..ops.quant import Q8_MIN_STAGES, Q8_WAVE

_LOCK = threading.Lock()
_CACHE: dict | None = None
_DEFAULTS: dict | None = None
_MEMO: dict = {}  # tuned(): (op, dims, dtype) -> params

# each op's candidates, today's launch parameters first
SWEEPS = {
    "gemm": [{"bm": bm, "bn": bn} for bm, bn in K3_TILES],
    "gemm_q8": [{"wave": w, "min_stages": st} for w, st in (
        (Q8_WAVE, Q8_MIN_STAGES), (Q8_WAVE // 2, Q8_MIN_STAGES),
        (2 * Q8_WAVE, Q8_MIN_STAGES), (Q8_WAVE, 2), (Q8_WAVE, 8))],
    "attn_fwd": [dict(t) for t in FWD_TILES],
    "attn_bwd": [dict(t) for t in BWD_TILES],
    "reduce": [{"target_blocks": TARGET_BLOCKS * f // 4}
               for f in (4, 1, 2, 8, 16)],
    "decode_page": [{"page_size": 8}, {"page_size": 16}, {"page_size": 32}],
}
SWEEPS["welford"] = [dict(c) for c in SWEEPS["reduce"]]


@functools.cache
def _card_name() -> str:
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0).replace(" ", "-")
    return "cpu"


def chip_name() -> str:
    """The card's name, spaces as dashes ("cpu" without a card)."""
    return _card_name()


def cache_path() -> str:
    p = os.environ.get("KFUNCA_AUTOTUNE_CACHE")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "kfunca_tpu_torch_autotune.json")


def _load() -> None:
    global _CACHE, _DEFAULTS
    if _DEFAULTS is None:
        _MEMO.clear()
        pkg = os.path.join(os.path.dirname(__file__), "autotune_defaults.json")
        with open(pkg) as f:
            _DEFAULTS = json.load(f)
    if _CACHE is None:
        _MEMO.clear()
        try:
            with open(cache_path()) as f:
                _CACHE = json.load(f)
        except (OSError, ValueError):
            _CACHE = {}


def shape_bucket(*dims: int) -> str:
    """Power-of-two shape class: 4096x4000x4096 and 4096^3 share params."""
    out = []
    for d in dims:
        d = int(d)
        out.append(str(1 << max(0, (d - 1).bit_length())) if d > 0 else "0")
    return "x".join(out)


def dtype_name(dtype) -> str:
    """'bfloat16' for torch.bfloat16 or the string 'bfloat16'."""
    return str(dtype).removeprefix("torch.")


def _key(op: str, shape_class: str, dtype) -> str:
    return f"{chip_name()}|{op}|{shape_class}|{dtype_name(dtype)}"


def lookup(op: str, shape_class: str, dtype) -> dict | None:
    """Best-known params for this (card, op, shape class, dtype), or None.
    The measured user cache overlays the shipped defaults."""
    with _LOCK:
        _load()
        k = _key(op, shape_class, dtype)
        hit = _CACHE.get(k, _DEFAULTS.get(k))
        return dict(hit) if hit is not None else None


def tuned(op: str, dims: tuple, dtype) -> dict:
    """lookup(op, shape_bucket(*dims), dtype), or {} without an entry,
    memoized per (op, dims, dtype): what a launch consults costs a dict
    lookup, not a bucket and a key.  Callers must not change the dict."""
    key = (op, dims, dtype)
    hit = _MEMO.get(key) if _CACHE is not None and _DEFAULTS is not None \
        else None
    if hit is None:
        hit = lookup(op, shape_bucket(*dims), dtype) or {}
        with _LOCK:
            if len(_MEMO) >= 4096:  # shapes without end (a decode loop's)
                _MEMO.clear()
            _MEMO[key] = hit
    return hit


def record(op: str, shape_class: str, dtype, params: dict) -> None:
    """Persist measured-best params (the cache file is replaced whole) and
    clear tuned()'s memo."""
    with _LOCK:
        _load()
        _CACHE[_key(op, shape_class, dtype)] = dict(params)
        _MEMO.clear()
        p = cache_path()
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(_CACHE, f, indent=1, sort_keys=True)
        os.replace(tmp, p)


def _time_ms(fn, device, iters: int) -> float:
    """Milliseconds a call of fn: CUDA events around `iters` calls on the
    card, the host clock on the CPU; one warm-up call first."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _gemm_case(m, k, n, dtype, device, gen):
    from ..ops.pallas_kernels.matmul import matmul

    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)

    def make(params):
        return lambda: matmul(a, b, bm=params["bm"], bn=params["bn"])

    return make, 2.0 * m * k * n


def _decode_page_case(slots, hd_total, context, dtype, device, gen):
    """K4 over a fused pool at each candidate page size: every slot live
    at position context - 1, one query head a kv head of width 128."""
    from ..ops.pallas_kernels.paged_attention import paged_decode_attention_dma

    h, hd = max(1, hd_total // 128), 128
    q = (torch.randn((slots, h, hd), generator=gen, device=device)
         / np.sqrt(hd)).to(dtype)
    positions = torch.full((slots,), context - 1, dtype=torch.int32,
                           device=device)

    def make(params):
        page = params["page_size"]
        max_pages = -(-context // page)
        pool = torch.randn((slots * max_pages + 1, page, 2 * h * hd),
                           generator=gen, device=device).to(dtype)
        tables = (torch.arange(slots * max_pages, dtype=torch.int32,
                               device=device).reshape(slots, max_pages) + 1)
        return lambda: paged_decode_attention_dma(q, pool, tables, positions)

    return make, 4.0 * slots * h * hd * context


def _q8_case(m, k, n, device, gen):
    """K5 at each candidate split plan, bf16 out, from random int8."""
    from ..ops.quant import matmul_q8

    a = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    sa = torch.rand((m,), generator=gen, device=device) / 127
    sb = torch.rand((n,), generator=gen, device=device) / 127

    def make(params):
        return lambda: matmul_q8(a, b, sa, sb, **params)

    return make, 2.0 * m * k * n


def _attn_case(b, h, s, d, dtype, device, gen, bwd):
    """K1 (without the statistic, as the JAX package's sweep) or K2 from
    the default forward's (out, lse), at each candidate tile."""
    from ..ops.pallas_kernels.flash_attention import (
        flash_attention_backward, flash_attention_fwd_stats)

    q, k, v, g = (torch.randn((b, h, s, d), generator=gen, device=device)
                  .to(dtype) for _ in range(4))
    flops = 0.5 * 4 * b * h * s * s * d  # the JAX package's causal count
    if not bwd:
        def make(params):
            return lambda: flash_attention_fwd_stats(q, k, v, False, **params)

        return make, flops
    out, lse = flash_attention_fwd_stats(q, k, v)

    def make(params):
        return lambda: flash_attention_backward(q, k, v, g, out, lse, **params)

    return make, 3.5 * flops


def _reduce_case(r, c, device, gen, welford):
    """K8's column sum or K7's statistics of an fp32 (r, c) matrix at each
    candidate split target."""
    from ..ops.pallas_kernels.reduce import reduce_2d
    from ..ops.pallas_kernels.welford import welford_norm_stat

    x = torch.randn((r, c), generator=gen, device=device)

    def make(params):
        if welford:
            return lambda: welford_norm_stat(x, **params)
        return lambda: reduce_2d(x, "sum", **params)

    # the JAX package's unit: adds (Welford ~3 operations an element)
    return make, float(r * c) * (3.0 if welford else 1.0)


def autotune(op: str, *shape: int, dtype=None, candidates: list | None = None,
             reps: int = 3, iters: int = 10, device=None,
             verbose: bool = True) -> dict:
    """Sweep `op`'s launch parameters at `shape` on the card (or, with
    device="cpu", through the plain versions) and record the winner, so
    later dispatches at this shape class use it.

        kfunca.autotune("gemm", 4096, 4096, 4096)        # m, k, n
        kfunca.autotune("gemm_q8", 8, 4096, 14336)       # m, k, n
        kfunca.autotune("attn_fwd", 1, 32, 8192, 128)    # b, h, s, d
        kfunca.autotune("attn_bwd", 1, 32, 8192, 128)
        kfunca.autotune("reduce", 16387, 16387)          # rows, cols
        kfunca.autotune("welford", 16387, 16387)
        kfunca.autotune("decode_page", 8, 1024, 4096)    # slots, Hkv*hd, context

    Returns {"params", "ms", "tflops", "all"}: "all" holds each
    candidate's median ms and the spread (max - min) of its rounds."""
    if op not in SWEEPS:
        raise ValueError(f"autotune: unknown op {op!r} (supported: "
                         f"{sorted(SWEEPS)})")
    from .backend import resolve_device

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dtype is None else dtype
    cands = candidates or SWEEPS[op]
    gen = torch.Generator(device=dev).manual_seed(0)
    if op == "gemm":
        if dtype not in (torch.bfloat16, torch.float16):
            raise ValueError(f"autotune: K3's tile is tunable in bfloat16 "
                             f"and float16, got {dtype}")
        m, k, n = shape
        make, flops = _gemm_case(m, k, n, dtype, dev, gen)
        bucket = shape_bucket(m, k, n)
    elif op == "gemm_q8":
        m, k, n = shape
        dtype = "int8"  # the cache key of the JAX package's ops/quant.py
        make, flops = _q8_case(m, k, n, dev, gen)
        bucket = shape_bucket(m, k, n)
    elif op in ("attn_fwd", "attn_bwd"):
        if dtype != torch.bfloat16:
            raise ValueError(f"autotune: K1's and K2's tiles are tunable in "
                             f"bfloat16 (the {dtype} bodies have one), got "
                             f"{dtype}")
        b, h, s, d = shape
        if candidates is None:  # the tiles built for the head dim
            tiles = fwd_tiles(d) if op == "attn_fwd" else bwd_tiles(d)
            cands = [dict(t) for t in tiles]
        make, flops = _attn_case(b, h, s, d, dtype, dev, gen,
                                 op == "attn_bwd")
        bucket = shape_bucket(s, s, d)
    elif op in ("reduce", "welford"):
        r, c = shape
        dtype = torch.float32  # K7 and K8 accumulate in fp32
        make, flops = _reduce_case(r, c, dev, gen, op == "welford")
        bucket = shape_bucket(r, c)
    else:
        slots, hd_total, context = shape
        make, flops = _decode_page_case(slots, hd_total, context, dtype, dev,
                                        gen)
        bucket = shape_bucket(slots, hd_total)
    fns = [make(c) for c in cands]
    times = [[] for _ in cands]
    for r in range(reps):
        for i, fn in enumerate(fns):
            times[i].append(_time_ms(fn, dev, iters))
            if verbose:
                print(f"[autotune] {op} r{r} {cands[i]}: {times[i][-1]:.4f} "
                      f"ms", flush=True)
    medians = [float(np.median(ts)) for ts in times]
    best = min(range(len(cands)), key=medians.__getitem__)
    record(op, bucket, dtype, cands[best])
    result = {
        "params": dict(cands[best]),
        "ms": medians[best],
        "tflops": flops / (medians[best] * 1e-3) / 1e12,
        "all": [{"params": dict(c), "ms": t,
                 "spread_ms": float(max(ts) - min(ts))}
                for c, t, ts in zip(cands, medians, times)],
    }
    if verbose:
        print(f"[autotune] {op} {bucket} {dtype_name(dtype)} on {dev.type} -> "
              f"{result['params']} ({result['ms']:.4f} ms)", flush=True)
    return result
