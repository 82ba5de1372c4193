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

`autotune(op, *shape)` sweeps only launch parameters the port's kernels
take:
  * "gemm" (m, k, n): K3's output tile (bm, bn) of its wgmma body
    (csrc/matmul.cu, ops/pallas_kernels/matmul.TILES); ops/gemm.matmul_2d
    under KFUNCA_GEMM_ENGINE=pallas reads the winner;
  * "decode_page" (slots, Hkv * hd, context): the KV page size of K4, the
    fused-pool paged decode attention (csrc/paged_attention.cu);
    InferenceServer(page_size=None) reads the winner, else takes 16.
The JAX package's other ops raise NotImplementedError naming their kernel,
whose tile is fixed in the port (FIXED_TILE); an unknown op raises
ValueError.  Candidates run in turns (a round over all of them, `reps`
rounds) and each keeps its median: on the card each time is CUDA events
around `iters` launches after a warm-up; on the CPU, where the plain
versions run and take no launch parameter, the host clock.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

import numpy as np
import torch

from ..ops.pallas_kernels.matmul import TILES as K3_TILES

_LOCK = threading.Lock()
_CACHE: dict | None = None
_DEFAULTS: dict | None = None

SWEEPS = {
    "gemm": [{"bm": bm, "bn": bn} for bm, bn in K3_TILES],
    "decode_page": [{"page_size": 8}, {"page_size": 16}, {"page_size": 32}],
}
# the JAX package's other sweeps, and the port kernel whose tile is fixed
FIXED_TILE = {
    "gemm_q8": "K5 matmul_q8 (csrc/quant.cu)",
    "attn_fwd": "K1 flash_attention_fwd_stats (csrc/flash_attention.cu)",
    "attn_bwd": "K2 flash_attention_backward (csrc/flash_attention.cu)",
    "reduce": "K8 reduce_2d (csrc/reduce.cu)",
    "welford": "K7 welford_norm_stat (csrc/reduce.cu)",
}


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
        pkg = os.path.join(os.path.dirname(__file__), "autotune_defaults.json")
        with open(pkg) as f:
            _DEFAULTS = json.load(f)
    if _CACHE is None:
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


def record(op: str, shape_class: str, dtype, params: dict) -> None:
    """Persist measured-best params (the cache file is replaced whole)."""
    with _LOCK:
        _load()
        _CACHE[_key(op, shape_class, dtype)] = dict(params)
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


def autotune(op: str, *shape: int, dtype=None, candidates: list | None = None,
             reps: int = 3, iters: int = 10, device=None,
             verbose: bool = True) -> dict:
    """Sweep `op`'s launch parameters at `shape` on the card (or, with
    device="cpu", through the plain versions) and record the winner, so
    later dispatches at this shape class use it.

        kfunca.autotune("gemm", 4096, 4096, 4096)        # m, k, n
        kfunca.autotune("decode_page", 8, 1024, 4096)    # slots, Hkv*hd, context

    Returns {"params", "ms", "tflops", "all"}."""
    if op in FIXED_TILE:
        raise NotImplementedError(
            f"autotune: {op!r} tunes {FIXED_TILE[op]}, whose tile is fixed "
            f"in the port; only {sorted(SWEEPS)} take launch parameters")
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
        "all": [{"params": dict(c), "ms": t} for c, t in zip(cands, medians)],
    }
    if verbose:
        print(f"[autotune] {op} {bucket} {dtype_name(dtype)} on {dev.type} -> "
              f"{result['params']} ({result['ms']:.4f} ms)", flush=True)
    return result
