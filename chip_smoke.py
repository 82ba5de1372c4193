#!/usr/bin/env python3
"""Drive the kfunca_tpu_torch port on one CUDA card and check it end to end.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card identity (nvidia-smi name and power limit);
  2. build every CUDA kernel from kfunca_tpu_torch/csrc with nvcc;
  3. hold the paged decode kernel against its plain PyTorch version at
     Mistral-7B-v0.1 attention widths (B=8, H=32, Hkv=8, hd=128, page 16),
     bf16 and fp32, no window / window 4096 / window 37, a layer-stacked
     page_base, NaN in pages no live slot reads, and an idle slot whose
     position is past the table width;
  4. time the kernel, its plain version and a library yardstick (page
     gather + scaled_dot_product_attention) at those shapes;
  5. serve requests through InferenceServer at Mistral-7B-v0.1 widths (all
     32 layers, bf16, random weights from a seed, untied lm_head) with
     decode_burst 1 and 4, plus an fp32 two-layer server; the kernel's
     launch count over these runs must equal layers x decode steps;
  6. hold the served log-probs against a plain full forward pass
     (forward_with_cache from a fresh cache; no paged kernel);
  7. profile a few decode steps of a full batch (device busy share, device
     time by kernel);
  8. hold the flash attention forward (K1) and backward (K2) kernels
     against their plain PyTorch versions at Mistral-7B-v0.1 attention
     widths (B=1, H=32, Hkv=8, hd=128, S=8192, window 4096; bf16 and fp32)
     and at small shapes that hit the edges (no window, window 37,
     Sq != Skv both ways, ragged tiles, head dims 64 and 40, a row with no
     valid column);
  9. time K1 and K2 (each alone), their plain versions and the library
     yardstick (scaled_dot_product_attention, forward and backward) at the
     full attention shape, beside the bound;
 10. take 6 AdamW training steps through make_train_step at Mistral-7B-v0.1
     widths (depth cut to 4 layers, 1 x 8192 tokens, bf16 activations, fp32
     master params), then 2 steps with loss_chunk and grad_accum; K1 and K2
     launches must each equal layers x steps (x microbatches);
 11. profile 2 training steps (device busy share, device time by kernel);
 12. hold the kernel path against the plain attention path end to end in
     fp32 (loss and every gradient of loss_fn, 2 layers at full width), and
     check that two kernel runs give bitwise-equal gradients;
 13. run the Trainer at a small config: fit with checkpoints, delete the
     last one, resume, and compare bitwise with the uninterrupted run;
 14. hold the int8-KV branch of the paged decode kernel (K4-int8), the
     split-pool entry point `paged_decode_attention` (K6; fp and int8) and
     the int8 matmul `matmul_q8` (K5) against their plain PyTorch versions
     at serving widths and at edge shapes (every pool and scale layout,
     windows, page_base, NaN in dead pages and dead scale rows, a position
     past the table; the six decode matmul shapes, ragged m/k/n, m = 1 and
     m = 300);
 15. time each beside its bound, its plain version and a library yardstick
     (page gather + dequantize + scaled_dot_product_attention;
     torch._int_mm with m padded to 32 and the two scale multiplies);
 16. serve the phase-5 traffic at Mistral-7B-v0.1 widths, 32 layers, with
     quantize_weights (K5 + K4), quantize_weights + quantize_kv (K5 +
     K4-int8), and fused_pool=False with and without quantize_kv (K6); the
     launches of each run must equal layers x decode steps for its
     attention entry point and (5 x layers + 1) x decode steps for K5;
 17. hold the kernel path against the plain path end to end (fp32 2-layer
     full-width servers, fused and split, int8 KV and int8 weights; bf16 32
     layers w8kv8 on three requests; with int8 weights the plain run is
     teacher-forced on the kernel run's tokens so that every decode step is
     compared) and print the distance of w8kv8 from the unquantized server;
 18. prefix cache (no window, 2 layers fp32, fp and int8 KV): requests that
     share a 256-token prefix reuse pages and give the tokens of a server
     without the cache;
 19. generate and beam_search on the card against the server's tokens;
 20. profile a few w8kv8 decode steps;
 21. hold the eager API's kernels against their plain versions: K9
     elementwise (the eight ops at 4096^2 in fp32/bf16/fp16, integer
     division by 0 and INT_MIN / -1, float -> int saturation), K8 reduce_2d
     and K7 welford_norm_stat at 16387^2 (and a ragged 1000 x 333), K3
     matmul at 4096^3 in bf16/fp16/fp32, ragged and m = 1 with every
     epilogue, and int8;
 22. time each, its plain version and a library yardstick (torch.add,
     torch.sum / torch.amax, torch.var_mean + rsqrt, torch.matmul) beside
     its bound;
 23. drive `import kfunca_tpu_torch as kfunca` at bench.py's sizes: an eager
     MLP step (gemm, relu, gemm, + x, mean, backward) at Mistral-7B-v0.1
     widths in bf16 with the engine knobs at `pallas` (K3 = 6, K8 = 1,
     K9 = 9 launches asserted) and at their defaults (none), held against
     each other, and in fp32 at d 1024; norm_stat / sum / mean at 16387^2;
     the elementwise ops at 4096^2 with an out= write through a permuted
     view; sort / topk with NaN and ties; the eager causal attention
     forward and backward (K1, K2) at B=1, H=32, S=2048, hd=128;
 24. profile one eager MLP step, and time an eager 256-element add's host
     cost per op;
 25. print the kernels line (ten entries), the card line and, last, the
     result line.

Needs no network and imports nothing of JAX or kfunca_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Mistral-7B-v0.1 (huggingface.co/mistralai/Mistral-7B-v0.1 config.json):
# hidden 4096, 32 layers, 32 heads, 8 kv heads (head_dim 128),
# intermediate 14336, vocab 32000, rms_norm_eps 1e-5, rope_theta 1e4,
# sliding_window 4096, untied embeddings.
MISTRAL = dict(vocab_size=32000, d_model=4096, n_heads=32, n_kv_heads=8,
               n_layers=32, d_ff=14336, max_seq_len=32768, norm_eps=1e-5,
               rope_theta=10000.0, attention_window=4096, dtype="bfloat16")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate, same data sheet
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- phase 3/4: the paged decode kernel --------------------------------------


def kernel_case(dtype, gen, positions, *, b=8, h=32, hkv=8, hd=128, page=16,
                max_pages=272, layers=1, nan_dead=True):
    """Random paged-attention inputs on the card.  Each sequence owns
    max_pages distinct pages of a layers-deep stacked pool (flattened);
    pages that no live slot of any sequence reads are NaN."""
    dev = "cuda"
    n_pages = b * max_pages + 1
    pool = torch.full((layers * n_pages, page, 2 * hkv * hd), float("nan"),
                      dtype=dtype, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: b * max_pages].reshape(b, max_pages).int().contiguous()
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    base = (layers - 1) * n_pages
    for i, p in enumerate(positions):
        live = min(p // page + 1, max_pages)
        rows = tables[i, :live].long() + base
        pool[rows] = torch.randn((live, page, 2 * hkv * hd), generator=gen,
                                 device=dev).to(dtype)
    if not nan_dead:
        pool = torch.nan_to_num(pool, nan=0.0)
    q = (torch.randn((b, h, hd), generator=gen, device=dev)
         / math.sqrt(hd)).to(dtype)
    return q, pool, tables, pos, base


def max_err(out, ref, dtype) -> float:
    """Max |out - ref|, after checking it is within the tolerance.

    fp32: 2e-5 absolute.  Both compute an fp32 softmax-weighted mean of
    N(0,1) values; they differ only in summation order and in the last bit
    of exp, far below 1e-5.
    bf16: 2^-7 |ref| + 1e-6.  Both compute in fp32 from the same bf16
    inputs and round once to bf16 at the end; two fp32 values a hair apart
    can round to neighbouring bf16 values, one bf16 step (at most 2^-7 of
    the value's magnitude) apart."""
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), "kernel output is finite")
    err = (out - ref).abs()
    tol = (torch.full_like(ref, 2e-5) if dtype == torch.float32
           else ref.abs() * 2.0 ** -7 + 1e-6)
    check(bool((err <= tol).all()),
          f"kernel vs plain within tolerance ({dtype}, max err "
          f"{err.max().item():.3g})")
    return err.max().item()


def kernel_checks(attn, plain) -> float:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    # ragged positions up to ~4.3k: one page, page edges, mid, window edge
    positions = [0, 15, 16, 1000, 2047, 4095, 4200, 4300]
    for dtype in (torch.bfloat16, torch.float32):
        q, pool, tables, pos, base = kernel_case(dtype, gen, positions)
        for window in (None, 4096, 37):
            out = attn(q, pool, tables, pos, window=window)
            torch.cuda.synchronize()
            err = max_err(out, plain(q, pool, tables, pos, window=window),
                          dtype)
            print(f"  kernel vs plain {str(dtype)[6:]} window={window}: "
                  f"max err {err:.3g}")
            worst = max(worst, err)
        # layer-stacked pool read through page_base
        q, pool, tables, pos, base = kernel_case(dtype, gen, positions,
                                                 layers=3)
        out = attn(q, pool, tables, pos, window=4096, page_base=base)
        torch.cuda.synchronize()
        err = max_err(out, plain(q, pool, tables, pos, window=4096,
                                 page_base=base), dtype)
        print(f"  kernel vs plain {str(dtype)[6:]} page_base={base}: "
              f"max err {err:.3g}")
        worst = max(worst, err)
        # idle slot: position past the table width (a burst keeps
        # advancing it); every table slot is admitted, as in the gather
        # path.  Finite pages: the plain version reads the whole table.
        far = 272 * 16 + 5
        q, pool, tables, pos, base = kernel_case(
            dtype, gen, positions[:-1] + [far], nan_dead=False)
        for window in (None, 37):
            out = attn(q, pool, tables, pos, window=window)
            torch.cuda.synchronize()
            err = max_err(out, plain(q, pool, tables, pos, window=window),
                          dtype)
            print(f"  kernel vs plain {str(dtype)[6:]} position {far} past "
                  f"the table, window={window}: max err {err:.3g}")
            worst = max(worst, err)
    return worst


def library_attention(q, pool, tables, pos, window=None, page_base=0):
    """Yardstick only (the port never calls it): gather the table's pages
    of a fused fp pool and run torch's scaled_dot_product_attention with a
    boolean mask."""
    kw = dict(pool=pool, pool_v=None, page_tables=tables, positions=pos,
              scales=None, page_base=page_base)
    return library_attention_forms(q, kw, window, "fused")


def time_ms(fn, reps=30, warm=3) -> float:
    """Median device time of one call, from CUDA events around each call,
    with the 50 MB L2 flushed before each (decode reads each layer's pages
    cold; a training step's attention finds its inputs cold too)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_timing(attn, plain):
    """Times at the serving widths, bf16, window 4096, and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    positions = [96, 300, 511, 700, 1023, 1056, 2047, 4231]
    q, pool, tables, pos, _ = kernel_case(torch.bfloat16, gen, positions,
                                          nan_dead=False)
    window, page, hd = 4096, 16, q.shape[2]
    kv2 = pool.shape[2]
    live_pages = valid = 0
    for p in positions:
        first = max(0, (p - window + 1) // page)
        live_pages += min(p // page + 1, tables.shape[1]) - first
        valid += min(p + 1, window)
    item = q.element_size()
    # what these inputs need: each unmasked slot's k and v rows (all kv
    # heads) read once, q read once, out written once, plus the live
    # table entries and the positions
    nbytes = (valid * kv2 * item + 2 * q.numel() * item
              + live_pages * 4 + 4 * len(positions))
    flops = 4 * q.shape[1] * hd * valid  # q.k and p.v over unmasked slots
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / PEAK_FLOPS[q.dtype] else "operations")
    args = (q, pool, tables, pos)
    ms = time_ms(lambda: attn(*args, window=window))
    plain_ms = time_ms(lambda: plain(*args, window=window))
    library_ms = time_ms(lambda: library_attention(*args, window=window))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=bound_by, bytes=nbytes)


# -- phase 5/6: serving ------------------------------------------------------


def mistral_params(cfg, seed, dtype):
    from kfunca_tpu_torch.models.transformer import init_params

    params = init_params(seed, cfg, device="cuda", dtype=dtype)
    # untied LM head, as a Mistral HF import carries (lm_head.weight.T)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    s = 1.0 / math.sqrt(cfg.d_model)
    head = torch.rand((cfg.d_model, cfg.vocab_size), generator=gen,
                      device="cuda")
    params["lm_head"] = (head * (2 * s) - s).to(dtype)
    return params


def traffic(cfg, n_short=12):
    """Greedy requests: prompts of 64-1024 tokens and one of ~4.2k tokens,
    past the 4096 window, so window masking and page freeing run."""
    rng = np.random.default_rng(SEED)
    lengths = list(rng.integers(64, 1025, n_short)) + [4200]
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lengths]


def serve(params, cfg, prompts, burst, max_new=32, n_pages=800, **options):
    from kfunca_tpu_torch.models.serve import InferenceServer
    from kfunca_tpu_torch.runtime.backend import sync

    srv = InferenceServer(params, cfg, batch_slots=8, page_size=16,
                          n_pages=n_pages, max_pages_per_seq=272,
                          decode_burst=burst, **options)
    step_s = []
    inner = srv._step

    def timed_step():  # host clock, ending on a synchronize
        k = srv._burst_steps()  # the burst this call runs
        t0 = time.perf_counter()
        inner()
        sync(srv.device)
        step_s.append((time.perf_counter() - t0, k))

    srv._step = timed_step
    rids = [srv.submit(p, max_new=max_new) for p in prompts]
    t0 = time.perf_counter()
    out = srv.run()
    sync(srv.device)
    wall = time.perf_counter() - t0
    stats = srv.throughput_stats()
    check(all(len(out.get(r, ())) == max_new for r in rids),
          "every request finished with max_new tokens")
    check(srv.pool.available + stats["cached_pages"] == n_pages - 1,
          "every page returned to the pool (or held by the prefix cache)")
    # per model step: the host time of every scheduler call's decode
    # (admission and prefill run outside _step) over all the steps run, so
    # a stall anywhere counts; the median per-call reading stands beside it
    total_s = sum(s for s, _ in step_s)
    n_steps = sum(k for _, k in step_s)
    check(n_steps == stats["decode_steps"], "timed steps == decode steps")
    return dict(srv=srv, rids=rids, wall_s=wall, stats=stats,
                decode_ms_per_step=1e3 * total_s / n_steps,
                median_call_ms_per_step=1e3 * float(
                    np.median([s / k for s, k in step_s])),
                gen_tok_per_s=stats["generated_tokens"] / wall)


def logprob_check(srv, rids, prompts, tol, label) -> float:
    """Served log-probs vs log_softmax of a plain full forward over
    prompt + generated[:-1] from a fresh cache (no paged kernel)."""
    from kfunca_tpu_torch.models.generate import (
        forward_with_cache, init_kv_cache)

    worst = 0.0
    for rid in rids:
        req = srv.requests[rid]
        seq = list(prompts[rid]) + req.tokens[:-1]
        tokens = torch.tensor([seq], device="cuda")
        with torch.no_grad():
            logits, _ = forward_with_cache(
                srv.params, tokens, init_kv_cache(srv.cfg, 1, len(seq)), 0,
                srv.cfg)
        t = len(prompts[rid])
        lp = torch.log_softmax(logits[0, t - 1:], dim=-1)
        want = lp.gather(-1, torch.tensor(req.tokens, device="cuda")[:, None])
        err = (want[:, 0].cpu() - torch.tensor(req.logprobs)).abs().max().item()
        worst = max(worst, err)
        print(f"  {label} request {rid} (prompt {t}): served vs full forward "
              f"max |dlogprob| {err:.3g}")
    check(worst <= tol, f"{label} served log-probs within {tol} of the full "
          f"forward (max {worst:.3g})")
    return worst


def decode_profile(params, cfg, prompts, steps=4, **options):
    """torch.profiler over `steps` single decode steps of a full batch of 8:
    the device's busy share of the host-clock time, and device time by
    kernel.  Runs after the main path, so its launches are not counted."""
    from torch.profiler import ProfilerActivity, profile

    from kfunca_tpu_torch.models.serve import InferenceServer

    srv = InferenceServer(params, cfg, batch_slots=8, page_size=16,
                          n_pages=800, max_pages_per_seq=272, **options)
    for p in prompts[-8:]:
        srv.submit(p, max_new=steps + 2)
    srv._admit()
    srv._step()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            srv._step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, wall_us, steps)


def profile_summary(prof, wall_us, steps, n_top=8):
    """Per step: host-clock time, the union of the device intervals (busy
    time) and device time by kernel name, from a torch.profiler run."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")  # union of the device intervals
    for s, t in sorted(spans):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    return dict(wall_ms=wall_us / steps / 1e3, busy_ms=busy / steps / 1e3,
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top],
                steps=steps)


def print_profile(label, prof, card):
    print(f"{label}: {prof['wall_ms']:.2f} ms/step host clock, device busy "
          f"{prof['busy_ms']:.2f} ms/step "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); {card}")
    for name, us in prof["top"]:
        print(f"    {us / prof['steps'] / 1e3:8.3f} ms/step  {name[:100]}")


# -- phase 8/9: the flash attention kernels ----------------------------------

# the attention call of one training step at Mistral-7B-v0.1 widths
ATTN = dict(b=1, h=32, hkv=8, sq=8192, skv=8192, hd=128, window=4096)
# small shapes that hit the edges: MHA without a window; window 37; Sq != Skv
# both ways with ragged tiles (100, 160); head dims 64 and 40 (padded); a
# window with Sq > Skv + window, which leaves rows with no valid column
FLASH_EDGES = [
    dict(b=1, h=4, hkv=4, sq=256, skv=256, hd=128, window=None),
    dict(b=1, h=8, hkv=2, sq=200, skv=200, hd=128, window=37),
    dict(b=1, h=2, hkv=2, sq=100, skv=160, hd=64, window=None),
    dict(b=2, h=4, hkv=2, sq=160, skv=100, hd=64, window=None),
    dict(b=1, h=1, hkv=1, sq=35, skv=67, hd=40, window=None),
    dict(b=1, h=2, hkv=1, sq=300, skv=64, hd=64, window=64),
]


def flash_case(dtype, gen, *, b, h, hkv, sq, skv, hd, window=None):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return mk(b, h, sq, hd), mk(b, hkv, skv, hd), mk(b, hkv, skv, hd), mk(
        b, h, sq, hd)


def kv_head_groups(q, k, v, g):
    """(q, k, v, g) of one kv head and its group of q heads at a time: the
    plain versions materialize S x S scores, which fit only so."""
    group = q.shape[1] // k.shape[1]
    for j in range(k.shape[1]):
        heads = slice(j * group, (j + 1) * group)
        yield q[:, heads], k[:, j:j + 1], v[:, j:j + 1], g[:, heads]


def flash_plain(fa, q, k, v, g, window):
    """(out, lse, dq, dk, dv) from the plain versions of K1 and K2."""
    parts = [fa.flash_attention_plain(qs, ks, vs, window)
             + fa.flash_attention_backward_plain(qs, ks, vs, gs, window)
             for qs, ks, vs, gs in kv_head_groups(q, k, v, g)]
    return [torch.cat(ts, dim=1) for ts in zip(*parts)]


def flash_err(got, ref, dtype, what) -> float:
    """Max |got - ref| after checking it against the tolerance.

    fp32: 1e-4 x max(1, max |ref|).  Both routes compute the same fp32
    sums in another order (1e-4 absolute is what the JAX package's kernel
    tests allow at values of order 1); dk and dv at S = 8192 sum thousands
    of terms and reach magnitudes well above 1, hence the scale.
    bf16: 2^-7 |ref| + 2^-7 max |ref|.  `out` is computed in fp32 from the
    same bf16 inputs on both routes and rounded once (one bf16 step,
    2^-8 relative).  The gradients sit further apart because K2 takes
    delta = rowsum(dO * out) from the SAVED bf16 `out`, each element off
    by up to 2^-9 of itself, while the plain version differentiates the
    unrounded fp32 forward; that shifts dS, and with it every gradient
    element, by a few bf16 steps of the tensor's largest values."""
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), f"{what} is finite")
    err = (got - ref).abs()
    top = float(ref.abs().max())
    if dtype == torch.float32:
        tol = torch.full_like(ref, 1e-4 * max(1.0, top))
    else:
        tol = ref.abs() * 2.0 ** -7 + 2.0 ** -7 * top
    check(bool((err <= tol).all()),
          f"{what}: kernel vs plain within tolerance ({dtype}, max err "
          f"{err.max().item():.3g}, max |ref| {top:.3g})")
    return err.max().item()


def flash_checks(fa) -> tuple[float, float]:
    """(worst K1 error, worst K2 error) over the full shape and the edges."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst1 = worst2 = 0.0
    for case in [ATTN] + FLASH_EDGES:
        window = case["window"]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = flash_case(dtype, gen, **case)
            out, lse = fa.flash_attention_fwd_stats(q, k, v, window=window)
            dq, dk, dv = fa.flash_attention_backward(q, k, v, g, out, lse,
                                                     window=window)
            torch.cuda.synchronize()
            r_out, r_lse, r_dq, r_dk, r_dv = flash_plain(fa, q, k, v, g,
                                                         window)
            tag = "x".join(str(case[n]) for n in ("b", "h", "hkv", "sq",
                                                  "skv", "hd"))
            tag = f"{tag} w={window} {str(dtype)[6:]}"
            e1 = max(flash_err(out, r_out, dtype, f"out {tag}"),
                     flash_err(lse, r_lse, torch.float32, f"lse {tag}"))
            e2 = max(flash_err(dq, r_dq, dtype, f"dq {tag}"),
                     flash_err(dk, r_dk, dtype, f"dk {tag}"),
                     flash_err(dv, r_dv, dtype, f"dv {tag}"))
            print(f"  {tag}: K1 max err {e1:.3g}, K2 max err {e2:.3g}",
                  flush=True)
            worst1, worst2 = max(worst1, e1), max(worst2, e2)
            if case["sq"] > case["skv"] + (window or case["sq"]) - 1:
                dead = case["skv"] + window - 1  # first row with no column
                check(not out[:, :, dead:].any() and not lse[:, :, dead:].any()
                      and not dq[:, :, dead:].any(),
                      "rows with no valid column give out = 0, lse = 0, "
                      "dq = 0")
            if case["skv"] > case["sq"]:
                check(not dk[:, :, case["sq"]:].any()
                      and not dv[:, :, case["sq"]:].any(),
                      "kv rows that no q row reads get exact-zero dk/dv")
    return worst1, worst2


def flash_timing(fa):
    """K1 and K2 (each alone), their plain versions and the library call
    at the training step's attention shape, bf16, with the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dtype = torch.bfloat16
    q, k, v, g = flash_case(dtype, gen, **ATTN)
    b, h, s, hd, w = (ATTN[n] for n in ("b", "h", "sq", "hd", "window"))
    out, lse = fa.flash_attention_fwd_stats(q, k, v, window=w)
    item = q.element_size()
    # what these inputs need: per q head, the unmasked (row, column) pairs
    pairs = w * (w + 1) // 2 + (s - w) * w
    qo_bytes, kv_bytes = q.numel() * item, k.numel() * item
    lse_bytes = lse.numel() * 4
    work = {
        # q.k and p.v: 2 * 2 * hd flops per pair; q, k, v in, out and lse out
        "fwd": (4 * hd * pairs * h * b,
                2 * qo_bytes + 2 * kv_bytes + lse_bytes),
        # s, dp, dv, dk, dq: 5 * 2 * hd per pair; q, k, v, g, out, lse in,
        # dq, dk, dv out
        "bwd": (10 * hd * pairs * h * b,
                4 * qo_bytes + 4 * kv_bytes + lse_bytes),
    }
    res = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
        res[name] = dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         flops=flops, bytes=nbytes)
    res["fwd"]["ms"] = time_ms(
        lambda: fa.flash_attention_fwd_stats(q, k, v, window=w), reps=20)
    res["bwd"]["ms"] = time_ms(
        lambda: fa.flash_attention_backward(q, k, v, g, out, lse, window=w),
        reps=10)
    # the same kernels on fp32 inputs, for the record
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    o32, l32 = fa.flash_attention_fwd_stats(q32, k32, v32, window=w)
    res["fwd"]["ms_fp32"] = time_ms(
        lambda: fa.flash_attention_fwd_stats(q32, k32, v32, window=w), reps=5)
    res["bwd"]["ms_fp32"] = time_ms(
        lambda: fa.flash_attention_backward(q32, k32, v32, g32, o32, l32,
                                            window=w), reps=5, warm=1)
    del q32, k32, v32, g32, o32, l32

    def plain_fwd():
        for qs, ks, vs, _ in kv_head_groups(q, k, v, g):
            fa.flash_attention_plain(qs, ks, vs, w)

    def plain_bwd():
        for qs, ks, vs, gs in kv_head_groups(q, k, v, g):
            fa.flash_attention_backward_plain(qs, ks, vs, gs, w)

    res["fwd"]["plain_ms"] = time_ms(plain_fwd, reps=3, warm=1)
    res["bwd"]["plain_ms"] = time_ms(plain_bwd, reps=3, warm=1)

    # yardstick only (the port never calls it)
    row = torch.arange(s, device="cuda")[:, None]
    col = torch.arange(s, device="cuda")[None, :]
    mask = (col <= row) & (col > row - w)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                              enable_gqa=True)

    with torch.no_grad():
        res["fwd"]["library_ms"] = time_ms(sdpa, reps=10)
    lib_out = sdpa()
    res["bwd"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g,
                                    retain_graph=True), reps=10)
    # the yardstick computes the same function (bf16 rounding apart)
    check(float((lib_out.detach().float() - out.float()).abs().max()) < 0.05,
          "scaled_dot_product_attention agrees with K1")
    return res


# -- phase 10-13: training ---------------------------------------------------

# Depth is the only cut: training keeps fp32 master params, fp32 grads and
# two fp32 AdamW moments, 16 bytes per parameter.  32 layers hold 7.24 B
# parameters, 116 GB of state against the card's 80 GB; 4 layers at full
# width hold 1.13 B (18 GB of state), and the saved activations of 8192
# tokens (about 3 GB a layer) and the fp32 logits fit beside them.
TRAIN_LAYERS = 4
TRAIN_SEQ = 8192


def free_device_memory():
    gc.collect()
    torch.cuda.empty_cache()


def learnable_corpus(vocab_size, n=1 << 20):
    """Synthetic corpus with learnable structure: an arithmetic sequence
    with steps of 1-4 over 512 symbols (as examples/train_lm.py), spread
    over the vocabulary, so that the symbols in use and their order can be
    learned within a few steps."""
    rng = np.random.default_rng(SEED)
    base = np.cumsum(rng.integers(1, 5, size=n)) % 512
    return ((base * (vocab_size // 512) + 7) % vocab_size).astype(np.int32)


def run_steps(step, ds, params, opt, first_step, n_steps):
    """n_steps of `step` on ds.batch_at(first_step + i); every step ends
    on a synchronize.  Returns (params, opt, per-step metrics, seconds)."""
    metrics, seconds = [], []
    for i in range(n_steps):
        tokens, targets = ds.batch_at(first_step + i)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, tokens, targets)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics, seconds


def training_phases(fa, card):
    from torch.profiler import ProfilerActivity, profile

    from kfunca_tpu_torch.models.data import TokenDataset
    from kfunca_tpu_torch.models.train import (
        OptConfig, init_opt_state, make_train_step)
    from kfunca_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**{**MISTRAL, "n_layers": TRAIN_LAYERS,
                               "max_seq_len": TRAIN_SEQ})
    oc = OptConfig(lr=3e-4, warmup_steps=2, clip_norm=1.0)
    params = mistral_params(cfg, SEED + 2, torch.float32)
    n_params = sum(p.numel() for p in params["blocks"][0].values()) \
        * cfg.n_layers + params["embed"].numel() + params["lm_head"].numel() \
        + params["final_norm"].numel()
    opt = init_opt_state(params, oc)
    corpus = learnable_corpus(cfg.vocab_size)
    ds = TokenDataset(corpus, TRAIN_SEQ, 1, seed=SEED + 1)
    step = make_train_step(cfg, oc, with_metrics=True)
    steps = 6
    print(f"[10] training at Mistral-7B-v0.1 widths, {cfg.n_layers} of 32 "
          f"layers ({n_params / 1e9:.3f} B parameters; fp32 params, grads "
          f"and two AdamW moments need 16 B each, so 32 layers would need "
          f"116 GB), 1 x {TRAIN_SEQ} tokens, bf16 activations, AdamW",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    # the main path: launch counts start at 0 here and are read after it
    fa.flash_attention_fwd_stats.launches = 0
    fa.flash_attention_backward.launches = 0
    params, opt, metrics, seconds = run_steps(step, ds, params, opt, 0, steps)
    launches = (fa.flash_attention_fwd_stats.launches,
                fa.flash_attention_backward.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in metrics:
        print(f"  step {int(m['step'])}: loss {m['loss']:.4f}, grad norm "
              f"{m['grad_norm']:.4f}, lr {m['lr']:.3g}")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in metrics), "every loss and grad norm is finite")
    check(abs(metrics[0]["loss"] - math.log(cfg.vocab_size)) < 0.5,
          f"first loss {metrics[0]['loss']:.3f} within 0.5 of ln(vocab) "
          f"{math.log(cfg.vocab_size):.3f}")
    check(metrics[-1]["loss"] < metrics[0]["loss"],
          "the last loss is below the first")
    check(int(metrics[-1]["step"]) == steps, "the step counter advanced")
    want = cfg.n_layers * steps
    check(launches == (want, want),
          f"K1, K2 launches {launches} == layers x steps {want}")
    ms_step = 1e3 * float(np.mean(seconds[1:]))
    print(f"  {ms_step:.1f} ms/step (host clock, steps 2-{steps}, each "
          f"ending on a synchronize; first step {1e3 * seconds[0]:.1f} ms), "
          f"{TRAIN_SEQ / ms_step * 1e3:.0f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB; K1 and K2 launches {launches[0]} and "
          f"{launches[1]} (= layers x steps); {card}", flush=True)

    # loss_chunk + grad_accum, from the same state: 2 x 4096 tokens in two
    # microbatches, the LM head streamed in 4096-wide vocab chunks
    accum = make_train_step(cfg, oc, grad_accum=2, loss_chunk=4096,
                            with_metrics=True)
    ds2 = TokenDataset(corpus, TRAIN_SEQ // 2, 2, seed=SEED + 2)
    fa.flash_attention_fwd_stats.launches = 0
    fa.flash_attention_backward.launches = 0
    params, opt, metrics2, seconds2 = run_steps(accum, ds2, params, opt, 0, 2)
    launches2 = (fa.flash_attention_fwd_stats.launches,
                 fa.flash_attention_backward.launches)
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in metrics2), "loss_chunk/grad_accum losses are finite")
    want2 = cfg.n_layers * 2 * 2
    check(launches2 == (want2, want2),
          f"K1, K2 launches {launches2} == layers x steps x microbatches "
          f"{want2}")
    print(f"  loss_chunk 4096, grad_accum 2, 2 x {TRAIN_SEQ // 2} tokens: "
          f"losses {[round(m['loss'], 4) for m in metrics2]}, "
          f"{1e3 * seconds2[-1]:.1f} ms/step, K1 and K2 launches "
          f"{launches2[0]} and {launches2[1]}", flush=True)

    # [11] where a step's time goes (after the main path: not counted)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _, _ = run_steps(step, ds, params, opt, steps, 2)
        wall_us = (time.perf_counter() - t0) * 1e6
    print_profile(f"[11] training step profile (bf16, {cfg.n_layers} layers, "
                  f"1 x {TRAIN_SEQ}, 2 steps, profiler on)",
                  profile_summary(prof, wall_us, 2, n_top=12), card)
    return dict(launches=launches, ms_step=ms_step, peak_gb=peak_gb)


def loss_and_grads(params, tokens, targets, cfg):
    from kfunca_tpu_torch.models.transformer import loss_fn
    from kfunca_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    views = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, views), tokens, targets, cfg)
    grads = torch.autograd.grad(loss, views)
    return float(loss.detach()), grads


def end_to_end_fp32():
    """loss_fn and its gradients through K1/K2 against the same function
    with the attention routed to the plain version, in fp32."""
    from kfunca_tpu_torch.models.transformer import TransformerConfig
    from kfunca_tpu_torch.ops.attention import plain_attention

    cfg = TransformerConfig(**{**MISTRAL, "n_layers": 2, "dtype": "float32",
                               "max_seq_len": 1024})
    params = mistral_params(cfg, SEED + 3, torch.float32)
    rng = np.random.default_rng(SEED + 3)
    window = rng.integers(0, cfg.vocab_size, (2, 1025))
    tokens = torch.tensor(window[:, :-1], device="cuda")
    targets = torch.tensor(window[:, 1:], device="cuda")
    loss_k, grads_k = loss_and_grads(params, tokens, targets, cfg)
    loss_k2, grads_k2 = loss_and_grads(params, tokens, targets, cfg)
    with plain_attention():
        loss_p, grads_p = loss_and_grads(params, tokens, targets, cfg)
    # fp32 everywhere; the two paths differ only in the order of the
    # attention's sums (tiles of 64 against one full row), ~1e-6 relative
    # on the attention output, carried through two layers
    check(abs(loss_k - loss_p) <= 1e-5,
          f"kernel-path loss {loss_k:.7f} within 1e-5 of the plain path's "
          f"{loss_p:.7f}")
    worst = 0.0
    for gk, gp in zip(grads_k, grads_p):
        rel = float((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
    check(worst <= 1e-4, f"every gradient leaf within 1e-4 of its max "
          f"(worst {worst:.3g})")
    check(loss_k == loss_k2 and all(torch.equal(a, b) for a, b in
                                    zip(grads_k, grads_k2)),
          "two runs through the kernels give bitwise-equal gradients")
    print(f"[12] fp32, 2 layers at full width, 2 x 1024 tokens: loss "
          f"{loss_k:.6f} (kernels) vs {loss_p:.6f} (plain attention), worst "
          f"gradient leaf off by {worst:.3g} of its max; two kernel runs "
          f"bitwise equal", flush=True)


def trainer_resume():
    """Trainer.fit with checkpoints, the last one deleted, then a resume:
    bitwise the uninterrupted run's params.  A small config: a checkpoint
    of the full-width state would be 13 GB of disk writes."""
    from kfunca_tpu_torch.models.data import TokenDataset
    from kfunca_tpu_torch.models.train import OptConfig
    from kfunca_tpu_torch.models.trainer import Trainer, TrainerConfig
    from kfunca_tpu_torch.models.transformer import TransformerConfig
    from kfunca_tpu_torch.utils.tree import tree_leaves

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                            n_kv_heads=2, n_layers=2, d_ff=512,
                            max_seq_len=128, attention_window=48,
                            dtype="bfloat16")
    oc = OptConfig(lr=1e-3, warmup_steps=2, clip_norm=1.0)
    ds = TokenDataset(learnable_corpus(512, 1 << 14), 128, 4, seed=SEED)
    eval_ds = TokenDataset(learnable_corpus(512, 1 << 14), 128, 4,
                           seed=SEED + 1)
    with tempfile.TemporaryDirectory() as out_dir:
        tc = TrainerConfig(out_dir=out_dir, total_steps=6, ckpt_every=3,
                           log_every=1, eval_every=6, eval_batches=2)
        full = Trainer(cfg, tc, oc).fit(ds, seed=SEED, eval_dataset=eval_ds)
        want = [p.clone() for p in tree_leaves(full["params"])]
        os.remove(os.path.join(out_dir, "step_00000006.npz"))
        trainer = Trainer(cfg, tc, oc)
        check(trainer.latest_checkpoint()[1] == 3, "resume starts at step 3")
        again = trainer.fit(ds, seed=SEED + 9)
    got = tree_leaves(again["params"])
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "resumed params are bitwise the uninterrupted run's")
    losses = [h["loss"] for h in full["history"]]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "the Trainer's loss is finite and falls")
    print(f"[13] Trainer on the card (d_model 256, 2 layers, 4 x 128 "
          f"tokens, bf16): losses {losses[0]:.3f} -> {losses[-1]:.3f}, eval "
          f"nll {full['evals'][6]['nll']:.3f}; resumed from step 3 bitwise "
          f"equal to the uninterrupted run", flush=True)


def serving_phases(card):
    """Phases 3-7; returns K4's entry of the kernels line and the burst-1
    bf16 run's (tokens, log-probs) per prompt, the unquantized reference
    of phase 17."""
    from kfunca_tpu_torch.models.transformer import TransformerConfig
    from kfunca_tpu_torch.ops.pallas_kernels import paged_attention as pa

    attn, plain = pa.paged_decode_attention_dma, pa.paged_decode_attention_plain
    print("[3] paged decode kernel vs plain version", flush=True)
    worst = kernel_checks(attn, plain)

    timing = kernel_timing(attn, plain)
    print(f"[4] paged decode at serving widths (B=8, H=32, Hkv=8, hd=128, "
          f"page 16, bf16, window 4096): kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, gather+sdpa {timing['library_ms']:.4f}"
          f" ms, bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}, "
          f"{timing['bytes']} B); {card}", flush=True)

    cfg = TransformerConfig(**MISTRAL)
    params = mistral_params(cfg, SEED, torch.bfloat16)
    prompts = traffic(cfg)
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params32 = mistral_params(cfg32, SEED + 1, torch.float32)
    prompts32 = [prompts[0], prompts[5], prompts[-1]]
    print(f"[5] serving Mistral-7B-v0.1 widths, {len(prompts)} requests "
          f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))}), "
          f"max_new 32, 8 slots, page 16", flush=True)
    # the main path: launch counts start at 0 here and are read after it
    attn.launches = 0
    runs, expect = {}, 0
    with torch.no_grad():
        for label, p, c, ps, burst in (
                ("bf16 L32 burst1", params, cfg, prompts, 1),
                ("bf16 L32 burst4", params, cfg, prompts, 4),
                ("fp32 L2 burst4", params32, cfg32, prompts32, 4)):
            run = serve(p, c, ps, burst)
            runs[label] = run
            expect += c.n_layers * run["stats"]["decode_steps"]
            print(f"  {label}: {run['stats']['decode_steps']} decode steps, "
                  f"decode {run['decode_ms_per_step']:.2f} ms/step (all "
                  f"steps; per-call median {run['median_call_ms_per_step']:.2f}"
                  f"), {run['gen_tok_per_s']:.1f} generated tok/s (prefill "
                  f"included) over "
                  f"{run['wall_s']:.2f} s, mean TTFT "
                  f"{run['stats']['mean_ttft_s'] * 1e3:.1f} ms; {card}",
                  flush=True)
    launches = attn.launches
    check(launches > 0 and launches == expect,
          f"paged kernel launches {launches} == layers x decode steps "
          f"{expect}")
    print(f"  paged kernel launches on the main path: {launches} "
          f"(= layers x decode steps)", flush=True)

    print("[6] served log-probs vs plain full forward", flush=True)
    # bf16, 32 layers: the served and reference paths round bf16
    # activations at different places (different matmul shapes, paged vs
    # dense attention); one bf16 step is 2^-8 relative, and the drift it
    # leaves over 32 residual layers moves a log-prob by a few hundredths
    # of a nat.  0.1 nat is far below what a wrong mask, position or page
    # would cause (whole nats).
    b1 = runs["bf16 L32 burst1"]
    logprob_check(b1["srv"], b1["rids"][:2] + b1["rids"][-1:], prompts, 0.1,
                  "bf16 L32")
    # fp32, 2 layers at full width: only summation order differs (dense
    # prefill vs paged decode), ~1e-5 nat; a bf16 round anywhere on the
    # path would miss 1e-4 by two orders of magnitude
    f32 = runs["fp32 L2 burst4"]
    logprob_check(f32["srv"], f32["rids"], prompts32, 1e-4, "fp32 L2")

    with torch.no_grad():
        prof = decode_profile(params, cfg, prompts)
    print_profile(f"[7] decode step profile (bf16 L32, 8 slots, "
                  f"{prof['steps']} steps, profiler on)", prof, card)

    reference = [(b1["srv"].requests[r].tokens, b1["srv"].requests[r].logprobs)
                 for r in b1["rids"]]
    return {
        "name": "paged_decode_attention_dma",
        "route": "cuda",
        "source": "kfunca_tpu_torch/csrc/paged_attention.cu",
        "replaces": "kfunca_tpu/ops/pallas_kernels/paged_attention.py:459",
        "launches": launches,
        "max_abs_err": worst,
        "max_err": worst,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }, reference


# -- phase 14-20: quantized and split-pool serving ---------------------------

def pool_case(dtype, gen, positions, *, form="fused", quantized=True, h=32,
              hkv=8, hd=128, page=16, max_pages=272, layers=1, nan_dead=True):
    """Paged-attention inputs on the card in one pool form: fused [k|v]
    rows, split 4-D pools, split flat 3-D pools, or split pools with
    head-major scales; fp (`dtype`) or int8 with fp32 scales.  Each sequence
    owns max_pages distinct pages of a layers-deep stacked pool.  With
    nan_dead, whatever no unmasked slot needs is poisoned: fp pages NaN,
    int8 pages a constant, and every scale NaN (dead pages, the unused
    lanes of the fused scale rows, and the slots past each position).
    Returns (q, the other arguments by name)."""
    dev = "cuda"
    b = len(positions)
    n_pages = b * max_pages + 1
    total = layers * n_pages
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = perm[: b * max_pages].reshape(b, max_pages).int().contiguous()
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    base = (layers - 1) * n_pages
    live = [min(p // page + 1, max_pages) for p in positions]

    def data():  # one (total, page, Hkv, hd) pool
        if quantized:
            pool = torch.full((total, page, hkv, hd), 85, dtype=torch.int8,
                              device=dev)
        else:
            pool = torch.full((total, page, hkv, hd), float("nan"),
                              dtype=dtype, device=dev)
        for i, n in enumerate(live):
            rows = tables[i, :n].long() + base
            if quantized:
                pool[rows] = torch.randint(
                    -127, 128, (n, page, hkv, hd), generator=gen,
                    device=dev).to(torch.int8)
            else:
                pool[rows] = torch.randn((n, page, hkv, hd), generator=gen,
                                         device=dev).to(dtype)
        return pool if nan_dead or quantized else torch.nan_to_num(pool)

    def scale():  # one (total, page, Hkv) pool
        sc = torch.full((total, page, hkv), float("nan"), device=dev)
        for i, (n, p) in enumerate(zip(live, positions)):
            rows = tables[i, :n].long() + base
            vals = torch.rand((n, page, hkv), generator=gen,
                              device=dev) * 0.015 + 0.005
            if nan_dead:  # slots past the position are never read
                slot = torch.arange(n * page, device=dev).reshape(n, page)
                vals[slot > p] = float("nan")
            sc[rows] = vals
        return sc if nan_dead else torch.nan_to_num(sc, nan=1.0)

    k, v = data(), data()
    scales = None
    if quantized:
        sk, sv = scale(), scale()
    if form == "fused":
        pool = torch.cat([k.reshape(total, page, -1),
                          v.reshape(total, page, -1)], dim=-1).contiguous()
        pool_v = None
        if quantized:
            scales = torch.full((total, page, 128),
                                float("nan") if nan_dead else 1.0, device=dev)
            scales[..., :hkv], scales[..., hkv:2 * hkv] = sk, sv
    else:
        pool, pool_v = k, v
        if form == "split_flat":
            pool, pool_v = (t.reshape(total, page, -1) for t in (k, v))
        if quantized:
            scales = (sk, sv)
            if form == "split_head_major":
                scales = tuple(t.transpose(1, 2).contiguous() for t in scales)
    q = (torch.randn((b, h, hd), generator=gen, device=dev)
         / math.sqrt(hd)).to(dtype)
    kw = dict(pool=pool, pool_v=pool_v, page_tables=tables, positions=pos,
              scales=scales, page_base=base)
    return q, kw


def run_form(pa, entry, form, q, kw, window, plain=False):
    """One call of an entry point (or the plain version) on a pool_case."""
    head_major = form == "split_head_major"
    if plain:
        return pa.paged_decode_attention_plain(
            q, kw["pool"], kw["page_tables"], kw["positions"], window=window,
            page_base=kw["page_base"], pool_v=kw["pool_v"],
            scales=kw["scales"], head_major_scales=head_major)
    if entry is pa.paged_decode_attention:
        return entry(q, kw["pool"], kw["pool_v"], kw["page_tables"],
                     kw["positions"], window=window, scales=kw["scales"],
                     page_base=kw["page_base"])
    return entry(q, kw["pool"], kw["page_tables"], kw["positions"],
                 window=window, page_base=kw["page_base"],
                 pool_v=kw["pool_v"], scales=kw["scales"],
                 head_major_scales=head_major)


def paged_form_checks(pa) -> dict:
    """Worst |kernel - plain| per kernels-line entry, over every pool form,
    dtype, window, page_base, poisoned dead pages and scale rows, positions
    past the table and edge shapes.  Tolerances as K4's (max_err): 2e-5 in
    fp32, one bf16 step in bf16; the int8 pools add only the order in which
    the two scales meet the sums, inside the same fp32 arithmetic."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    dma, k6 = pa.paged_decode_attention_dma, pa.paged_decode_attention
    positions = [0, 15, 16, 1000, 2047, 4095, 4200, 4300]
    far = 272 * 16 + 5
    worst = {"dma_int8": 0.0, "k6": 0.0}
    # (entry, form, quantized, which worst it feeds)
    plans = [(dma, "fused", True, "dma_int8"),
             (dma, "split", True, "dma_int8"),
             (dma, "split_head_major", True, "dma_int8"),
             (dma, "split_flat", False, "dma_int8"),
             (k6, "split", False, "k6"), (k6, "split_flat", False, "k6"),
             (k6, "split", True, "k6"), (k6, "split_flat", True, "k6")]
    for entry, form, quantized, key in plans:
        tag = f"{entry.__name__} {form} {'int8' if quantized else 'fp'}"
        for dtype in (torch.bfloat16, torch.float32):
            errs = []
            q, kw = pool_case(dtype, gen, positions, form=form,
                              quantized=quantized)
            for window in (None, 4096, 37):
                out = run_form(pa, entry, form, q, kw, window)
                torch.cuda.synchronize()
                errs.append(max_err(out, run_form(pa, entry, form, q, kw,
                                                  window, plain=True), dtype))
            q, kw = pool_case(dtype, gen, positions, form=form,
                              quantized=quantized, layers=3)
            check(kw["page_base"] > 0, "page_base selects the last layer")
            out = run_form(pa, entry, form, q, kw, 4096)
            torch.cuda.synchronize()
            errs.append(max_err(out, run_form(pa, entry, form, q, kw, 4096,
                                              plain=True), dtype))
            # a position past the table (finite pools: the plain version
            # gathers the whole table)
            q, kw = pool_case(dtype, gen, positions[:-1] + [far], form=form,
                              quantized=quantized, nan_dead=False)
            for window in (None, 37):
                out = run_form(pa, entry, form, q, kw, window)
                torch.cuda.synchronize()
                errs.append(max_err(out, run_form(pa, entry, form, q, kw,
                                                  window, plain=True), dtype))
            print(f"  {tag} {str(dtype)[6:]}: windows None/4096/37, "
                  f"page_base, position {far}: max err {max(errs):.3g}",
                  flush=True)
            worst[key] = max(worst[key], max(errs))
    # edge shapes: MHA (Hkv = H), head_dim 64, page 8, a short table
    edge = dict(h=8, hkv=8, hd=64, page=8, max_pages=40)
    for entry, form, quantized, key in plans[:1] + plans[4:7:2]:
        for dtype in (torch.bfloat16, torch.float32):
            q, kw = pool_case(dtype, gen, [0, 7, 8, 100, 319], form=form,
                              quantized=quantized, **edge)
            errs = []
            for window in (None, 21):
                out = run_form(pa, entry, form, q, kw, window)
                torch.cuda.synchronize()
                errs.append(max_err(out, run_form(pa, entry, form, q, kw,
                                                  window, plain=True), dtype))
            print(f"  {entry.__name__} {form} "
                  f"{'int8' if quantized else 'fp'} {str(dtype)[6:]} Hkv=H=8, "
                  f"hd=64, page 8: max err {max(errs):.3g}", flush=True)
            worst[key] = max(worst[key], max(errs))
    return worst


def library_attention_forms(q, kw, window, form):
    """Yardstick only (the port never calls it): gather the table's pages,
    dequantize int8 pages by their scales, and run torch's
    scaled_dot_product_attention with a boolean mask."""
    b, h, hd = q.shape
    tables, pos = kw["page_tables"], kw["positions"]
    ids = tables.long() + kw["page_base"]
    if form == "fused":
        total, page, kv2 = kw["pool"].shape
        hkv = kv2 // (2 * hd)
        kv = kw["pool"][ids].reshape(b, -1, 2, hkv, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        if kw["scales"] is not None:
            sc = kw["scales"][ids].reshape(b, -1, 128)
            k = (k.float() * sc[..., :hkv, None]).to(q.dtype)
            v = (v.float() * sc[..., hkv:2 * hkv, None]).to(q.dtype)
    else:
        page = kw["pool"].shape[1]
        k = kw["pool"][ids].reshape(b, tables.shape[1] * page, -1, hd)
        v = kw["pool_v"][ids].reshape(b, tables.shape[1] * page, -1, hd)
        if kw["scales"] is not None:
            sk, sv = (t[ids].reshape(b, -1, k.shape[2]) for t in kw["scales"])
            k = (k.float() * sk[..., None]).to(q.dtype)
            v = (v.float() * sv[..., None]).to(q.dtype)
    slot = torch.arange(k.shape[1], device=q.device)[None, :]
    ok = slot <= pos.long()[:, None]
    if window is not None:
        ok = ok & (slot > pos.long()[:, None] - window)
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=ok[:, None, None, :], scale=1.0, enable_gqa=True)[:, :, 0]


def paged_form_timing(pa, entry, form, quantized):
    """Times at the serving widths (bf16 q, window 4096) and the bound: the
    unmasked slots' k and v rows (int8: one byte an element plus 2*Hkv fp32
    scales a slot), q in, out out, the live table entries, the positions."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    positions = [96, 300, 511, 700, 1023, 1056, 2047, 4231]
    q, kw = pool_case(torch.bfloat16, gen, positions, form=form,
                      quantized=quantized, nan_dead=False)
    window, page = 4096, 16
    b, h, hd = q.shape
    hkv = 8
    live_pages = valid = 0
    for p in positions:
        first = max(0, (p - window + 1) // page)
        live_pages += min(p // page + 1, kw["page_tables"].shape[1]) - first
        valid += min(p + 1, window)
    per_slot = (2 * hkv * hd + 2 * hkv * 4) if quantized else 2 * hkv * hd * 2
    nbytes = (valid * per_slot + 2 * q.numel() * q.element_size()
              + live_pages * 4 + 4 * len(positions))
    flops = 4 * h * hd * valid
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    with torch.no_grad():
        ms = time_ms(lambda: run_form(pa, entry, form, q, kw, window))
        plain_ms = time_ms(lambda: run_form(pa, entry, form, q, kw, window,
                                            plain=True))
        library_ms = time_ms(lambda: library_attention_forms(q, kw, window,
                                                             form))
        lib = library_attention_forms(q, kw, window, form)
        out = run_form(pa, entry, form, q, kw, window)
    check(float((lib.float() - out.float()).abs().max()) < 0.05,
          "the library yardstick computes the same attention")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)


# the decode step's matmuls at Mistral-7B-v0.1 widths, 8 slots: (k, n) and
# how many of each a step of 32 layers runs (wqkv, wo, w_gate + w_up,
# w_down per layer; the LM head once)
Q8_DECODE_SHAPES = [(4096, 6144, 32), (4096, 4096, 32), (4096, 14336, 64),
                    (14336, 4096, 32), (4096, 32000, 1)]


def q8_case(gen, m, k, n):
    def ints(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             device="cuda").to(torch.int8)

    return (ints(m, k), ints(k, n),
            torch.rand(m, generator=gen, device="cuda") * 0.02 + 0.001,
            torch.rand(n, generator=gen, device="cuda") * 0.02 + 0.001)


def library_matmul_q8(a_q8, b_q8, a_scale, b_scale, out_dtype):
    """The library yardstick for K5, used nowhere in the port: cuBLASLt's
    int8 GEMM through `torch._int_mm` (it refuses m <= 16, so the rows are
    padded with zeros to a multiple of 32), then the two scale multiplies in
    the kernel's order."""
    m = a_q8.shape[0]
    mp = max(32, -(-m // 32) * 32)
    if mp != m:
        a_q8 = torch.nn.functional.pad(a_q8, (0, 0, 0, mp - m))
    acc = torch._int_mm(a_q8, b_q8)[:m]
    return ((acc.float() * a_scale[:, None]) * b_scale[None, :]).to(out_dtype)


def q8_checks(tq) -> float:
    """K5 against its plain version.  fp32 output: BIT-EQUAL (both hold the
    exact integer sum and multiply it by the same two scales in the same
    order).  bf16 output: one more rounding of that same fp32 value, so at
    most one bf16 step (2^-7 relative) apart, in practice equal too."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    shapes = [(8, k, n) for k, n, _ in Q8_DECODE_SHAPES]
    # ragged edges: odd m, k, n (no 4-byte aligned rows), one row, many rows
    shapes += [(5, 130, 67), (1, 4096, 4096), (1, 77, 3), (300, 515, 260),
               (300, 4096, 1024), (17, 1023, 130), (8, 127 * 4, 128)]
    worst = 0.0
    for m, k, n in shapes:
        a, b, sa, sb = q8_case(gen, m, k, n)
        got = tq.matmul_q8(a, b, sa, sb, out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = tq.matmul_q8_plain(a, b, sa, sb, out_dtype=torch.float32)
        check(torch.equal(got, want),
              f"matmul_q8 {m}x{k}x{n} fp32 bit-equal to its plain version "
              f"(max diff {(got - want).abs().max().item():.3g})")
        got16 = tq.matmul_q8(a, b, sa, sb)
        want16 = tq.matmul_q8_plain(a, b, sa, sb)
        err = (got16.float() - want16.float()).abs()
        check(got16.dtype == torch.bfloat16 and bool(
            (err <= want16.float().abs() * 2.0 ** -7).all()),
            f"matmul_q8 {m}x{k}x{n} bf16 within one bf16 step")
        worst = max(worst, float((got - want).abs().max()), float(err.max()))
        print(f"  matmul_q8 m={m} k={k} n={n} (split "
              f"{tq.q8_split_k(m, k, n)}): fp32 bit-equal, bf16 max err "
              f"{float(err.max()):.3g}", flush=True)
    # extreme values fill the accumulator: |acc| = 127 * 127 * k
    a = torch.full((8, 14336), 127, dtype=torch.int8, device="cuda")
    b = torch.full((14336, 128), -127, dtype=torch.int8, device="cuda")
    one = torch.ones(128, device="cuda")
    got = tq.matmul_q8(a, b, one[:8], one, out_dtype=torch.float32)
    check(bool((got == float(-127 * 127 * 14336)).all()),
          "matmul_q8 holds |acc| = 231,225,344 exactly")
    # two runs are bitwise equal (integer sums in any order)
    a, b, sa, sb = q8_case(gen, 8, 4096, 14336)
    check(torch.equal(tq.matmul_q8(a, b, sa, sb), tq.matmul_q8(a, b, sa, sb)),
          "matmul_q8 is bitwise repeatable")
    return worst


def q8_timing(tq, card):
    """K5, its plain version and the library call at each decode shape; the
    kernels line gets the mean over one decode step's 161 launches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    m = 8
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    count = 0
    for k, n, per_step in Q8_DECODE_SHAPES:
        a, b, sa, sb = q8_case(gen, m, k, n)
        # a, b, both scale vectors in; the fp32 output out (the decode
        # step asks for fp32)
        nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
        ops = 2 * m * k * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS
        t = dict(
            ms=time_ms(lambda: tq.matmul_q8(a, b, sa, sb, torch.float32)),
            plain_ms=time_ms(lambda: tq.matmul_q8_plain(a, b, sa, sb,
                                                        torch.float32),
                             reps=5, warm=1),
            library_ms=time_ms(lambda: library_matmul_q8(a, b, sa, sb,
                                                         torch.float32)),
            bound_ms=max(t_bytes, t_ops) * 1e3)
        check(torch.equal(library_matmul_q8(a, b, sa, sb, torch.float32),
                          tq.matmul_q8(a, b, sa, sb, torch.float32)),
              "torch._int_mm with the scale multiplies equals matmul_q8")
        check(t_bytes >= t_ops, "the decode shapes are bound by bytes")
        print(f"[15] matmul_q8 m={m} k={k} n={n} (x{per_step} a step): kernel "
              f"{t['ms']:.4f} ms ({nbytes / t['ms'] / 1e6:.0f} GB/s), plain "
              f"{t['plain_ms']:.4f} ms, torch._int_mm + scales "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes, "
              f"{nbytes} B); {card}", flush=True)
        for key in total:
            total[key] += per_step * t[key]
        count += per_step
    out = {key: v / count for key, v in total.items()}
    out.update(bound_by="bytes", step_ms=total["ms"],
               step_bound_ms=total["bound_ms"], per_step=count)
    return out


def reset_launches(pa, tq):
    pa.paged_decode_attention_dma.launches = 0
    pa.paged_decode_attention.launches = 0
    tq.matmul_q8.launches = 0


def read_launches(pa, tq):
    return dict(dma=pa.paged_decode_attention_dma.launches,
                k6=pa.paged_decode_attention.launches,
                q8=tq.matmul_q8.launches)


def first_difference(a, b):
    """Index of the first token at which two token lists differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def serve_greedy(make, prompts, max_new, plain=()):
    """(tokens, log-probs) per prompt from a fresh server, inside the plain
    contexts named in `plain` ("attention", "matmul_q8")."""
    from kfunca_tpu_torch.ops.pallas_kernels.paged_attention import (
        plain_paged_attention)
    from kfunca_tpu_torch.ops.quant import plain_matmul_q8

    contexts = {"attention": plain_paged_attention,
                "matmul_q8": plain_matmul_q8}
    with torch.no_grad(), contextlib.ExitStack() as stack:
        for name in plain:
            stack.enter_context(contexts[name]())
        srv = make()
        rids = [srv.submit(p, max_new=max_new) for p in prompts]
        out = srv.run()
    return [out[r] for r in rids], [srv.requests[r].logprobs for r in rids]


def compare_servers(label, make, prompts, tol, max_new=16):
    """Serve `prompts` once on the kernels and once inside the plain
    contexts (same server options, same weights): equal greedy tokens and
    log-probs within `tol`.  Returns the kernel run's tokens."""
    toks, lps = serve_greedy(make, prompts, max_new)
    ptoks, plps = serve_greedy(make, prompts, max_new,
                               plain=("attention", "matmul_q8"))
    check(toks == ptoks, f"{label}: kernel path and plain path give the "
          f"same greedy tokens")
    worst = max(abs(x - y) for a, b in zip(lps, plps) for x, y in zip(a, b))
    check(worst <= tol, f"{label}: log-probs within {tol} of the plain "
          f"path's (max {worst:.3g})")
    print(f"  {label}: {len(prompts)} requests x {max_new} tokens, equal "
          f"tokens, max |dlogprob| {worst:.3g}", flush=True)
    return toks


@contextlib.contextmanager
def recorded_run(replay=None):
    """Record a server run from outside the package, for a second run to be
    held against it step by step.  While inside:
      * every `sample_tokens` call of models/serve.py is kept; with `replay`
        (an earlier run's record) the call ANSWERS with that run's tokens,
        so the second server is teacher-forced down the first one's path
        and schedules exactly as it did, while its own choice is kept too;
      * every decode step keeps which request held each slot and the int8
        outputs of its activation and KV quantizers (`quantize_rows`,
        `quantize_vecs`), so a rounding that landed on the other neighbour
        in one of the runs can be told from a step without one."""
    from kfunca_tpu_torch.models import serve as sv
    from kfunca_tpu_torch.ops import quant as tq

    rec = dict(sampled=[], own=[], steps=[])
    real = (sv.sample_tokens, tq.quantize_rows, sv.quantize_vecs,
            sv.InferenceServer._step)
    rounded = None  # the running decode step's quantizer outputs

    def sample_tokens(logits, generator, temperature=0.0, top_p=1.0):
        own = real[0](logits, generator, temperature, top_p)
        tokens = own
        if replay is not None:
            tokens = replay["sampled"][len(rec["sampled"])]
            check(tokens.shape == own.shape, "the replayed run samples in "
                  "the recorded run's order")
        rec["sampled"].append(tokens)
        rec["own"].append(own)
        return tokens

    def keeping(quantizer):
        def quantize(x):
            q, scale = quantizer(x)
            if rounded is not None:
                rounded.append(q)
            return q, scale
        return quantize

    def step(self):
        nonlocal rounded
        check(self._burst_steps() == 1, "recorded runs decode step by step")
        rounded = []
        rec["steps"].append((list(self.slot_req), rounded,
                             len(rec["sampled"])))
        try:
            real[3](self)
        finally:
            rounded = None

    sv.sample_tokens, tq.quantize_rows = sample_tokens, keeping(real[1])
    sv.quantize_vecs, sv.InferenceServer._step = keeping(real[2]), step
    try:
        yield rec
    finally:
        (sv.sample_tokens, tq.quantize_rows, sv.quantize_vecs,
         sv.InferenceServer._step) = real


def compare_servers_forced(label, make, prompts, tol, clean_tol=None,
                           max_new=16):
    """Kernel path against plain path with int8 weights, over EVERY decode
    step.  The kernel run is recorded and the plain run replays its tokens
    (see recorded_run), so both servers see the same history at every step
    whatever either would have chosen.  Each step's log-prob is held to
    `tol`.  A request is `clean` until the first step at which one of its
    int8 activation or KV roundings differs between the runs; with
    `clean_tol`, clean steps (the first token, from the prefill, included)
    are held to it and must choose the same token.  Returns the tokens."""
    with recorded_run() as kern:
        toks, lps = serve_greedy(make, prompts, max_new)
    with recorded_run(replay=kern) as plain:
        ptoks, plps = serve_greedy(make, prompts, max_new,
                                   plain=("attention", "matmul_q8"))
    check(toks == ptoks and len(kern["steps"]) == len(plain["steps"]),
          f"{label}: the plain path replayed the kernel path's tokens")
    seen = [1] * len(prompts)  # log-probs compared so far, per request
    flipped = [False] * len(prompts)
    clean = [abs(a[0] - b[0]) for a, b in zip(lps, plps)]
    dirty, agree, agree_clean = [], 0, True
    for (slots, qs, at), (pslots, pqs, pat) in zip(kern["steps"],
                                                   plain["steps"]):
        check(slots == pslots and len(qs) == len(pqs) and at == pat,
              f"{label}: both runs schedule alike")
        forced, own = kern["sampled"][at], plain["own"][pat]
        differs = torch.zeros(len(slots), dtype=torch.bool,
                              device=forced.device)
        for a, b in zip(qs, pqs):  # (slots, ...) int8, one row a slot
            differs |= (a != b).flatten(1).any(dim=1)
        differs = differs.tolist()
        forced, own = forced.tolist(), own.tolist()
        for slot, rid in enumerate(slots):
            if rid is None:
                continue
            flipped[rid] = flipped[rid] or differs[slot]
            i = seen[rid]
            seen[rid] += 1
            d = abs(lps[rid][i] - plps[rid][i])
            (dirty if flipped[rid] else clean).append(d)
            agree += own[slot] == forced[slot]
            if not flipped[rid]:
                agree_clean = agree_clean and own[slot] == forced[slot]
    check(seen == [len(t) for t in toks],
          f"{label}: every decode step of every request was compared")
    worst = max(clean + dirty)
    check(worst <= tol, f"{label}: log-probs of every step within {tol} of "
          f"the plain path's (max {worst:.3g})")
    if clean_tol is not None:
        check(max(clean) <= clean_tol and agree_clean,
              f"{label}: steps before a request's first differing int8 "
              f"rounding within {clean_tol} (max {max(clean):.3g}) and "
              f"choosing the same token")
    n_decode = len(clean) + len(dirty) - len(prompts)
    print(f"  {label}: {len(prompts)} requests x {max_new} tokens, all "
          f"{len(clean) + len(dirty)} log-probs compared on the kernel "
          f"path's tokens: {len(clean)} before a first differing int8 "
          f"rounding, max |dlogprob| {max(clean):.3g}; {len(dirty)} after "
          f"one, max {max(dirty, default=0.0):.3g}; the plain path's own "
          f"greedy choice equals the kernel path's on {agree} of {n_decode} "
          f"decode steps", flush=True)
    return toks


def compare_matmul_exactly(label, make, prompts, max_new=16):
    """K5 in the server against its plain version, the attention plain on
    both sides: the int8 matmul is bit-equal to its plain version, so the
    two runs must give the same tokens and bitwise-equal log-probs."""
    got = serve_greedy(make, prompts, max_new, plain=("attention",))
    want = serve_greedy(make, prompts, max_new,
                        plain=("attention", "matmul_q8"))
    check(got == want, f"{label}: matmul_q8 in the server is bitwise its "
          f"plain version (tokens and log-probs)")
    print(f"  {label}: matmul_q8 on the kernel and on its plain version, "
          f"attention plain on both: tokens and log-probs bitwise equal",
          flush=True)


def quant_phases(card, reference):
    """Phases 14-20; returns the kernels-line entries of K4-int8, K6, K5."""
    from kfunca_tpu_torch.models.generate import beam_search, generate
    from kfunca_tpu_torch.models.serve import InferenceServer
    from kfunca_tpu_torch.models.transformer import TransformerConfig
    from kfunca_tpu_torch.ops import quant as tq
    from kfunca_tpu_torch.ops.pallas_kernels import paged_attention as pa

    dma, k6 = pa.paged_decode_attention_dma, pa.paged_decode_attention
    print("[14] K4-int8, K6 and K5 vs their plain versions", flush=True)
    errs = paged_form_checks(pa)
    errs["q8"] = q8_checks(tq)

    timing = {
        "dma_int8": paged_form_timing(pa, dma, "fused", True),
        "k6": paged_form_timing(pa, k6, "split", False),
        "k6_int8": paged_form_timing(pa, k6, "split", True),
    }
    for key, what in (("dma_int8", "K4-int8 paged_decode_attention_dma, fused "
                       "int8 pool"),
                      ("k6", "K6 paged_decode_attention, split bf16 pools"),
                      ("k6_int8", "K6 paged_decode_attention, split int8 "
                       "pools")):
        t = timing[key]
        print(f"[15] {what} at serving widths (B=8, H=32, Hkv=8, hd=128, "
              f"page 16, bf16 q, window 4096): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, gather+dequantize+sdpa "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bytes']} B); {card}", flush=True)
    timing["q8"] = q8_timing(tq, card)
    t = timing["q8"]
    print(f"[15] matmul_q8 over one decode step's {t['per_step']} launches: "
          f"{t['step_ms']:.3f} ms against a bound of {t['step_bound_ms']:.3f} "
          f"ms; {card}", flush=True)

    cfg = TransformerConfig(**MISTRAL)
    params = mistral_params(cfg, SEED, torch.bfloat16)
    prompts = traffic(cfg)
    subset = [prompts[0], prompts[3], prompts[5], prompts[8], prompts[-1]]
    print(f"[16] serving Mistral-7B-v0.1 widths with the quantized and "
          f"split-pool options, {cfg.n_layers} layers, max_new 32, 8 slots, "
          f"page 16", flush=True)
    # each run drives a path of its own: launch counts start at 0 just
    # before it and are read just after it
    runs, launches = {}, {}
    plans = (("w8", prompts, dict(quantize_weights=True), "dma", True),
             ("w8kv8", prompts, dict(quantize_weights=True, quantize_kv=True),
              "dma", True),
             ("split", subset, dict(fused_pool=False), "k6", False),
             ("split kv8", subset, dict(fused_pool=False, quantize_kv=True),
              "k6", False))
    with torch.no_grad():
        for label, ps, options, attn_key, w8 in plans:
            reset_launches(pa, tq)
            run = serve(params, cfg, ps, 1, **options)
            got = read_launches(pa, tq)
            steps = run["stats"]["decode_steps"]
            want = {"dma": 0, "k6": 0,
                    "q8": (5 * cfg.n_layers + 1) * steps if w8 else 0}
            want[attn_key] = cfg.n_layers * steps
            check(steps > 0 and got == want,
                  f"{label}: launches {got} == {want} (attention layers x "
                  f"decode steps, matmul_q8 (5 x layers + 1) x decode steps)")
            runs[label], launches[label] = run, got
            print(f"  {label} ({len(ps)} requests): {steps} decode steps, "
                  f"decode {run['decode_ms_per_step']:.2f} ms/step (all "
                  f"steps; per-call median "
                  f"{run['median_call_ms_per_step']:.2f}), "
                  f"{run['gen_tok_per_s']:.1f} generated tok/s (prefill "
                  f"included) over {run['wall_s']:.2f} s, mean TTFT "
                  f"{run['stats']['mean_ttft_s'] * 1e3:.1f} ms; KV pools "
                  f"{run['srv'].pool_bytes() / 2**20:.0f} MiB; launches "
                  f"{got}; {card}", flush=True)
    kv8_data = runs["w8kv8"]["srv"].pools_k[0]
    check(2 * kv8_data.numel() * kv8_data.element_size()
          == runs["w8"]["srv"].pool_bytes(),
          "the int8 KV data takes half the bytes of the bf16 pools")
    # with scales: the fused pool's 128-lane fp32 scale rows add a quarter
    # of the int8 data (62.5% of bf16 in all), the split pools' (page, Hkv)
    # scales a thirty-second (51.6%)
    check(runs["split kv8"]["srv"].pool_bytes()
          < runs["w8kv8"]["srv"].pool_bytes()
          < 0.63 * runs["w8"]["srv"].pool_bytes(),
          "int8 pools with their scales stay under 63% of the bf16 pools")
    check(runs["split"]["srv"].pool_bytes() == runs["w8"]["srv"].pool_bytes(),
          "split and fused bf16 pools take the same bytes")

    # how far int8 weights and int8 KV move the served distribution from
    # the unquantized server's, while both decode the same tokens (printed,
    # not checked: it measures the quantization, not the port)
    far, same = 0.0, 0
    w8kv8 = runs["w8kv8"]
    for (ref_toks, ref_lps), rid in zip(reference, w8kv8["rids"]):
        req = w8kv8["srv"].requests[rid]
        n = first_difference(ref_toks, req.tokens)
        same += n
        if n:
            far = max(far, max(abs(x - y) for x, y in zip(ref_lps[:n],
                                                          req.logprobs[:n])))
    print(f"[17] w8kv8 vs the unquantized bf16 server: {same} of "
          f"{sum(len(t) for t, _ in reference)} tokens decoded alike before "
          f"each request's first difference; over those, max |dlogprob| "
          f"{far:.3g} (not checked)", flush=True)
    del runs

    print("[17] kernel path vs plain path, end to end", flush=True)
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params32 = mistral_params(cfg32, SEED + 1, torch.float32)
    prompts32 = [prompts[0], prompts[5], prompts[-1]]

    def maker(p, c, **options):
        return lambda: InferenceServer(p, c, batch_slots=8, page_size=16,
                                       n_pages=800, max_pages_per_seq=272,
                                       **options)

    # fp32 everywhere.  Without int8 weights only the attention's summation
    # order differs between the paths, as in phase 6: equal tokens, 1e-4
    # nat (int8 KV included: the K/V vectors it rounds are computed from
    # the same matmuls on both paths until the first attention output, and
    # the ~1e-7 that attention then differs by has not flipped a rounding
    # in this traffic).
    # With int8 weights every activation row is ROUNDED to int8 before
    # each matmul.  The attention kernel and its plain version agree to
    # ~1e-7, but an activation that sits within that of a rounding boundary
    # lands on the other neighbour: one int8 step of one element, which
    # moves a log-prob of this model by 5e-3 to 2e-2 nat (measured), and
    # near-ties of this random-weight model then decode another token.  So
    # the plain run is teacher-forced on the kernel run's tokens and every
    # step is compared: all of them at 0.05 nat (a wrong scale, page or
    # mask moves a log-prob by tenths), and those before a request's first
    # differing rounding at 1e-4 nat with the same greedy choice.  K5
    # itself, which is bit-equal to its plain version, is held exactly with
    # the attention plain on both sides.
    compare_servers("fp32 L2 split pools (K6)",
                    maker(params32, cfg32, fused_pool=False), prompts32, 1e-4)
    t_kv8 = compare_servers("fp32 L2 int8 KV, fused (K4-int8)",
                            maker(params32, cfg32, quantize_kv=True),
                            prompts32, 1e-4)
    t_kv8s = compare_servers("fp32 L2 int8 KV, split (K6)",
                             maker(params32, cfg32, quantize_kv=True,
                                   fused_pool=False), prompts32, 1e-4)
    w8kv8 = dict(quantize_weights=True, quantize_kv=True)
    t_w8 = compare_servers_forced("fp32 L2 w8kv8, fused (K5 + K4-int8)",
                                  maker(params32, cfg32, **w8kv8), prompts32,
                                  0.05, clean_tol=1e-4)
    t_w8s = compare_servers_forced("fp32 L2 w8kv8, split (K5 + K6)",
                                   maker(params32, cfg32, fused_pool=False,
                                         **w8kv8), prompts32, 0.05,
                                   clean_tol=1e-4)
    # the same device body on other strides sums in the same order
    check(t_kv8 == t_kv8s and t_w8 == t_w8s,
          "fused and split pools give the same tokens")
    compare_matmul_exactly("fp32 L2 w8kv8, fused",
                           maker(params32, cfg32, **w8kv8), prompts32)
    # bf16, 32 layers: as phase 6, 0.1 nat, on every step (in bf16 the
    # attention output itself differs by a rounding, so no step is clean)
    compare_servers_forced("bf16 L32 w8kv8 (K5 + K4-int8)",
                           maker(params, cfg, **w8kv8),
                           [prompts[0], prompts[1], prompts[-1]], 0.1,
                           max_new=8)

    print("[18] prefix cache (no window; 2 layers fp32)", flush=True)
    cfg_pc = dataclasses.replace(cfg32, attention_window=None)
    rng = np.random.default_rng(SEED + 8)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    shared_prompts = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist()
                      for n in (40, 7, 130, 64, 250, 16)]
    for kv8 in (False, True):
        outs = {}
        for cache in (True, False):
            with torch.no_grad():
                srv = InferenceServer(params32, cfg_pc, batch_slots=4,
                                      page_size=16, n_pages=400,
                                      max_pages_per_seq=40, prefix_cache=cache,
                                      quantize_kv=kv8)
                rids = [srv.submit(p, max_new=16) for p in shared_prompts]
                out = srv.run()
            outs[cache] = ([out[r] for r in rids],
                           [srv.requests[r].logprobs for r in rids],
                           srv.throughput_stats())
        (toks, lps, stats), (toks0, lps0, stats0) = outs[True], outs[False]
        alike = [first_difference(a, b) for a, b in zip(toks, toks0)]
        worst = max(abs(x - y) for a, b, n in zip(lps, lps0, alike)
                    for x, y in zip(a[:n], b[:n]))
        check(stats["prefix_hit_pages"] >= 16 * (len(shared_prompts) - 4)
              and stats0["prefix_hit_pages"] == 0,
              f"requests reuse the cached prefix pages "
              f"({stats['prefix_hit_pages']} hits)")
        check(stats["prefix_fresh_pages"] < stats0["prefix_fresh_pages"],
              "the cache allocates fewer pages")
        # fp32 KV: the suffix prefill sums in another order, ~1e-5 nat, and
        # no token changes.  int8 KV: a reused page is read back
        # DEQUANTIZED where the uncached prefill attended the fp values
        # (up to half an int8 step on every element of the prefix), so the
        # two servers differ by design; they are compared up to each
        # request's first differing token, at 0.05 nat.
        tol = 0.05 if kv8 else 1e-4
        check(min(alike) >= 1 and (kv8 or toks == toks0),
              "the prefix cache changes no token")
        check(worst <= tol, f"log-probs within {tol} of the uncached "
              f"server's (max {worst:.3g})")
        print(f"  {'int8' if kv8 else 'fp32'} KV: {stats['prefix_hit_pages']} "
              f"pages reused, {stats['prefix_fresh_pages']} allocated against "
              f"{stats0['prefix_fresh_pages']} without the cache, "
              f"{stats['cached_pages']} cached at the end; {sum(alike)} of "
              f"{sum(map(len, toks))} tokens alike before each request's "
              f"first difference, max |dlogprob| over those {worst:.3g}",
              flush=True)

    with torch.no_grad():
        prompt = torch.tensor([prompts[0][:64], prompts[2][:64]],
                              device="cuda")
        greedy = generate(params32, prompt, cfg32, 12)
        srv = InferenceServer(params32, cfg32, batch_slots=2, page_size=16,
                              n_pages=200, max_pages_per_seq=80)
        rids = [srv.submit(p.tolist(), max_new=12) for p in prompt]
        out = srv.run()
        beams, scores = beam_search(params32, prompt, cfg32, 12, beam=3)
        one, _ = beam_search(params32, prompt, cfg32, 12, beam=1)
    check(greedy.tolist() == [out[r] for r in rids],
          "generate's greedy tokens equal the server's")
    check(torch.equal(one[:, 0], greedy), "beam 1 is greedy")
    check(beams.shape == (2, 3, 12) and bool(torch.isfinite(scores).all())
          and bool((scores[:, 1:] <= scores[:, :-1]).all()),
          "beam search returns finite scores, best first")
    print(f"[19] generate and beam_search on the card (fp32 L2, 2 prompts of "
          f"{prompt.shape[1]}, 12 tokens): greedy equals the server; beam 3 "
          f"best scores {[round(float(x), 3) for x in scores[:, 0]]}",
          flush=True)

    with torch.no_grad():
        prof = decode_profile(params, cfg, prompts, quantize_weights=True,
                              quantize_kv=True)
    print_profile(f"[20] w8kv8 decode step profile (bf16 L32, 8 slots, "
                  f"{prof['steps']} steps, profiler on)", prof, card)

    def entry(name, line, key, n, err, source):
        t = timing[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"kfunca_tpu/ops/{line}", "launches": n,
                "max_abs_err": err, "max_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    # each entry's launches are those of ONE run of phase 16: the w8kv8
    # run for K4-int8 and K5, the split bf16 run for K6
    paged = "kfunca_tpu_torch/csrc/paged_attention.cu"
    return [
        entry("paged_decode_attention_dma_int8",
              "pallas_kernels/paged_attention.py:459", "dma_int8",
              launches["w8kv8"]["dma"], errs["dma_int8"], paged),
        entry("paged_decode_attention",
              "pallas_kernels/paged_attention.py:583", "k6",
              launches["split"]["k6"], errs["k6"], paged),
        entry("matmul_q8", "quant.py:77", "q8",
              launches["w8kv8"]["q8"], errs["q8"],
              "kfunca_tpu_torch/csrc/quant.cu"),
    ]


# -- phase 21-25: the eager Tensor API (K3, K7, K8, K9) ------------------------

ENGINE_KNOBS = ("KFUNCA_GEMM_ENGINE", "KFUNCA_REDUCE_ENGINE",
                "KFUNCA_ELEMENTWISE_ENGINE")
# bench.py's eager shapes: 4096^2 elementwise and GEMM, 16387^2 reductions
EW_SHAPE = (4096, 4096)
RED_SHAPE = (16387, 16387)
GEMM_MKN = (4096, 4096, 4096)
# the eager MLP block at Mistral-7B-v0.1 widths, and the fp32 check's
MLP_BF16 = dict(tokens=4096, d=4096, ff=14336, dtype=torch.bfloat16)
MLP_FP32 = dict(tokens=4096, d=1024, ff=3584, dtype=torch.float32)
# one eager MLP step z = gemm(relu(gemm(x, W1)), W2) + x, m = z.mean(0),
# m.backward(ones) with the three knobs at `pallas`: K3 2 forward + 4
# backward; K8 the mean; K9 the forward add, the tape's 7 gradient clones
# (interior nodes z, gemm(a, W2), relu's a and gemm(x, W1); leaves W2, W1
# and x's first gradient) and x's second gradient added into x.grad
MLP_LAUNCHES = {"matmul": 6, "reduce_2d": 1, "elementwise": 9,
                "welford_norm_stat": 0}


@contextlib.contextmanager
def engines(pallas: bool):
    """The three engine knobs at `pallas`, or unset (their defaults)."""
    before = {k: os.environ.get(k) for k in ENGINE_KNOBS}
    for k in ENGINE_KNOBS:
        if pallas:
            os.environ[k] = "pallas"
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def eager_wrappers():
    from kfunca_tpu_torch.ops.pallas_kernels import (
        elementwise, matmul, reduce, welford)
    return {"matmul": matmul.matmul, "welford_norm_stat":
            welford.welford_norm_stat, "reduce_2d": reduce.reduce_2d,
            "elementwise": elementwise.elementwise}


def eager_launches(counts=None):
    """Launch counts of K3, K7, K8 and K9 (and K1, K2); with `counts`, the
    counts since that snapshot."""
    from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as fa

    now = {k: f.launches for k, f in eager_wrappers().items()}
    now["flash_attention_fwd_stats"] = fa.flash_attention_fwd_stats.launches
    now["flash_attention_backward"] = fa.flash_attention_backward.launches
    return now if counts is None else {k: now[k] - counts[k] for k in now}


def reset_eager_launches():
    from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as fa

    for f in (*eager_wrappers().values(), fa.flash_attention_fwd_stats,
              fa.flash_attention_backward):
        f.launches = 0


def rel_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|), in fp64."""
    got, ref = got.double(), ref.double()
    check(bool(torch.isfinite(got).all()), "result is finite")
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def k9_checks(ew) -> float:
    """K9 against its plain version: the eight ops at 4096^2 in fp32,
    bf16 and fp16; integer division with zero and INT_MIN / -1 divisors;
    float -> int saturation.  Exact, but exp within 1 ulp of its type
    (both round the same fp32 expf; a 16-bit result can land one step
    over a rounding boundary)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    a = torch.randn(EW_SHAPE, generator=gen, device="cuda")
    b = torch.randn(EW_SHAPE, generator=gen, device="cuda")
    b = torch.where(b.abs() < 1e-3, 1.0, b)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        x, y = a.to(dt), b.to(dt)
        for op in ew.OPS:
            args = (x, y) if op in ("add", "sub", "mul", "div") else (x,)
            got = ew.elementwise(op, *args, acc_dt=torch.float32, out_dt=dt)
            want = ew.elementwise_plain(op, *args, acc_dt=torch.float32,
                                        out_dt=dt)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs()
            tol = (torch.finfo(dt).eps * want.double().abs() if op == "exp"
                   else torch.zeros_like(err))
            check(bool((err <= tol).all()), f"K9 {op} {dt} within "
                  f"{'1 ulp' if op == 'exp' else 'exact'} of plain (max "
                  f"{err.max().item():.3g})")
            worst = max(worst, err.max().item())
    for dt in (torch.int32, torch.int64):
        lo = torch.iinfo(dt).min
        x = torch.randint(-1000, 1000, EW_SHAPE, generator=gen, device="cuda",
                          dtype=dt)
        y = torch.randint(-5, 6, EW_SHAPE, generator=gen, device="cuda",
                          dtype=dt)  # zeros and -1 among them
        x[0, :4] = lo
        y[0, :4] = torch.tensor([-1, 0, 1, -1], device="cuda", dtype=dt)
        got = ew.elementwise("div", x, y, acc_dt=torch.int64, out_dt=dt)
        want = ew.elementwise_plain("div", x, y, acc_dt=torch.int64, out_dt=dt)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K9 {dt} division exact")
        check(got[0, :4].tolist() == [lo, -1, lo, lo] and
              bool((got[y == 0] == -1).all()),
              "x / 0 = -1 and INT_MIN / -1 = INT_MIN (lax.div)")
    f = torch.tensor([1.5, -2.5, 300.7, -1e10, float("nan")], device="cuda")
    for dt in (torch.int8, torch.uint8, torch.int32):
        got = ew.elementwise("copy", f, acc_dt=dt, out_dt=dt)
        want = ew.elementwise_plain("copy", f, acc_dt=dt, out_dt=dt)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K9 float -> {dt} saturates as plain")
    return worst


def k8_checks(rd) -> float:
    """K8 against its plain version at 16387^2: sum / mean / max of fp32,
    and of bf16 into bf16.  Both sum in fp32 in other orders: within
    1e-5 of the column's sum of |x| (bf16 output: plus one bf16 step,
    2^-8 of the value); max exact."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    x = torch.randn(RED_SHAPE, generator=gen, device="cuda") * 2.0 + 0.5
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        mass = xd.float().abs().sum(0, keepdim=True)
        for op in ("sum", "mean", "max"):
            got = rd.reduce_2d(xd, op)
            want = rd.reduce_2d_plain(xd, op)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs()
            if op == "max":
                tol = torch.zeros_like(err)
            else:
                scale = 1.0 if op == "sum" else 1.0 / RED_SHAPE[0]
                tol = 1e-5 * mass.double() * scale
                if dt != torch.float32:
                    tol = tol + want.double().abs() * 2.0 ** -8
            check(bool((err <= tol).all()), f"K8 {op} {dt} within tolerance "
                  f"(max err {err.max().item():.3g})")
            worst = max(worst, err.max().item())
    return worst


def k7_checks(wf) -> float:
    """K7 against its plain (two-pass) version at 16387^2 and a ragged
    1000 x 333: mean within 1e-5 of mean |x|, invstd within 1e-4
    relative (fp32 in other orders; Welford against two passes)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    worst = 0.0
    for shape in (RED_SHAPE, (1000, 333)):
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0 + 1.0
        m, s = wf.welford_norm_stat(x)
        pm, ps = wf.welford_norm_stat_plain(x)
        torch.cuda.synchronize()
        em = (m - pm).abs().max().item()
        es = ((s - ps).abs() / ps.abs()).max().item()
        check(em <= 1e-5 * x.abs().mean().item() and es <= 1e-4,
              f"K7 {shape} mean err {em:.3g}, invstd rel err {es:.3g}")
        worst = max(worst, em, (s - ps).abs().max().item())
    return worst


def k3_checks(mm) -> float:
    """K3 against its plain version: 4096^3 in bf16, fp16 and fp32; ragged
    (4095, 4097, 1000) and m = 1 with every epilogue; int8.  fp32 within
    1e-4 x max(1, max |ref|) (fp32 sums in other orders); 16-bit within
    2^-7 of max |ref| (both round one fp32 result; a hair's difference can
    flip a rounding); int8 exact."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    worst = 0.0

    def held(got, want, dt, what):
        nonlocal worst
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        top = want.double().abs().max().item()
        tol = 1e-4 * max(1.0, top) if dt == torch.float32 else 2.0 ** -7 * top
        check(err <= tol, f"K3 {what} {dt}: max err {err:.3g} <= {tol:.3g}")
        worst = max(worst, err)

    m, k, n = GEMM_MKN
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        a = (torch.randn((m, k), generator=gen, device="cuda")).to(dt)
        b = (torch.randn((k, n), generator=gen, device="cuda") / 64).to(dt)
        held(mm.matmul(a, b), mm.matmul_plain(a, b), dt, f"{m}x{k}x{n}")
    for m, k, n in ((4095, 4097, 1000), (1, 4096, 4096)):
        bias = torch.randn(n, generator=gen, device="cuda")
        res = torch.randn((m, n), generator=gen, device="cuda")
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = (torch.randn((k, n), generator=gen, device="cuda") / 64).to(dt)
            for epi in ("", "bias", "relu", "bias_gelu", "silu", "bias_silu_res",
                        "res"):
                kw = dict(bias=bias if "bias" in epi else None,
                          residual=res if "res" in epi else None, epilogue=epi)
                held(mm.matmul(a, b, **kw), mm.matmul_plain(a, b, **kw), dt,
                     f"{m}x{k}x{n} {epi or 'plain'}")
        a8 = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        b8 = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        got, want = mm.matmul(a8, b8), mm.matmul_plain(a8, b8)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"K3 int8 {m}x{k}x{n} exact")
    return worst


def eager_timing():
    """Phase 22: each kernel, its plain version and a library yardstick at
    the phase-21 shapes, with the bound from this run's inputs."""
    from kfunca_tpu_torch.ops.pallas_kernels import (
        elementwise as ew, matmul as mm, reduce as rd, welford as wf)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    out = {}

    def bound(nbytes, flops, dt):
        t_b = nbytes / HBM_BYTES_PER_S
        t_f = flops / PEAK_FLOPS[dt]
        return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")

    a = torch.randn(EW_SHAPE, generator=gen, device="cuda")
    b = torch.randn(EW_SHAPE, generator=gen, device="cuda")
    f32 = torch.float32
    bms, by = bound(3 * a.numel() * 4, a.numel(), f32)
    out["k9"] = dict(
        ms=time_ms(lambda: ew.elementwise("add", a, b, acc_dt=f32, out_dt=f32)),
        plain_ms=time_ms(lambda: ew.elementwise_plain("add", a, b, acc_dt=f32,
                                                      out_dt=f32)),
        library_ms=time_ms(lambda: torch.add(a, b)), bound_ms=bms, bound_by=by,
        what="add, 4096^2 fp32")
    del a, b
    x = torch.randn(RED_SHAPE, generator=gen, device="cuda")
    r, c = RED_SHAPE
    bms, by = bound((r * c + c) * 4, r * c, f32)
    out["k8"] = dict(ms=time_ms(lambda: rd.reduce_2d(x, "sum"), reps=10),
                     plain_ms=time_ms(lambda: rd.reduce_2d_plain(x, "sum"),
                                      reps=10),
                     library_ms=time_ms(lambda: torch.sum(x, 0), reps=10),
                     bound_ms=bms, bound_by=by, what="sum, 16387^2 fp32")
    out["k8"]["max_ms"] = time_ms(lambda: rd.reduce_2d(x, "max"), reps=10)
    out["k8"]["max_library_ms"] = time_ms(lambda: torch.amax(x, 0), reps=10)
    # Welford: 4 flops an element (sub, divide, two fused multiply-adds)
    bms, by = bound((r * c + 2 * c) * 4, 4 * r * c, f32)

    def library_norm_stat():
        var, mean = torch.var_mean(x, 0, correction=0)
        return mean, torch.rsqrt(var + 1e-12)

    out["k7"] = dict(ms=time_ms(lambda: wf.welford_norm_stat(x), reps=10),
                     plain_ms=time_ms(lambda: wf.welford_norm_stat_plain(x),
                                      reps=10),
                     library_ms=time_ms(library_norm_stat, reps=10),
                     bound_ms=bms, bound_by=by, what="16387^2 fp32")
    del x
    m, k, n = GEMM_MKN
    for dt, key in ((torch.bfloat16, "k3"), (torch.float32, "k3_fp32")):
        a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
        bms, by = bound((m * k + k * n + m * n) * a.element_size(),
                        2 * m * k * n, dt)
        out[key] = dict(ms=time_ms(lambda: mm.matmul(a, b), reps=10),
                        plain_ms=time_ms(lambda: mm.matmul_plain(a, b), reps=10),
                        library_ms=time_ms(lambda: torch.matmul(a, b), reps=10),
                        bound_ms=bms, bound_by=by,
                        what=f"{m}x{k}x{n} {str(dt)[6:]}")
    return out


def mlp_inputs(spec, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t, d, ff, dt = spec["tokens"], spec["d"], spec["ff"], spec["dtype"]
    x = torch.randn((t, d), generator=gen, device="cuda").to(dt)
    w1 = (torch.randn((d, ff), generator=gen, device="cuda")
          / math.sqrt(d)).to(dt)
    w2 = (torch.randn((ff, d), generator=gen, device="cuda")
          / math.sqrt(ff)).to(dt)
    return x, w1, w2


def eager_mlp(kfunca, x_t, w1_t, w2_t):
    """One eager MLP step through the kfunca API; returns the output, the
    mean and the three gradients as torch tensors."""
    x = kfunca.from_torch(x_t).set_requires_grad(True)
    w1 = kfunca.from_torch(w1_t).set_requires_grad(True)
    w2 = kfunca.from_torch(w2_t).set_requires_grad(True)
    h = kfunca.gemm(x, w1)
    a = h.relu()
    z = kfunca.gemm(a, w2) + x
    m = z.mean(0)
    m.backward(kfunca.from_torch(torch.ones_like(m.to_torch())))
    got = dict(z=z.to_torch(), m=m.to_torch(), gx=x.grad().to_torch(),
               gw1=w1.grad().to_torch(), gw2=w2.grad().to_torch())
    torch.cuda.synchronize()
    return got


def mlp_phase(kfunca, spec, seed, tol_of):
    """The MLP step with the knobs at `pallas` (launches asserted) and at
    their defaults (no launch of K3, K7, K8, K9), held against each
    other; returns the kernel run's host ms, launches and worst error."""
    x, w1, w2 = mlp_inputs(spec, seed)
    with engines(True):
        eager_mlp(kfunca, x, w1, w2)  # warm
        before = eager_launches()
        t0 = time.perf_counter()
        got = eager_mlp(kfunca, x, w1, w2)
        ms = (time.perf_counter() - t0) * 1e3
        n = eager_launches(before)
    want_n = {k: v for k, v in n.items() if k in MLP_LAUNCHES}
    check(want_n == MLP_LAUNCHES, f"eager MLP launches {want_n} == "
          f"{MLP_LAUNCHES}")
    with engines(False):
        before = eager_launches()
        t0 = time.perf_counter()
        ref = eager_mlp(kfunca, x, w1, w2)
        ref_ms = (time.perf_counter() - t0) * 1e3
        n0 = eager_launches(before)
    check(all(n0[k] == 0 for k in MLP_LAUNCHES),
          f"default engines launch no eager kernel ({n0})")
    worst = 0.0
    for key in got:
        err = (got[key].double() - ref[key].double()).abs().max().item()
        top = ref[key].double().abs().max().item()
        tol = tol_of(top)
        check(err <= tol, f"eager MLP {key}: kernels vs defaults max err "
              f"{err:.3g} <= {tol:.3g}")
        print(f"    {key}: max |kernels - defaults| {err:.3g}, max |defaults| "
              f"{top:.3g}", flush=True)
        worst = max(worst, err / max(top, 1e-30))
    return dict(ms=ms, ref_ms=ref_ms, launches=n, worst_rel=worst)


# lax.sort / lax.top_k orders of these rows, read from the JAX package on
# the CPU: NaN last both ways in sort, -0.0 and 0.0 tied; top_k by the
# float total order (+NaN first, -NaN last), ties by index
SORT_ROW = [3.0, float("nan"), -0.0, 0.0, 1.0, 3.0, -float("nan"),
            float("inf"), -float("inf"), 3.0, 0.0, -0.0]
SORT_ASC = [[8, 2, 3, 10, 11, 4, 0, 5, 9, 7, 1, 6],
            [3, 0, 1, 8, 9, 7, 2, 6, 11, 4, 5, 10]]
SORT_DESC = [[7, 0, 5, 9, 4, 2, 3, 10, 11, 8, 1, 6],
             [4, 2, 6, 11, 7, 0, 1, 8, 9, 3, 5, 10]]
TOPK_LARGEST = [[1, 7, 0, 5, 9], [10, 4, 2, 6, 11]]
TOPK_SMALLEST = [[8, 2, 3, 10, 11], [3, 0, 1, 8, 9]]


def eager_ops_phase(kfunca):
    """norm_stat / sum / mean at 16387^2, the elementwise ops at 4096^2
    (an out= write through a permuted view among them), sort / topk with
    NaN and ties, and the eager causal attention forward and backward;
    each held against torch."""
    from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    big = torch.randn(RED_SHAPE, generator=gen, device="cuda") * 2.0 + 0.5
    t = kfunca.from_torch(big)
    with engines(True):
        mean_t, invstd_t = t.norm_stat(0)
        s_t, mu_t = t.sum(0), t.mean(0)
    var, mean = torch.var_mean(big, 0, correction=0, keepdim=True)
    mass = big.abs().sum(0, keepdim=True)
    # as phase 21: fp32 sums in other orders, 1e-5 of the sum of |x|
    check(bool(((mean_t.to_torch() - mean).abs()
                <= 1e-5 * mass / RED_SHAPE[0]).all())
          and rel_err(invstd_t.to_torch(), torch.rsqrt(var + 1e-12)) <= 1e-4,
          "norm_stat through Tensor")
    check(bool(((s_t.to_torch() - big.sum(0, keepdim=True)).abs()
                <= 1e-5 * mass).all())
          and bool(((mu_t.to_torch() - big.mean(0, keepdim=True)).abs()
                    <= 1e-5 * mass / RED_SHAPE[0]).all()),
          "sum and mean through Tensor")
    del t, big, mean_t, invstd_t, s_t, mu_t

    a_t = torch.randn(EW_SHAPE, generator=gen, device="cuda")
    b_t = torch.randn(EW_SHAPE, generator=gen, device="cuda") + 3.0
    a, b = kfunca.from_torch(a_t), kfunca.from_torch(b_t)
    with engines(True):
        results = {"add": (a + b, a_t + b_t), "sub": (a - b, a_t - b_t),
                   "mul": (a * b, a_t * b_t), "div": (a / b, a_t / b_t),
                   "neg": (-a, -a_t), "abs": (a.abs(), a_t.abs()),
                   "exp": (a.exp(), torch.exp(a_t)),
                   "copy": (a.clone(), a_t),
                   "convert": (a.bfloat16(), a_t.bfloat16())}
        c_t = torch.randn(EW_SHAPE, generator=gen, device="cuda")
        c = kfunca.from_torch(c_t)
        ptr = c.data_ptr()
        view = c.permute(1, 0)
        view += a  # out= through a permuted view of c's storage
        qi = kfunca.from_torch(torch.tensor([7, -7, 5, -2 ** 31], device="cuda",
                                            dtype=torch.int32))
        di = kfunca.from_torch(torch.tensor([2, 2, 0, -1], device="cuda",
                                            dtype=torch.int32))
        quotient = (qi / di).to_torch().tolist()
    for op, (got, want) in results.items():
        g = got.to_torch()
        err = (g.double() - want.double()).abs()
        # exact, but exp within 1 ulp (expf on both sides, as in phase 21)
        tol = (torch.finfo(want.dtype).eps * want.double().abs()
               if op == "exp" else torch.zeros_like(err))
        check(g.dtype == want.dtype and bool((err <= tol).all()),
              f"eager {op} through Tensor (max err {err.max().item():.3g})")
    check(c.data_ptr() == ptr and torch.equal(c.to_torch(), c_t + a_t.t()),
          "+= through a permuted view writes the shared storage in place")
    check(quotient == [3, -3, -1, -2 ** 31], f"int32 division {quotient}")

    row = kfunca.from_torch(torch.tensor([SORT_ROW, SORT_ROW[::-1]],
                                         device="cuda"))
    asc, desc = row.sort(1, False)[1], row.sort(1, True)[1]
    top, bottom = row.topk(5, 1, True)[1], row.topk(5, 1, False)[1]
    got = [x.to_torch().tolist() for x in (asc, desc, top, bottom)]
    check(got == [SORT_ASC, SORT_DESC, TOPK_LARGEST, TOPK_SMALLEST],
          f"sort / topk orders of NaN, -0.0 and ties {got}")

    # K1 / K2 through the eager attention: B=1, H=32, S=2048, hd=128, bf16
    shape = (1, 32, 2048, 128)
    q_t, k_t, v_t, g_t = (torch.randn(shape, generator=gen, device="cuda")
                          .bfloat16() for _ in range(4))
    q, k, v = (kfunca.from_torch(x).set_requires_grad(True)
               for x in (q_t, k_t, v_t))
    out = kfunca.causal_attention(q, k, v)
    out.backward(kfunca.from_torch(g_t))
    ref = fa.flash_attention_plain(q_t, k_t, v_t)[0]
    dq, dk, dv = fa.flash_attention_backward_plain(q_t, k_t, v_t, g_t)
    for name, got_, want in (("out", out, ref), ("dq", q.grad(), dq),
                             ("dk", k.grad(), dk), ("dv", v.grad(), dv)):
        got_ = got_.to_torch()
        err = (got_.double() - want.double()).abs().max().item()
        tol = 2.0 ** -7 * want.double().abs().max().item()
        check(err <= tol, f"eager attention {name}: {err:.3g} <= {tol:.3g}")


def host_cost_per_op(kfunca, n=2000):
    """Host microseconds per eager add of two 256-element fp32 tensors
    (bench.py's dispatch-overhead reading), default engine and K9."""
    a = kfunca.from_torch(torch.ones(256, device="cuda"))
    b = kfunca.from_torch(torch.ones(256, device="cuda"))
    us = {}
    for label, pallas in (("default", False), ("K9", True)):
        with engines(pallas):
            for _ in range(50):
                a + b
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                a + b
            torch.cuda.synchronize()
            us[label] = (time.perf_counter() - t0) / n * 1e6
    return us


def eager_profile(kfunca):
    """torch.profiler over one eager MLP step at Mistral-7B-v0.1 widths
    with the knobs at `pallas` (after the main path: not counted)."""
    from torch.profiler import ProfilerActivity, profile

    x, w1, w2 = mlp_inputs(MLP_BF16, SEED + 27)
    with engines(True):
        eager_mlp(kfunca, x, w1, w2)  # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eager_mlp(kfunca, x, w1, w2)
            wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(prof, wall_us, 1, n_top=10)


def eager_phases(card):
    """Phases 21-24; returns the kernels-line entries of K3, K7, K8, K9."""
    import kfunca_tpu_torch as kfunca
    from kfunca_tpu_torch.ops.pallas_kernels import (
        elementwise as ew, matmul as mm, reduce as rd, welford as wf)

    print("[21] K9, K8, K7 and K3 vs their plain versions", flush=True)
    errs = {"k9": k9_checks(ew), "k8": k8_checks(rd), "k7": k7_checks(wf),
            "k3": k3_checks(mm)}
    for key, err in errs.items():
        print(f"  {key}: max abs err {err:.3g}", flush=True)
    free_device_memory()
    timing = eager_timing()
    for key, t in timing.items():
        extra = (f"; max {t['max_ms']:.4f} ms, torch.amax "
                 f"{t['max_library_ms']:.4f} ms" if "max_ms" in t else "")
        print(f"[22] {key} ({t['what']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}){extra}; {card}",
              flush=True)
    free_device_memory()

    print("[23] the eager Tensor API through `import kfunca_tpu_torch as "
          "kfunca`", flush=True)
    # the main path: every count starts at 0 here and is read at the end
    reset_eager_launches()
    runs = {}
    for label, spec, seed, tol_of in (
            ("bf16 MLP, Mistral-7B-v0.1 widths", MLP_BF16, SEED + 28,
             lambda top: 2.0 ** -7 * top),
            ("fp32 MLP, d 1024, ff 3584", MLP_FP32, SEED + 29,
             lambda top: 1e-4 * max(1.0, top))):
        r = mlp_phase(kfunca, spec, seed, tol_of)
        runs[label] = r
        print(f"  {label} ({spec['tokens']} tokens): kernels "
              f"{r['ms']:.1f} ms, defaults {r['ref_ms']:.1f} ms host clock a "
              f"step (forward + backward); launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }; worst "
              f"relative difference {r['worst_rel']:.3g}; {card}", flush=True)
        free_device_memory()
    eager_ops_phase(kfunca)
    launches = eager_launches()
    print(f"  norm_stat/sum/mean 16387^2, elementwise 4096^2 (out= through a "
          f"permuted view), sort/topk with NaN and ties, eager attention "
          f"B=1 H=32 S=2048 hd=128 bf16 forward + backward: all held; "
          f"phase-23 launches {launches}", flush=True)
    check(launches["welford_norm_stat"] >= 1
          and launches["flash_attention_fwd_stats"] >= 1
          and launches["flash_attention_backward"] >= 1,
          "phase 23 launched K7, K1 and K2")
    free_device_memory()

    prof = eager_profile(kfunca)
    print_profile("[24] eager MLP step profile (bf16, Mistral-7B-v0.1 "
                  "widths, knobs at pallas, profiler on)", prof, card)
    us = host_cost_per_op(kfunca)
    print(f"[24] host cost of an eager 256-element add: default "
          f"{us['default']:.1f} us/op, K9 {us['K9']:.1f} us/op; {card}",
          flush=True)
    free_device_memory()

    sources = {"k3": "matmul", "k7": "reduce", "k8": "reduce",
               "k9": "elementwise"}

    def entry(name, key, line, n, err):
        t = timing[key]
        return {"name": name, "route": "cuda",
                "source": f"kfunca_tpu_torch/csrc/{sources[key]}.cu",
                "replaces": f"kfunca_tpu/ops/pallas_kernels/{line}",
                "launches": n, "max_abs_err": err, "max_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    return [entry("matmul", "k3", "matmul.py:85", launches["matmul"],
                  errs["k3"]),
            entry("welford_norm_stat", "k7", "welford.py:81",
                  launches["welford_norm_stat"], errs["k7"]),
            entry("reduce_2d", "k8", "reduce.py:57", launches["reduce_2d"],
                  errs["k8"]),
            entry("elementwise", "k9", "elementwise.py:56",
                  launches["elementwise"], errs["k9"])]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kfunca_tpu_torch.ops.pallas_kernels import flash_attention as fa
    from kfunca_tpu_torch.runtime import _kernels
    from kfunca_tpu_torch.runtime.backend import resolve_device

    resolve_device()  # fp32 matmuls at full precision, as the JAX package
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = _kernels.build()
    print(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc, sm_90a)", flush=True)
    for name in sorted(built):
        for line in _kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    k4, reference = serving_phases(card)
    kernels = [k4]
    free_device_memory()

    print("[8] flash attention kernels (K1 forward, K2 backward) vs plain "
          "versions", flush=True)
    worst1, worst2 = flash_checks(fa)
    free_device_memory()
    timing = flash_timing(fa)
    free_device_memory()
    shape = ("B=1, H=32, Hkv=8, S=8192, hd=128, window 4096, bf16")
    for label, key in (("K1 forward", "fwd"), ("K2 backward", "bwd")):
        t = timing[key]
        print(f"[9] {label} at the training shape ({shape}): kernel "
              f"{t['ms']:.3f} ms (fp32 inputs {t['ms_fp32']:.3f} ms), plain "
              f"{t['plain_ms']:.3f} ms, scaled_dot_product_attention "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; {t['flops'] / 1e9:.1f} GFLOP, "
              f"{t['bytes']} B); {card}", flush=True)

    train = training_phases(fa, card)
    free_device_memory()
    end_to_end_fp32()
    free_device_memory()
    trainer_resume()

    src = "kfunca_tpu_torch/csrc/flash_attention.cu"
    jax_src = "kfunca_tpu/ops/pallas_kernels/flash_attention.py"
    for name, line, key, n, worst in (
            ("flash_attention_fwd_stats", 247, "fwd", train["launches"][0],
             worst1),
            ("flash_attention_backward", 547, "bwd", train["launches"][1],
             worst2)):
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{jax_src}:{line}", "launches": n,
            "max_abs_err": worst, "max_err": worst, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    free_device_memory()
    kernels += quant_phases(card, reference)
    free_device_memory()
    kernels += eager_phases(card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
