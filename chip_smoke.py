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
 14. print the kernels line, the card line and, last, the result line.

Needs no network and imports nothing of JAX or kfunca_tpu.
"""

from __future__ import annotations

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
    and run torch's scaled_dot_product_attention with a boolean mask."""
    b, h, hd = q.shape
    _, page, kv2 = pool.shape
    hkv = kv2 // (2 * hd)
    length = tables.shape[1] * page
    kv = pool[tables.long() + page_base].reshape(b, length, kv2)
    k = kv[..., : hkv * hd].reshape(b, length, hkv, hd).transpose(1, 2)
    v = kv[..., hkv * hd:].reshape(b, length, hkv, hd).transpose(1, 2)
    slot = torch.arange(length, device=q.device)[None, :]
    ok = slot <= pos.long()[:, None]
    if window is not None:
        ok = ok & (slot > pos.long()[:, None] - window)
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=ok[:, None, None, :], scale=1.0,
        enable_gqa=True)[:, :, 0]


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


def serve(params, cfg, prompts, burst, max_new=32, n_pages=800):
    from kfunca_tpu_torch.models.serve import InferenceServer
    from kfunca_tpu_torch.runtime.backend import sync

    srv = InferenceServer(params, cfg, batch_slots=8, page_size=16,
                          n_pages=n_pages, max_pages_per_seq=272,
                          decode_burst=burst)
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
    check(srv.pool.available == n_pages - 1, "every page returned to the pool")
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


def decode_profile(params, cfg, prompts, steps=4):
    """torch.profiler over `steps` single decode steps of a full batch of 8:
    the device's busy share of the host-clock time, and device time by
    kernel.  Runs after the main path, so its launches are not counted."""
    from torch.profiler import ProfilerActivity, profile

    from kfunca_tpu_torch.models.serve import InferenceServer

    srv = InferenceServer(params, cfg, batch_slots=8, page_size=16,
                          n_pages=800, max_pages_per_seq=272)
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
    """Phases 3-7; returns K4's entry of the kernels line."""
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
    }


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

    kernels = [serving_phases(card)]
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
