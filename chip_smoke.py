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
  8. print the kernels line, the card line and, last, the result line.

Needs no network and imports nothing of JAX or kfunca_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
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


def time_ms(fn, reps=30) -> float:
    """Median device time of one call, from CUDA events around each call,
    with the 50 MB L2 flushed before each (decode reads each layer's pages
    cold)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
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
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:8],
                steps=steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kfunca_tpu_torch.models.transformer import TransformerConfig
    from kfunca_tpu_torch.ops.pallas_kernels import paged_attention as pa
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
    for line in _kernels.build_log("paged_attention").splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())

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
    print(f"[7] decode step profile (bf16 L32, 8 slots, "
          f"{prof['steps']} steps, profiler on): {prof['wall_ms']:.2f} ms/step"
          f" host clock, device busy {prof['busy_ms']:.2f} ms/step "
          f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); {card}")
    for name, us in prof["top"]:
        print(f"    {us / prof['steps'] / 1e3:8.3f} ms/step  {name[:100]}")

    kernels = [{
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
