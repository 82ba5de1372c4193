"""Serving example: continuous-batching inference over a paged KV cache.

Submits a burst of prompts against a small randomly-initialized model (swap
in checkpointed params for real use), runs the scheduler until every
request completes, and prints throughput stats.  On the card the decode
attention is the paged kernel K4 (csrc/paged_attention.cu).

    python -m kfunca_tpu_torch.examples.serve_lm --requests 12 --slots 4 --max-new 32
    python -m kfunca_tpu_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.serve import InferenceServer
from ..models.transformer import TransformerConfig, init_params
from . import _common

# mixed batch: every 3rd request overrides the server sampling params
# (greedy / top-k / min-p); one decode step serves them all
OVERRIDES = [
    {},
    {"temperature": 0.0},
    {"temperature": 1.0, "top_k": 40, "min_p": 0.02},
]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    _common.add_device_flag(p)
    return p.parse_args(argv)


def config(args, dev) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=args.d_model,
        n_heads=max(2, args.d_model // 64), n_layers=args.layers,
        d_ff=args.d_model * 2, dtype=_common.card_dtype(dev))


def run(args) -> dict:
    """Serve the burst; returns the stats, every request's tokens, the
    seconds and the kernel launches."""
    dev = _common.device(args)
    cfg = config(args, dev)
    params = init_params(0, cfg, device=dev)
    launches = _common.Launches()
    srv = InferenceServer(
        params, cfg, batch_slots=args.slots, page_size=16, n_pages=512,
        max_pages_per_seq=16, temperature=args.temperature, top_p=args.top_p,
        device=dev)
    rng = np.random.default_rng(0)
    ids = [
        srv.submit(rng.integers(1, cfg.vocab_size, rng.integers(4, 24)).tolist(),
                   max_new=args.max_new, **OVERRIDES[i % len(OVERRIDES)])
        for i in range(args.requests)
    ]
    t0 = _common.now(dev)
    results = srv.run()
    dt = _common.now(dev) - t0
    stats = srv.throughput_stats()
    n = launches.read()
    print(f"completed {stats['completed']}/{len(ids)} requests in {dt:.2f}s")
    print(f"generated {stats['generated_tokens']} tokens "
          f"({stats['generated_tokens'] / dt:.1f} tok/s incl. prefill), "
          f"{stats['decode_steps']} decode steps "
          f"({1e3 * dt / max(1, stats['decode_steps']):.2f} ms/step); "
          f"{_common.card(dev)}")
    print(f"pages available after drain: {stats['pages_available']}")
    rid = ids[0]
    print(f"request {rid} tokens: {results[rid][:16]}...")
    print(_common.launch_line(n))
    return {"stats": stats, "requests": len(ids),
            "tokens": [results[r] for r in ids], "seconds": dt,
            "tok_s": stats["generated_tokens"] / dt, "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if out["stats"]["completed"] != out["requests"]:
        raise SystemExit(f"only {out['stats']['completed']} of "
                         f"{out['requests']} requests completed")
    return out


if __name__ == "__main__":
    main()
