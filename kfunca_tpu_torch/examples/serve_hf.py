"""Serve a Hugging Face checkpoint: import -> quantize -> stream.

With --model DIR, loads a local Llama/Mistral/Qwen2-family checkpoint
directory (config.json and safetensors shards, read without transformers).
Without it, writes a tiny random Llama checkpoint to a temporary directory
first (config.json and model.safetensors, the weights through
models/hf.to_hf), so the example runs hermetically.  Demonstrates the
production recipe:

  * from_hf weight import,
  * int8 weights (K5, csrc/quant.cu) and an int8 KV cache (K4-int8) by
    default, bf16 weights and KV (K4) with --no-quant,
  * per-request sampling / penalties,
  * streaming token events + TTFT/TPOT stats,
  * optional tensor-parallel serving (--tp N: a LocalMesh of N ranks on the
    one card, split pools, K5 and K6 on each rank).

    python -m kfunca_tpu_torch.examples.serve_hf --requests 6 --max-new 24
    python -m kfunca_tpu_torch.examples.serve_hf --model /path/to/mistral --tp 2
"""

from __future__ import annotations

import argparse
import math
import shutil
import tempfile

import numpy as np
import torch

from ..models.hf import config_from_hf, from_hf, to_hf
from ..models.serve import InferenceServer
from ..models.transformer import init_params
from ..parallel.mesh import make_mesh
from . import _common
from ._checkpoint import write_hf_dir

# the tiny Llama of the hermetic run (transformers' LlamaConfig values)
TINY_LLAMA = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 512, "hidden_size": 256, "intermediate_size": 512,
    "num_hidden_layers": 4, "num_attention_heads": 4,
    "num_key_value_heads": 2, "max_position_embeddings": 512,
    "hidden_act": "silu", "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32",
}


def write_tiny_llama(path, seed: int = 0) -> None:
    """A random Llama checkpoint directory at TINY_LLAMA's config: the
    port's init laws (an untied head drawn as the matrices are), fp32."""
    cfg = config_from_hf(TINY_LLAMA, dtype="float32")
    params = init_params(seed, cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    s = 1.0 / math.sqrt(cfg.d_model)
    params["lm_head"] = torch.rand((cfg.d_model, cfg.vocab_size),
                                   generator=gen) * (2 * s) - s
    write_hf_dir(path, to_hf(params, cfg), TINY_LLAMA)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default=None, help="local HF checkpoint dir")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--rep-penalty", type=float, default=1.1)
    p.add_argument("--tp", type=int, default=0, help="tensor-parallel ways")
    p.add_argument("--no-quant", action="store_true")
    _common.add_device_flag(p)
    return p.parse_args(argv)


def load(args, dev):
    """(params, cfg) of --model, or of a hermetic tiny Llama written to a
    temporary directory and removed after the import."""
    if args.model:
        return from_hf(args.model, device=dev)
    tmp = tempfile.mkdtemp(prefix="kfunca_tiny_llama_")
    try:
        write_tiny_llama(tmp)
        return from_hf(tmp, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def make_server(params, cfg, args, mesh=None) -> InferenceServer:
    return InferenceServer(
        params, cfg, batch_slots=args.slots, page_size=16, n_pages=256,
        max_pages_per_seq=16, mesh=mesh,
        quantize_weights=not args.no_quant, quantize_kv=not args.no_quant,
        device=params["embed"].device)


def prompts(cfg, n: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size,
                         (int(rng.integers(4, 12)),)).tolist()
            for _ in range(n)]


def run(args) -> dict:
    """Import, serve the requests through stream(); returns every
    request's tokens, the stats and the kernel launches."""
    dev = _common.device(args)
    params, cfg = load(args, dev)
    print(f"imported: {cfg.n_layers}L d{cfg.d_model} h{cfg.n_heads}/"
          f"kv{cfg.kv_heads} vocab {cfg.vocab_size}")
    mesh = None
    if args.tp:
        mesh = make_mesh(args.tp, dp=1, tp=args.tp, device=dev)
        print(f"tensor-parallel over {args.tp} ranks ({type(mesh).__name__} "
              f"on {dev})")
    launches = _common.Launches()
    srv = make_server(params, cfg, args, mesh)
    rids = [srv.submit(prompt, max_new=args.max_new,
                       temperature=args.temperature,
                       repetition_penalty=args.rep_penalty)
            for prompt in prompts(cfg, args.requests)]
    t0 = _common.now(dev)
    for rid, tok, lp, last in srv.stream():
        print(f"req {rid}: +{tok}" + ("  [done]" if last else ""), flush=True)
    dt = _common.now(dev) - t0
    n = launches.read()
    stats = srv.throughput_stats()
    print(f"completed {stats['completed']} requests, "
          f"{stats['generated_tokens']} tokens in {dt:.2f}s; "
          f"ttft {stats['mean_ttft_s'] * 1e3:.0f} ms, "
          f"tpot {stats['mean_tpot_s'] * 1e3:.1f} ms; {_common.card(dev)}")
    print(_common.launch_line(n))
    return {"tokens": [srv.requests[r].tokens for r in rids],
            "requests": len(rids), "stats": stats, "seconds": dt,
            "cfg": cfg, "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if out["stats"]["completed"] != out["requests"]:
        raise SystemExit(f"only {out['stats']['completed']} of "
                         f"{out['requests']} requests completed")
    return out


if __name__ == "__main__":
    main()
