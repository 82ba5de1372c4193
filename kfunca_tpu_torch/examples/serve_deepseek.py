"""Serve a DeepSeek-V3-family model: HF import -> latent-slot serving.

Writes a tiny random DeepSeek-V3 checkpoint (MLA attention + sigmoid-routed
fine-grained MoE with shared experts; config.json and model.safetensors,
the weights through models/hf.to_hf) to a temporary directory, imports it
with from_hf, then serves a mixed batch of requests through MLAServer:
continuous batching over compressed-latent slots (one (kv_lora_rank +
qk_rope_head_dim) vector a position a layer instead of per-head K/V
pages) with absorbed-form decode.

Checks: every request's greedy tokens match the dense generate() path
exactly, despite running interleaved over fewer slots than requests.

    python -m kfunca_tpu_torch.examples.serve_deepseek
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch

from ..models.generate import generate
from ..models.hf import config_from_hf, from_hf, to_hf
from ..models.mla_serve import MLAServer
from ..models.transformer import init_params
from . import _common
from ._checkpoint import write_hf_dir

# transformers' DeepseekV3Config values of the tiny model
TINY_DEEPSEEK = {
    "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
    "vocab_size": 256, "hidden_size": 128, "intermediate_size": 256,
    "moe_intermediate_size": 64, "num_hidden_layers": 3,
    "first_k_dense_replace": 1, "num_attention_heads": 8,
    "num_key_value_heads": 8, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "n_group": 4,
    "topk_group": 2, "routed_scaling_factor": 2.5, "q_lora_rank": 64,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
    "v_head_dim": 16, "max_position_embeddings": 256, "rope_scaling": None,
    "tie_word_embeddings": True, "torch_dtype": "float32",
}


def write_tiny_deepseek(path, seed: int = 0) -> None:
    """A random DeepSeek-V3 checkpoint directory at TINY_DEEPSEEK's config:
    the port's init laws, fp32, the tied head left out."""
    cfg = config_from_hf(TINY_DEEPSEEK, dtype="float32")
    write_hf_dir(path, to_hf(init_params(seed, cfg, device="cpu"), cfg),
                 TINY_DEEPSEEK)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def load(dev):
    tmp = tempfile.mkdtemp(prefix="kfunca_tiny_deepseek_")
    try:
        write_tiny_deepseek(tmp)
        return from_hf(tmp, dtype="float32", device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(args) -> dict:
    """Import, the dense oracle, then MLAServer; returns both token lists,
    the seconds and the kernel launches."""
    dev = _common.device(args)
    print("== importing a tiny random DeepSeek-V3 ==")
    params, cfg = load(dev)
    print(f"   attention={cfg.attention} experts={cfg.n_experts} "
          f"shared={cfg.n_shared_experts} latent/pos = "
          f"{cfg.kv_lora_rank + cfg.qk_rope_head_dim} floats "
          f"(vs {2 * cfg.n_heads * 16} for per-head K/V)")
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 256, rng.integers(3, 10)))
               for _ in range(6)]
    launches = _common.Launches()

    print("== dense generate() oracle ==")
    with torch.no_grad():
        want = [generate(params, torch.tensor([p], device=dev), cfg,
                         max_new=8)[0].tolist() for p in prompts]

    print("== MLAServer: 6 requests over 2 latent slots ==")
    t0 = _common.now(dev)
    srv = MLAServer(params, cfg, batch_slots=2, max_seq_len=64, device=dev)
    rids = [srv.submit(p, max_new=8) for p in prompts]
    out = srv.run()
    dt = _common.now(dev) - t0
    got = [[int(t) for t in out[rid]] for rid in rids]
    for i, (g, ref) in enumerate(zip(got, want)):
        print(f"   req{i}: {g} {'ok' if g == ref else f'MISMATCH {ref}'}")
    n = launches.read()
    print(f"MLAServer: 6 requests x 8 tokens in {dt:.2f}s; "
          f"{_common.card(dev)}")
    print(_common.launch_line(n))
    return {"tokens": got, "want": want, "seconds": dt, "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    for i, (got, ref) in enumerate(zip(out["tokens"], out["want"])):
        if got != ref:
            raise SystemExit(f"request {i}: MLAServer {got} != dense {ref}")
    print("all requests token-exact vs the dense decode path")
    return out


if __name__ == "__main__":
    main()
