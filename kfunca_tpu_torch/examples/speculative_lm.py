"""Speculative decoding example: a small draft model accelerates a larger
target model's greedy decoding with bit-identical output.

Both models are randomly initialized here (swap in checkpointed params for
real use); the draft shares the target's vocabulary.  Prints the
accepted-tokens-per-round diagnostic and verifies that the output matches
plain greedy generation exactly.  Both models keep the JAX example's
activation dtype (the config default, bf16).

    python -m kfunca_tpu_torch.examples.speculative_lm --max-new 48 --gamma 4
"""

from __future__ import annotations

import argparse

import torch

from ..models.generate import generate
from ..models.speculative import speculative_generate
from ..models.transformer import TransformerConfig, init_params
from . import _common

PROMPT = [[3, 141, 59, 26, 5]]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-new", type=int, default=48)
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--draft-d-model", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--draft-layers", type=int, default=2)
    _common.add_device_flag(p)
    return p.parse_args(argv)


def configs(args) -> tuple[TransformerConfig, TransformerConfig]:
    cfg_t = TransformerConfig(
        vocab_size=512, d_model=args.d_model, n_heads=8, n_layers=args.layers,
        d_ff=4 * args.d_model, max_seq_len=args.max_new + 64)
    cfg_d = TransformerConfig(
        vocab_size=512, d_model=args.draft_d_model, n_heads=4,
        n_layers=args.draft_layers, d_ff=4 * args.draft_d_model,
        max_seq_len=args.max_new + 64)
    return cfg_t, cfg_d


def run(args) -> dict:
    """Plain greedy, then speculative; returns both token lists, the target
    forwards, both times and the kernel launches."""
    dev = _common.device(args)
    cfg_t, cfg_d = configs(args)
    params_t = init_params(0, cfg_t, device=dev)
    params_d = init_params(1, cfg_d, device=dev)
    prompt = torch.tensor(PROMPT, dtype=torch.int32, device=dev)
    launches = _common.Launches()

    t0 = _common.now(dev)
    with torch.no_grad():
        ref = generate(params_t, prompt, cfg_t, max_new=args.max_new)
    t_plain = _common.now(dev) - t0

    t0 = _common.now(dev)
    got, rounds = speculative_generate(params_t, cfg_t, params_d, cfg_d,
                                       prompt, max_new=args.max_new,
                                       gamma=args.gamma)
    t_spec = _common.now(dev) - t0
    n = launches.read()
    got, ref = got[0].tolist(), ref[0].tolist()
    print(f"tokens: {got}")
    print(f"target forwards: {int(rounds)} (vs {args.max_new} plain): "
          f"{args.max_new / int(rounds):.2f} tokens/round accepted")
    print(f"wall: plain {t_plain:.2f}s  speculative {t_spec:.2f}s; "
          f"{_common.card(dev)}")
    print(_common.launch_line(n))
    return {"tokens": got, "greedy": ref, "rounds": int(rounds),
            "plain_s": t_plain, "speculative_s": t_spec, "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if out["tokens"] != out["greedy"]:
        raise SystemExit("speculative output must match greedy exactly")
    print("output EXACTLY matches plain greedy decoding")
    return out


if __name__ == "__main__":
    main()
