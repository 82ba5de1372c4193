"""Online RL finetuning with GRPO: rollout -> reward -> group advantage ->
step.

A tiny model and a synthetic task, with the production recipe end to end:

  * models/rlhf.rollout_group: G sampled completions a prompt through
    generate(), packaged with masks and the sampling policy's own
    log-probs (the ratio anchor),
  * a programmatic reward (the fraction of even tokens; it stands in for
    a verifier, a unit test or a preference model),
  * models/rlhf.grpo_advantages: rewards standardized WITHIN each group
    (no value network),
  * models/rlhf.make_grpo_step: the PPO-clip surrogate + the k3 KL anchor
    against the frozen starting policy, several epochs over one rollout.

The draws come from a torch.Generator (seed 0 for the rounds, 99 for the
final rollout), so the rewards match the JAX example's in distribution
only.  On the card the step runs K1 / K2.

    python -m kfunca_tpu_torch.examples.rl_grpo --rounds 8 --group 8
"""

from __future__ import annotations

import argparse
import math

import torch

from ..models.rlhf import (grpo_advantages, make_grpo_step, rollout_group,
                           token_logprobs)
from ..models.train import OptConfig, init_opt_state
from ..models.transformer import TransformerConfig, init_params
from ..utils.tree import tree_map
from . import _common

CFG = TransformerConfig(vocab_size=97, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, max_seq_len=64, dtype="float32")
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8]]


def reward_fn(completions):
    """Fraction of even tokens: any black-box scorer slots in here."""
    return (completions % 2 == 0).float().mean(dim=-1)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--inner-epochs", type=int, default=2)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def run(args, params=None) -> dict:
    """The rounds and the final rollout; returns each round's rollout
    batch, rewards and step metrics, the final mean reward and the kernel
    launches.  `params` (on the device) replaces the seeded init."""
    dev = _common.device(args)
    cfg = CFG
    if params is None:
        params = init_params(0, cfg, device=dev)
    # KL anchor: the starting policy (the step updates params in place)
    ref_params = tree_map(torch.clone, params)
    oc = OptConfig(lr=3e-4, warmup_steps=0, weight_decay=0.0)
    opt_state = init_opt_state(params, oc, device=dev)
    step = make_grpo_step(cfg, oc, clip_eps=0.2, kl_beta=0.02,
                          vocab_chunk=None, device=dev)
    prompts = torch.tensor(PROMPTS, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    launches = _common.Launches()
    rounds = []
    t0 = _common.now(dev)
    for r in range(args.rounds):
        out = rollout_group(params, prompts, cfg, args.group, args.max_new,
                            temperature=1.0, generator=gen, vocab_chunk=None)
        rewards = reward_fn(out["completions"])
        adv = grpo_advantages(rewards, args.group)
        with torch.no_grad():
            ref_logp = token_logprobs(ref_params, out["tokens"],
                                      out["targets"], cfg, None)
        batch = {**out, "ref_logp": ref_logp, "adv": adv, "rewards": rewards}
        metrics = []
        for _ in range(args.inner_epochs):  # PPO-style rollout reuse
            params, opt_state, m = step(params, opt_state, out["tokens"],
                                        out["targets"], out["old_logp"],
                                        ref_logp, adv)
            metrics.append({k: float(v) for k, v in m.items()})
        m = metrics[-1]
        rounds.append({"batch": batch, "metrics": metrics,
                       "reward": float(rewards.mean())})
        print(f"round {r}: reward={rounds[-1]['reward']:.3f} "
              f"loss={m['loss']:+.4f} kl={m['kl']:.4f} "
              f"clip={m['clip_frac']:.3f}")
    dt = _common.now(dev) - t0
    final = reward_fn(rollout_group(
        params, prompts, cfg, args.group, args.max_new, temperature=1.0,
        generator=torch.Generator(device=dev).manual_seed(99),
        vocab_chunk=None)["completions"])
    n = launches.read()
    print(f"final mean reward: {float(final.mean()):.3f} "
          f"(chance level ~0.5); {args.rounds} rounds in {dt:.2f}s; "
          f"{_common.card(dev)}")
    print(_common.launch_line(n))
    return {"rounds": rounds, "final_reward": float(final.mean()),
            "seconds": dt, "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    losses = [m["loss"] for r in out["rounds"] for m in r["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    return out


if __name__ == "__main__":
    main()
