"""Parameter-efficient alignment: LoRA SFT -> LoRA-DPO -> serve.

A tiny model; every stage is the production module:

  * models/lora.py: rank-r adapters on a FROZEN base (grads and moments
    O(adapter); the base is never touched),
  * models/dpo.py: a LoRA-DPO preference step where the frozen base IS the
    reference model (one weight copy in all; step-0 loss = log 2),
  * models/serve.py: the trained wqkv adapter registers into the inference
    engine's multi-LoRA slots; one decode step serves base and adapter
    requests side by side.

On the card the steps run the flash attention kernels K1 / K2 and serving
the paged kernel K4.

    python -m kfunca_tpu_torch.examples.align_lora_dpo --sft-steps 20 --dpo-steps 20
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..models.dpo import make_lora_dpo_step
from ..models.lora import init_lora, make_lora_train_step, to_serving
from ..models.serve import InferenceServer
from ..models.train import OptConfig, init_opt_state
from ..models.transformer import TransformerConfig, init_params
from . import _common

CFG = TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, dtype="float32")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sft-steps", type=int, default=20)
    ap.add_argument("--dpo-steps", type=int, default=20)
    ap.add_argument("--rank", type=int, default=8)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def toy_data(cfg: TransformerConfig = CFG):
    """The prompts (4, 8) and the (tokens, targets) numpy pairs of the
    "chosen" continuations (token 7) and the "rejected" ones (token 11),
    the prompt masked (SFT convention)."""
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)

    def completion(tok_id):
        tok = np.concatenate(
            [prompt, np.full((4, 8), tok_id, np.int32)], axis=1)
        tgt = np.roll(tok, -1, axis=1).astype(np.int32)
        tgt[:, :7] = -100
        tgt[:, -1] = -100
        return tok, tgt

    return prompt, completion(7), completion(11)


def run(args, base=None, adapters=None) -> dict:
    """SFT, DPO, then serving; returns the SFT losses, the DPO metrics, the
    served tokens and the kernel launches.  `base` / `adapters` (on the
    device) replace the seeded inits."""
    dev = _common.device(args)
    cfg = CFG
    if base is None:
        base = init_params(0, cfg, device=dev)
    prompt, (tok_c, tgt_c), (tok_r, tgt_r) = toy_data(cfg)
    tok_c, tgt_c, tok_r, tgt_r = (torch.from_numpy(a).to(dev) for a in
                                  (tok_c, tgt_c, tok_r, tgt_r))
    launches = _common.Launches()
    t0 = _common.now(dev)

    # --- stage 1: LoRA SFT on the chosen data ---
    ad = adapters if adapters is not None else init_lora(
        torch.Generator(device=dev).manual_seed(1), cfg, rank=args.rank,
        targets=("wqkv",))
    opt = init_opt_state(ad["blocks"], device=dev)
    sft = make_lora_train_step(base, cfg, OptConfig(lr=3e-2, weight_decay=0.0),
                               ignore_index=-100, device=dev)
    sft_losses = []
    for i in range(args.sft_steps):
        ad, opt, loss = sft(ad, opt, tok_c, tgt_c)
        sft_losses.append(float(loss))
        if i % 5 == 0 or i == args.sft_steps - 1:
            print(f"[sft]  step {i:3d}  loss {sft_losses[-1]:.4f}")

    # --- stage 2: LoRA-DPO (frozen base = reference) ---
    opt = init_opt_state(ad["blocks"], device=dev)  # fresh moments
    dpo = make_lora_dpo_step(base, cfg, OptConfig(lr=1e-2, weight_decay=0.0),
                             beta=0.25, vocab_chunk=64, device=dev)
    dpo_metrics = []
    for i in range(args.dpo_steps):
        ad, opt, m = dpo(ad, opt, tok_c, tgt_c, tok_r, tgt_r)
        m = {k: float(v) for k, v in m.items()}
        dpo_metrics.append(m)
        if i % 5 == 0 or i == args.dpo_steps - 1:
            print(f"[dpo]  step {i:3d}  loss {m['loss']:.4f}  "
                  f"margin {m['reward_margin']:+.3f}  "
                  f"acc {m['reward_acc']:.2f}")
    dt = _common.now(dev) - t0
    steps = args.sft_steps + args.dpo_steps
    print(f"{steps} steps in {dt:.2f}s = {1e3 * dt / max(1, steps):.1f} "
          f"ms/step; {_common.card(dev)}")

    # --- stage 3: serve base + adapter side by side ---
    srv = InferenceServer(base, cfg, batch_slots=2, n_pages=64, page_size=8,
                          max_loras=2, lora_rank=args.rank, device=dev)
    lid = srv.register_lora(to_serving(ad))
    r_base = srv.submit(prompt[0], max_new=6)  # lora_id 0 = base
    r_tuned = srv.submit(prompt[0], max_new=6, lora_id=lid)
    srv.run()
    n = launches.read()
    print(f"[serve] base  : {srv.requests[r_base].tokens}")
    print(f"[serve] tuned : {srv.requests[r_tuned].tokens}  "
          f"(aligned toward token 7, away from 11)")
    print(_common.launch_line(n))
    return {"sft_losses": sft_losses, "dpo": dpo_metrics,
            "base_tokens": srv.requests[r_base].tokens,
            "tuned_tokens": srv.requests[r_tuned].tokens, "seconds": dt,
            "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    losses = out["sft_losses"] + [m["loss"] for m in out["dpo"]]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    return out


if __name__ == "__main__":
    main()
