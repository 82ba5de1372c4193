"""Seq2seq end-to-end: train a tiny T5 to sort its input, then decode.

A tiny model; every stage is the production module:

  * models/t5.py: the encoder-decoder family (bucketed relative position
    bias, cross-attention, the teacher-forced loss, cached greedy
    generation),
  * models/train.py: the optimizer zoo (adamw here).

The task: output the input's (distinct) symbols SORTED ascending, then EOS:
content-addressable, the regime T5's position scheme is built for.  A
2-layer T5 learns it to near-perfect sequence accuracy in a few hundred
steps; the script reports the exact-match rate on held-out sequences
decoded with t5_generate (the cached path) and fails below 90%.  T5's
attention runs as torch ops (no kernel of the port runs here).

    python -m kfunca_tpu_torch.examples.seq2seq_t5
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.t5 import T5Config, init_t5_params, make_t5_train_step, \
    t5_generate
from ..models.train import OptConfig, init_opt_state
from . import _common

EOS, PAD = 1, 0
FIRST_TOKEN = 2  # ids [2, vocab) are payload symbols
CFG = T5Config(vocab_size=32, d_model=96, n_heads=4, d_kv=24, d_ff=192,
               n_enc_layers=2, n_dec_layers=2, dtype="float32",
               decoder_start_id=PAD, pad_id=PAD)


def make_batch(rng, b, s, vocab):
    """Input: distinct random symbols; label: sorted ascending, then EOS
    (numpy int32, from a np.random.RandomState)."""
    x = np.stack([rng.choice(np.arange(FIRST_TOKEN, vocab), s,
                             replace=False) for _ in range(b)])
    y = np.concatenate([np.sort(x, axis=1), np.full((b, 1), EOS)], axis=1)
    return x.astype(np.int32), y.astype(np.int32)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=8)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def opt_config(args) -> OptConfig:
    return OptConfig(lr=3e-3, weight_decay=0.0, warmup_steps=50,
                     total_steps=args.steps, min_lr_frac=0.02)


def run(args, params=None) -> dict:
    """Train, then decode the held-out set; returns the losses, the
    exact-match rate, ms/step and the seconds.  `params` (on the device)
    replaces the seeded init."""
    dev = _common.device(args)
    cfg = CFG
    if params is None:
        params = init_t5_params(0, cfg, device=dev)
    oc = opt_config(args)
    opt = init_opt_state(params, oc, device=dev)
    step = make_t5_train_step(cfg, oc, device=dev)
    rng = np.random.RandomState(0)
    losses = []
    t0 = _common.now(dev)
    for i in range(args.steps):
        enc, labels = make_batch(rng, args.batch, args.seq, cfg.vocab_size)
        params, opt, loss = step(params, opt, torch.from_numpy(enc).to(dev),
                                 torch.from_numpy(labels).to(dev))
        losses.append(loss)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    dt = _common.now(dev) - t0
    losses = [float(x) for x in losses]

    # held-out eval through the cached greedy decoder
    enc, want = make_batch(np.random.RandomState(123), 64, args.seq,
                           cfg.vocab_size)
    with torch.no_grad():
        out = t5_generate(params, torch.from_numpy(enc).to(dev), cfg,
                          max_new_tokens=args.seq + 1, eos_id=EOS)
    out = out.cpu().numpy()
    exact = float((out == want).all(axis=1).mean())
    print(f"held-out exact-match: {exact:.1%} "
          f"(sample: in={enc[0].tolist()} out={out[0].tolist()})")
    print(f"{args.steps} steps in {dt:.1f}s = {1e3 * dt / args.steps:.1f} "
          f"ms/step; {_common.card(dev)}")
    return {"losses": losses, "exact": exact, "tokens": out,
            "seconds": dt, "ms_per_step": 1e3 * dt / args.steps}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if out["exact"] < 0.9:
        raise SystemExit("expected >=90% exact match")
    print("OK")
    return out


if __name__ == "__main__":
    main()
