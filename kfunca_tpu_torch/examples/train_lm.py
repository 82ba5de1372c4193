"""End-to-end LM training example: data -> train loop -> checkpoint ->
generation.

Trains on a synthetic corpus with learnable structure, saves and restores
the params and optimizer state, then decodes greedily from the restored
params.  On the card the step runs bf16 activations over fp32 masters with
the flash attention kernels K1 / K2 (csrc/flash_attention.cu).

    python -m kfunca_tpu_torch.examples.train_lm --steps 20
    python -m kfunca_tpu_torch.examples.train_lm --device cpu --steps 5
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from ..models.data import Prefetcher, TokenDataset
from ..models.generate import generate
from ..models.train import init_opt_state, make_train_step
from ..models.transformer import TransformerConfig, init_params
from ..utils import checkpoint
from . import _common


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                  "kfunca_lm.npz"))
    _common.add_device_flag(p)
    return p.parse_args(argv)


def config(args, dev) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=args.d_model,
        n_heads=max(2, args.d_model // 64), n_layers=args.layers,
        d_ff=args.d_model * 3, dtype=_common.card_dtype(dev))


def corpus(vocab_size: int) -> np.ndarray:
    """Arithmetic sequences mod the vocabulary (int64, as numpy makes it)."""
    rng = np.random.default_rng(0)
    return np.cumsum(rng.integers(1, 5, size=1 << 18)) % vocab_size


def run(args, params=None) -> dict:
    """Train, checkpoint, restore and decode; returns the losses, the
    greedy tokens, ms/step, tokens/s and the kernel launches.  `params`
    (on the device) replaces the seeded init."""
    dev = _common.device(args)
    cfg = config(args, dev)
    if params is None:
        params = init_params(0, cfg, device=dev)
    opt = init_opt_state(params, device=dev)
    # chunked-vocab loss: streams the LM head in 256-wide chunks, bounding
    # peak memory at O(B*S*chunk)
    step = make_train_step(cfg, loss_chunk=256, device=dev)
    base = corpus(cfg.vocab_size)
    ds = TokenDataset(base.astype(np.int32), args.seq, args.batch, seed=1,
                      device=dev)
    pf = Prefetcher(ds)
    launches = _common.Launches()
    losses = []
    try:
        t0 = _common.now(dev)
        for i in range(args.steps):
            tokens, targets = pf.next()
            params, opt, loss = step(params, opt, tokens, targets)
            losses.append(loss)
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {float(loss):.4f}")
        dt = _common.now(dev) - t0
    finally:
        pf.close()
    n = launches.read()
    losses = [float(x) for x in losses]
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"{args.steps} steps in {dt:.1f}s = {1e3 * dt / args.steps:.1f} "
          f"ms/step, {tok_s / 1e3:.1f}k tok/s; {_common.card(dev)}")

    checkpoint.save(args.ckpt, {"params": params, "opt": opt})
    print(f"checkpoint -> {args.ckpt}")
    restored = checkpoint.load(args.ckpt, like={"params": params, "opt": opt})
    prompt = torch.from_numpy(base[:8][None, :].astype(np.int32)).to(dev)
    with torch.no_grad():
        toks = generate(restored["params"], prompt, cfg, max_new=16)
    greedy = toks[0].tolist()
    print("prompt :", base[:8].tolist())
    print("greedy :", greedy)
    print("truth  :", base[8:24].tolist())
    print(_common.launch_line(n))
    return {"losses": losses, "greedy": greedy, "seconds": dt,
            "ms_per_step": 1e3 * dt / args.steps, "tok_s": tok_s,
            "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit(f"non-finite loss: {out['losses']}")
    return out


if __name__ == "__main__":
    main()
