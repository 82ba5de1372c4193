"""Image captioning end-to-end: ViT prefix -> causal LM -> caption tokens.

A tiny model; every stage is the production module:

  * models/vision.py: the ViT patch encoder and the image-prefixed
    multimodal causal LM, whose text blocks run the flash attention
    kernels K1 / K2 on the card,
  * models/train.py: apply_update over the autograd gradients.

The dataset: each image lights up ONE quadrant (noise elsewhere) in one of
two intensities; the "caption" is [quadrant-token, intensity-token, EOS].
A tiny model learns it to near-perfect exact match; the eval decodes
held-out images greedily through multimodal_forward and fails below 90%.

    python -m kfunca_tpu_torch.examples.caption_multimodal
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.train import OptConfig, apply_update, init_opt_state, \
    value_and_grad_aux
from ..models.transformer import TransformerConfig
from ..models.vision import MultimodalConfig, ViTConfig, \
    init_multimodal_params, multimodal_forward, multimodal_loss
from . import _common

BOS, EOS = 1, 2
QUAD0, INT0 = 3, 7  # quadrant tokens 3..6, intensity tokens 7..8
CFG = MultimodalConfig(
    vit=ViTConfig(image_size=16, patch_size=4, d_model=64, n_heads=2,
                  n_layers=2, d_ff=128, dtype="float32"),
    text=TransformerConfig(vocab_size=16, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_seq_len=32,
                           dtype="float32"))


def make_batch(rng, b, size=16):
    """(images (B, size, size, 3) fp32, inputs [BOS, q, i], targets
    [q, i, EOS] int32), from a np.random.RandomState."""
    quad = rng.randint(0, 4, b)
    inten = rng.randint(0, 2, b)
    img = rng.normal(scale=0.1, size=(b, size, size, 3)).astype(np.float32)
    h = size // 2
    for i in range(b):
        r, c = divmod(quad[i], 2)
        img[i, r * h:(r + 1) * h, c * h:(c + 1) * h] += 0.5 + inten[i]
    inp = np.stack([np.full(b, BOS), QUAD0 + quad, INT0 + inten], 1)
    tgt = np.stack([QUAD0 + quad, INT0 + inten, np.full(b, EOS)], 1)
    return img, inp.astype(np.int32), tgt.astype(np.int32)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def opt_config(args) -> OptConfig:
    return OptConfig(lr=3e-3, weight_decay=0.0, warmup_steps=20,
                     total_steps=args.steps, min_lr_frac=0.05)


def run(args, params=None) -> dict:
    """Train, then caption the held-out images; returns the losses, the
    exact-match rate, ms/step, the seconds and the kernel launches.
    `params` (on the device) replaces the seeded init."""
    dev = _common.device(args)
    cfg = CFG
    if params is None:
        params = init_multimodal_params(0, cfg, device=dev)
    oc = opt_config(args)
    opt = init_opt_state(params, oc, device=dev)

    def step(params, opt, img, inp, tgt):
        loss, _, grads = value_and_grad_aux(
            lambda p: (multimodal_loss(p, img, inp, tgt, cfg), None), params)
        params, opt = apply_update(params, grads, opt, oc)
        return params, opt, loss

    def on(*arrays):
        return (torch.from_numpy(a).to(dev) for a in arrays)

    launches = _common.Launches()
    rng = np.random.RandomState(0)
    losses = []
    t0 = _common.now(dev)
    for i in range(args.steps):
        params, opt, loss = step(params, opt,
                                 *on(*make_batch(rng, args.batch)))
        losses.append(loss)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    dt = _common.now(dev) - t0
    losses = [float(x) for x in losses]

    # held-out greedy captioning (iterated teacher-free forward)
    img, _, tgt = make_batch(np.random.RandomState(123), 64)
    img_t = torch.from_numpy(img).to(dev)
    toks = torch.full((64, 1), BOS, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(3):
            logits = multimodal_forward(params, img_t, toks, cfg)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    got = toks[:, 1:].cpu().numpy()
    n = launches.read()
    exact = float((got == tgt).all(axis=1).mean())
    print(f"held-out caption exact-match: {exact:.1%} "
          f"(sample: want={tgt[0].tolist()} got={got[0].tolist()})")
    print(f"{args.steps} steps in {dt:.1f}s = {1e3 * dt / args.steps:.1f} "
          f"ms/step; {_common.card(dev)}")
    print(_common.launch_line(n))
    return {"losses": losses, "exact": exact, "tokens": got, "seconds": dt,
            "ms_per_step": 1e3 * dt / args.steps, "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if out["exact"] < 0.9:
        raise SystemExit("expected >=90% exact match")
    print("OK")
    return out


if __name__ == "__main__":
    main()
