"""Image generation end-to-end: train a DiT, sample it back from pure noise.

A tiny model; every stage is the production module:

  * models/dit.py: the adaLN-Zero diffusion transformer, DDPM
    eps-prediction training, the DDIM sampler (deterministic or
    eta-stochastic).

The dataset is a structured pattern (top half +1, bottom half -1, plus
pixel noise).  After a few hundred steps, DDIM sampling from pure noise
reproduces it: the script checks the generated images' top-bottom
contrast (want ~ +2: a mean above 1.7 and every image above 1.3).  The
draws (timesteps, noise, label drops, the sampler's start) come from
torch.Generators, so they match the JAX example's in distribution only.
DiT's attention is the encoders' einsum form: no kernel of the port runs
here.

    python -m kfunca_tpu_torch.examples.generate_dit
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.dit import DiTConfig, ddim_sample, init_dit_params, \
    make_dit_train_step
from ..models.train import OptConfig, init_opt_state
from . import _common

CFG = DiTConfig(image_size=16, patch_size=4, channels=1, d_model=96,
                n_heads=4, n_layers=3, d_ff=256, n_classes=2, timesteps=200,
                dtype="float32")


def make_batch(rng, b, size):
    """Top half +1, bottom half -1, pixel noise 0.1 (zero-mean data, the
    range diffusion's N(0,1) prior expects), from a np.random.RandomState;
    (images (B, size, size, 1) fp32, labels (B,) int32 zeros)."""
    img = rng.normal(scale=0.1, size=(b, size, size, 1)).astype(np.float32)
    half = size // 2
    img[:, :half] += 1.0
    img[:, half:] -= 1.0
    return img, np.zeros((b,), np.int32)


def contrast(imgs) -> np.ndarray:
    """Mean(top half) - mean(bottom half), per image."""
    half = imgs.shape[1] // 2
    return np.asarray(imgs[:, :half].mean(axis=(1, 2, 3))
                      - imgs[:, half:].mean(axis=(1, 2, 3)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eta", type=float, default=0.0)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def opt_config(args) -> OptConfig:
    return OptConfig(lr=2e-3, weight_decay=0.0, warmup_steps=20,
                     total_steps=args.steps, min_lr_frac=0.05)


def run(args, params=None) -> dict:
    """Train, then sample 16 images; returns the losses, the contrasts,
    the pixel std, ms/step and the seconds.  `params` (on the device)
    replaces the seeded init."""
    dev = _common.device(args)
    cfg = CFG
    if params is None:
        params = init_dit_params(0, cfg, device=dev)
    oc = opt_config(args)
    opt = init_opt_state(params, oc, device=dev)
    step = make_dit_train_step(cfg, oc, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    losses = []
    t0 = _common.now(dev)
    for i in range(args.steps):
        img, lab = make_batch(rng, args.batch, cfg.image_size)
        params, opt, loss = step(params, opt, gen,
                                 torch.from_numpy(img).to(dev),
                                 torch.from_numpy(lab).to(dev))
        losses.append(loss)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  eps-MSE {float(loss):.4f}")
    dt = _common.now(dev) - t0
    losses = [float(x) for x in losses]

    t1 = _common.now(dev)
    with torch.no_grad():
        imgs = ddim_sample(params, torch.Generator(device=dev).manual_seed(999),
                           torch.zeros((16,), dtype=torch.int32, device=dev),
                           cfg, steps=40, eta=args.eta, device=dev)
    sample_s = _common.now(dev) - t1
    imgs = imgs.cpu().numpy()
    c = contrast(imgs)
    print(f"sampled top-bottom contrast mean {c.mean():+.3f} "
          f"(want ~ +2.0), min {c.min():+.3f}; "
          f"pixel std {float(imgs.std()):.2f}")
    print(f"{args.steps} steps in {dt:.1f}s = {1e3 * dt / args.steps:.1f} "
          f"ms/step; 40 DDIM steps in {sample_s:.2f}s; {_common.card(dev)}")
    return {"losses": losses, "contrast": c, "std": float(imgs.std()),
            "seconds": dt, "ms_per_step": 1e3 * dt / args.steps,
            "sample_s": sample_s}


def main(argv=None) -> dict:
    out = run(parse(argv))
    c = out["contrast"]
    if not (c.mean() > 1.7 and c.min() > 1.3):
        raise SystemExit("samples do not reproduce the training pattern")
    print("OK")
    return out


if __name__ == "__main__":
    main()
