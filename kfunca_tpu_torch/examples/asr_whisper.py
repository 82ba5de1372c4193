"""ASR end-to-end: raw waveform -> log-mel -> train Whisper -> transcribe.

A tiny model; every stage is the production module:

  * models/audio.py: the log-mel front end,
  * models/whisper.py: the speech-to-text encoder-decoder, teacher-forced
    training and cached greedy decoding.

The task: each "utterance" is a sequence of pure tones, one of 8
frequencies a 100 ms slot; the transcript is the tone-class sequence, then
EOS.  A 2-layer Whisper learns it to near-perfect sequence accuracy in a
few hundred steps; the eval decodes HELD-OUT waveforms through
whisper_generate and fails below 90% exact match.  No kernel of the port
runs here (its attention, convs and FFTs are torch ops).

    python -m kfunca_tpu_torch.examples.asr_whisper
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.audio import log_mel_spectrogram
from ..models.train import OptConfig, init_opt_state
from ..models.whisper import WhisperConfig, init_whisper_params, \
    make_whisper_train_step, whisper_generate
from . import _common

SR = 16000
SLOT = 1600  # 100 ms a tone
N_TONES = 8
EOS = 1
FIRST = 2  # token id of tone class 0


def make_batch(rng, b, n_slots):
    """(waveforms (B, N) fp32, labels (B, n_slots+1) int32): tones + EOS,
    from a np.random.RandomState."""
    classes = rng.randint(0, N_TONES, (b, n_slots))
    freqs = 300.0 * (2.0 ** (classes * 0.5))  # 300 Hz .. ~3.4 kHz
    t = np.arange(SLOT) / SR
    wave = np.sin(2 * np.pi * freqs[..., None] * t)  # (B, slots, SLOT)
    wave = (wave * 0.5).reshape(b, -1).astype(np.float32)
    labels = np.concatenate(
        [classes + FIRST, np.full((b, 1), EOS)], axis=1)
    return wave, labels.astype(np.int32)


def features(wave, cfg: WhisperConfig, dev):
    feats = log_mel_spectrogram(torch.from_numpy(wave).to(dev),
                                n_mels=cfg.n_mels)
    return feats[:, :, : 2 * cfg.max_source_positions]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def config(args) -> WhisperConfig:
    n_frames = args.slots * SLOT // 160  # hop = 160
    return WhisperConfig(
        vocab_size=N_TONES + FIRST, n_mels=80, d_model=64, n_heads=2,
        n_enc_layers=2, n_dec_layers=2, d_ff=128,
        max_source_positions=n_frames // 2,
        max_target_positions=args.slots + 4, dtype="float32",
        decoder_start_id=0, eos_id=EOS)


def opt_config(args) -> OptConfig:
    return OptConfig(lr=3e-3, weight_decay=0.0, warmup_steps=20,
                     total_steps=args.steps, min_lr_frac=0.02)


def run(args, params=None) -> dict:
    """Train, then transcribe the held-out set; returns the losses, the
    exact-match rate, ms/step and the seconds.  `params` (on the device)
    replaces the seeded init."""
    dev = _common.device(args)
    cfg = config(args)
    if params is None:
        params = init_whisper_params(0, cfg, device=dev)
    oc = opt_config(args)
    opt = init_opt_state(params, oc, device=dev)
    step = make_whisper_train_step(cfg, oc, device=dev)
    rng = np.random.RandomState(0)
    losses = []
    t0 = _common.now(dev)
    for i in range(args.steps):
        wave, labels = make_batch(rng, args.batch, args.slots)
        params, opt, loss = step(params, opt, features(wave, cfg, dev),
                                 torch.from_numpy(labels).to(dev))
        losses.append(loss)
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    dt = _common.now(dev) - t0
    losses = [float(x) for x in losses]

    wave, labels = make_batch(np.random.RandomState(123), 32, args.slots)
    with torch.no_grad():
        out = whisper_generate(params, features(wave, cfg, dev), cfg,
                               max_new_tokens=args.slots + 1)
    out = out.cpu().numpy()
    exact = float((out == labels).all(axis=1).mean())
    print(f"held-out exact-match: {exact:.1%} "
          f"(sample: want={labels[0].tolist()} got={out[0].tolist()})")
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
