"""The whole framework in one script: raw text -> trained tokenizer ->
token batches -> training (optimizer zoo + EMA + grad accumulation) ->
checkpoint -> serving (continuous batching, per-request sampling) ->
beam-search eval.

A tiny model; every stage is the production module.  On the card training
runs the flash attention kernels K1 / K2 and serving the paged kernel K4.

    python -m kfunca_tpu_torch.examples.finetune_e2e --steps 30 --algo muon

Stages: models/tokenizer.py (native BPE) -> models/data.py (batcher) ->
models/train.py -> utils/checkpoint.py -> models/serve.py ->
models/generate.py beam_search.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from ..models.data import TokenDataset
from ..models.generate import beam_search
from ..models.serve import InferenceServer
from ..models.tokenizer import BPETokenizer
from ..models.train import (OptConfig, ema_params, init_opt_state,
                            make_train_step)
from ..models.transformer import TransformerConfig, init_params
from ..utils.checkpoint import load, save
from . import _common

_THINGS = ["ship", "gull", "wave", "wind", "rock", "star", "tide", "sail"]
_VERBS = ["sailed", "drifted", "turned", "rested", "sang", "rose", "fell"]
CORPUS = " ".join(
    f"the little {_THINGS[i % 8]} {_VERBS[(i * 3) % 7]} over the quiet sea"
    f" on day {i}." for i in range(400)
)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--algo", default="adamw",
                   choices=["adamw", "sgd", "lion", "adafactor", "muon"])
    p.add_argument("--grad-accum", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    _common.add_device_flag(p)
    return p.parse_args(argv)


def config(args, vocab_size: int, dev) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=vocab_size, d_model=128, n_heads=4, n_layers=2, d_ff=256,
        max_seq_len=args.seq_len * 2, dtype=_common.card_dtype(dev))


def opt_config(args) -> OptConfig:
    return OptConfig(algo=args.algo, lr=3e-3, clip_norm=1.0, warmup_steps=5,
                     total_steps=args.steps, ema_decay=0.9)


def run(args, params=None) -> dict:
    """Every stage; returns the losses, the served greedy and sampled
    tokens, the beam, ms/step and the kernel launches.  `params` (on the
    device) replaces the seeded init."""
    dev = _common.device(args)
    # 1) a byte-level BPE tokenizer trained on the corpus
    tok = BPETokenizer.train(CORPUS, vocab_size=384)
    ids = tok.encode(CORPUS)
    print(f"tokenizer: vocab {tok.vocab_size}, corpus {len(CORPUS)} chars -> "
          f"{len(ids)} tokens ({len(CORPUS) / len(ids):.2f} chars/token)")

    # 2) model + optimizer (EMA on; in-step gradient accumulation)
    cfg = config(args, tok.vocab_size, dev)
    oc = opt_config(args)
    if params is None:
        params = init_params(0, cfg, device=dev)
    opt = init_opt_state(params, oc, device=dev)
    step = make_train_step(cfg, oc, grad_accum=args.grad_accum, device=dev)

    # 3) the batcher over the tokenized corpus
    ds = TokenDataset(np.asarray(ids), seq_len=args.seq_len,
                      batch_size=args.batch, seed=0, device=dev)
    it = iter(ds)
    launches = _common.Launches()
    losses = []
    t0 = _common.now(dev)
    for i in range(args.steps):
        tokens, targets = next(it)
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.3f}")
    dt = _common.now(dev) - t0
    losses = [float(x) for x in losses]
    print(f"{args.steps} {args.algo} steps in {dt:.2f}s = "
          f"{1e3 * dt / args.steps:.1f} ms/step; {_common.card(dev)}")

    # 4) checkpoint the EMA weights and restore them for inference
    smooth = ema_params(opt, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ema_ckpt")
        save(ckpt, smooth)
        serving_params = load(ckpt, like=smooth)
        print(f"checkpointed EMA params -> {ckpt}")

    # 5) serve it: continuous batching, mixed per-request sampling
    prompt = tok.encode("the little ship ")
    srv = InferenceServer(serving_params, cfg, batch_slots=2, page_size=16,
                          n_pages=64, max_pages_per_seq=8, device=dev)
    greedy = srv.submit(prompt, max_new=24)
    sampled = srv.submit(prompt, max_new=24, temperature=0.8, top_k=12)
    out = srv.run()
    for name, rid in [("greedy", greedy), ("sampled", sampled)]:
        text = tok.decode(np.asarray(out[rid], np.int32))
        lp = sum(srv.requests[rid].logprobs)
        print(f"{name:8s} (logp {lp:7.2f}): {text!r}")

    # 6) beam search over the same model
    with torch.no_grad():
        seqs, scores = beam_search(
            serving_params, torch.from_numpy(prompt[None, :]).to(dev), cfg,
            max_new=24, beam=4, length_penalty=0.6)
    best = tok.decode(seqs[0, 0].cpu().numpy())
    print(f"beam-4   (score {float(scores[0, 0]):7.2f}): {best!r}")
    n = launches.read()
    print(_common.launch_line(n))
    return {"losses": losses, "greedy": out[greedy], "sampled": out[sampled],
            "beam": seqs[0, 0].tolist(), "seconds": dt,
            "ms_per_step": 1e3 * dt / args.steps,
            "done": [srv.requests[r].done for r in (greedy, sampled)],
            "decode_steps": srv.decode_steps,
            "launches": n}


def main(argv=None) -> dict:
    out = run(parse(argv))
    if not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit(f"non-finite loss: {out['losses']}")
    if not all(out["done"]):
        raise SystemExit("a served request did not complete")
    return out


if __name__ == "__main__":
    main()
