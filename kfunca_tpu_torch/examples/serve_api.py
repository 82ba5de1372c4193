"""Serve a model over HTTP: tokenizer + engine + OpenAI-style API.

Hermetic by default (tiny random model + a BPE tokenizer trained on an
in-script corpus); point --hf at a local Llama/Mistral/Qwen2/GPT-2/
GPT-NeoX checkpoint directory to serve real weights (then send token ids:
bring your own tokenizer).  Runs until interrupted.

    python -m kfunca_tpu_torch.examples.serve_api --port 8000 &
    curl -s localhost:8000/v1/models
    curl -s localhost:8000/v1/completions \
        -d '{"prompt": "the sea", "max_tokens": 24, "temperature": 0.7}'
    curl -sN localhost:8000/v1/completions \
        -d '{"prompt": "the wind", "max_tokens": 24, "stream": true}'
"""

from __future__ import annotations

import argparse
import time

from ..models.api_server import ApiServer
from ..models.hf import from_hf
from ..models.serve import InferenceServer
from ..models.tokenizer import BPETokenizer
from ..models.transformer import TransformerConfig, init_params
from . import _common

CORPUS = ("the sea rose and the wind sang over the quiet harbor "
          "the gulls turned in the morning light ") * 40


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--hf", default=None,
                    help="local HF checkpoint dir (needs its own tokenizer)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pages", type=int, default=256)
    _common.add_device_flag(ap)
    return ap.parse_args(argv)


def run(args) -> ApiServer:
    """Build the engine and start the HTTP front end; returns the started
    ApiServer (its .port is the bound port, `--port 0` picks a free one)."""
    dev = _common.device(args)
    if args.hf:
        params, cfg = from_hf(args.hf, device=dev)
        tok = None  # bring your own tokenizer for real checkpoints
    else:
        # the corpus holds fewer merges than the 512 ids asked for (326
        # ids), and every id the model can sample must decode: the model's
        # vocabulary is the tokenizer's (the JAX example sizes it at 512,
        # and a sampled id past 325 fails its request)
        tok = BPETokenizer.train(CORPUS, 512)
        cfg = TransformerConfig(vocab_size=tok.vocab_size, d_model=128,
                                n_heads=4, n_layers=2, d_ff=256,
                                dtype="float32", max_seq_len=512)
        params = init_params(0, cfg, device=dev)
    engine = InferenceServer(params, cfg, batch_slots=args.slots,
                             n_pages=args.pages, page_size=16, device=dev)
    srv = ApiServer(engine, tokenizer=tok, host=args.host,
                    port=args.port).start()
    print(f"serving on http://{srv.host}:{srv.port}  "
          f"(text={'yes' if tok else 'no: send token ids'}); "
          f"{_common.card(dev)}", flush=True)
    return srv


def wait(srv: ApiServer) -> None:
    """Serve until interrupted."""
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def main(argv=None) -> ApiServer:
    srv = run(parse(argv))
    try:
        wait(srv)
    finally:
        srv.shutdown()
    return srv


if __name__ == "__main__":
    main()
