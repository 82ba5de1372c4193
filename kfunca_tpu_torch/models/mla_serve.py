"""Continuous-batching inference for MLA models over compressed-latent slots.

Counterpart of kfunca_tpu/models/mla_serve.py.  Where the paged engine
(models/serve.py) pools per-head K/V pages, an MLA slot caches ONE
(kv_lora_rank + qk_rope_head_dim) latent row a position a layer, and
decode runs in the absorbed form (mla.mla_attend_cached_perslot).  Slots
are dense (B, max_len, ...) rows, not pages: the latent row is so small
that paging would cost more than it saves at serving batch sizes.

As in the JAX server:
  * one decode step serves every slot at its own position: (B,) tokens ->
    (B,) next tokens, each slot's latent written in place; idle slots
    decode harmlessly (admission overwrites their rows);
  * prefill is the batch-1 cached forward (generate.forward_with_cache)
    over the prompt padded right to a power-of-two bucket, the bucket
    clamped to max_seq_len; the padded tail writes latents that decode
    never reads (each slot's causal mask stops at its position);
  * per-request temperature rides as a (B,) vector, 0 being argmax.
The JAX server compiles one program a bucket and one decode step; here
they are eager calls.  Sampling draws from a torch.Generator seeded with
`seed` on the server's device: torch and jax.random draw different numbers,
so sampled tokens match the JAX server in distribution only, and greedy
tokens match it token for token.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.backend import resolve_device
from ..utils.tree import tree_leaves
from .generate import forward_with_cache, init_kv_cache
from .mla import mla_attend_cached_perslot
from .transformer import (
    TransformerConfig, _plain_mm, apply_norm, embed_tokens, lm_head_weight,
    mlp,
)


def _mla_token_step(params, tokens, caches, positions,
                    cfg: TransformerConfig):
    """(B,) tokens at (B,) per-slot positions -> logits (B, V) fp32; each
    slot's latent goes into the caches in place."""
    x = embed_tokens(params, tokens[:, None], cfg)  # (B, 1, d)
    for p, lc in zip(params["blocks"], caches):
        y = apply_norm(x, p, "attn_norm", cfg)
        o, _ = mla_attend_cached_perslot(y, p, lc, positions, cfg)
        x = x + o.to(x.dtype)
        y = apply_norm(x, p, "mlp_norm", cfg)
        x = x + mlp(y, p, cfg).to(x.dtype)
    x = apply_norm(x, params, "final_norm", cfg)
    return _plain_mm(x[:, 0], lm_head_weight(params, x.dtype))


class MLAServer:
    """Continuous-batching greedy / sampled decoding over latent slots, on
    `device` (default: the CUDA device; raises without one unless
    device="cpu").  `params` must already be on that device."""

    def __init__(self, params, cfg: TransformerConfig, batch_slots: int = 4,
                 max_seq_len: int = 256, eos_token: int | None = None,
                 seed: int = 0, device=None):
        if cfg.attention != "mla":
            raise ValueError("MLAServer serves MLA configs")
        self.device = resolve_device(device)
        devices = {p.device for p in tree_leaves(params)}
        if devices != {self.device}:
            raise ValueError(f"params are on {sorted(map(str, devices))}, "
                             f"the server on {self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_seq_len
        self.eos = eos_token
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.caches = init_kv_cache(cfg, batch_slots, max_seq_len,
                                    self.device)
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int64,
                                  device=self.device)
        self.positions = torch.zeros((batch_slots,), dtype=torch.int64,
                                     device=self.device)
        self._queue: list[dict] = []
        self._slots: list[dict | None] = [None] * batch_slots
        self._results: dict[int, list[int]] = {}
        self._next_id = 0
        self.decode_steps = 0

    # -- the step programs ---------------------------------------------------

    def _sample(self, logits, temps):
        """argmax where temps == 0, else a draw from softmax(logits / t)."""
        greedy = torch.argmax(logits, dim=-1)
        scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=self.gen)[:, 0]
        return torch.where(temps > 0.0, sampled, greedy)

    @torch.no_grad()
    def _decode_step(self, temps):
        logits = _mla_token_step(self.params, self.tokens, self.caches,
                                 self.positions, self.cfg)
        return self._sample(logits, temps)

    @torch.no_grad()
    def _prefill(self, prompt, n_valid: int):
        """prompt (1, bucket) -> (the last valid token's logits (V,), the
        batch-1 latent cache of max_seq_len positions)."""
        cache = init_kv_cache(self.cfg, 1, self.max_len, self.device)
        logits, cache = forward_with_cache(self.params, prompt, cache, 0,
                                           self.cfg)
        return logits[0, n_valid - 1], cache

    # -- public API ----------------------------------------------------------

    def submit(self, prompt, max_new: int = 16,
               temperature: float = 0.0) -> int:
        need = len(prompt) + int(max_new)
        if need > self.max_len:
            raise ValueError(f"request needs {need} positions > max_seq_len "
                             f"{self.max_len}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append({
            "id": rid, "prompt": [int(t) for t in prompt],
            "max_new": int(max_new), "temp": float(temperature),
        })
        return rid

    def _admit(self):
        for slot in range(self.B):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.pop(0)
            n = len(req["prompt"])
            # the bucket clamped to the cache: a non-power-of-two
            # max_seq_len would otherwise overrun it
            bucket = min(1 << max(0, (n - 1)).bit_length(), self.max_len)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = req["prompt"]
            logits, cache = self._prefill(
                torch.from_numpy(padded).to(self.device), n)
            temp = torch.tensor([req["temp"]], device=self.device)
            first = int(self._sample(logits[None], temp)[0])
            self.tokens[slot] = first
            self.positions[slot] = n
            for layer, lc in zip(self.caches, cache):
                layer["ckv"][slot] = lc["ckv"][0]
                layer["kpe"][slot] = lc["kpe"][0]
            req["out"] = [first]
            self._slots[slot] = req
            self._finish_if_done(slot)

    def _finish_if_done(self, slot):
        req = self._slots[slot]
        if req is None:
            return
        done = len(req["out"]) >= req["max_new"] or (
            self.eos is not None and req["out"][-1] == self.eos)
        if done:
            self._results[req["id"]] = req["out"]
            self._slots[slot] = None

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drain the queue; returns {request id: generated tokens}."""
        for _ in range(max_steps):
            self._admit()
            if all(s is None for s in self._slots):
                if not self._queue:
                    break
                continue
            temps = torch.tensor(
                [s["temp"] if s else 0.0 for s in self._slots],
                dtype=torch.float32, device=self.device)
            self.tokens = self._decode_step(temps)
            self.positions += 1
            self.decode_steps += 1
            toks = self.tokens.cpu().numpy()
            for slot, req in enumerate(self._slots):
                if req is None:
                    continue
                req["out"].append(int(toks[slot]))
                self._finish_if_done(slot)
        return self._results

    def cache_bytes(self) -> int:
        """Bytes of the slots' latent caches."""
        return sum(t.numel() * t.element_size() for lc in self.caches
                   for t in lc.values())
