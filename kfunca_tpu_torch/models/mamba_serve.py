"""Continuous-batching inference for Mamba: constant-memory slot states.

Counterpart of kfunca_tpu/models/mamba_serve.py.  A slot is a constant-size
recurrent state, (d_inner, d_state) fp32 plus a (k - 1, d_inner) conv tail
a layer, whatever the length of its sequence: no pages and no eviction;
admission writes a freshly prefilled state into a slot row.

As in the JAX server:
  * one decode step serves all slots: (B,) tokens -> (B,) next tokens and
    updated states; idle slots decode harmlessly (admission overwrites
    their rows);
  * prefill walks the prompt token by token through the recurrent step,
    padded right to a power-of-two bucket; padding steps pass the state
    through untouched (a mask on the device), so the state is exactly the
    unpadded prompt's;
  * per-request temperature rides as a (B,) vector: one step serves a
    mixed greedy / sampled batch (0 = argmax).
The JAX server compiles one program per bucket and one decode step; here
they are Python loops over eager ops.  Sampling draws from a
torch.Generator seeded with `seed` on the params' device: torch and
jax.random draw different numbers, so sampled tokens reproduce within the
port, and greedy tokens equal the JAX server's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map
from .mamba import MambaConfig, _token_step, init_mamba_state


class MambaServer:
    """Continuous-batching greedy / sampled decoding over slot states, on
    the device its params live on."""

    def __init__(self, params, cfg: MambaConfig, batch_slots: int = 4,
                 eos_token: int | None = None, seed: int = 0):
        devices = {p.device for p in tree_leaves(params)}
        if len(devices) != 1:
            raise ValueError(f"params are on {sorted(map(str, devices))}")
        self.device = devices.pop()
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.eos = eos_token
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.states = init_mamba_state(cfg, batch_slots, self.device)
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int32,
                                  device=self.device)
        self._queue: list[dict] = []
        self._slots: list[dict | None] = [None] * batch_slots
        self._results: dict[int, list[int]] = {}
        self._next_id = 0

    # -- the step programs ---------------------------------------------------

    def _sample(self, logits, temps):
        """argmax where temps == 0, else a draw from softmax(logits / t)."""
        greedy = torch.argmax(logits, dim=-1).int()
        scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None]
        sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=self.gen)[:, 0].int()
        return torch.where(temps > 0.0, sampled, greedy)

    @torch.no_grad()
    def _decode_step(self, params, tokens, states, temps):
        logits, states = _token_step(params, tokens, states, self.cfg)
        return self._sample(logits, temps), states

    def _prefill_fn(self, bucket: int):
        """run(params, prompt (1, bucket), n_valid) -> (the last valid
        token's logits (V,), per-layer states of batch 1); steps at or past
        n_valid leave the state and the logits as they were."""
        cfg = self.cfg

        @torch.no_grad()
        def run(params, prompt, n_valid):
            dev = prompt.device
            states = init_mamba_state(cfg, 1, dev)
            last = torch.zeros((cfg.vocab_size,), dtype=torch.float32,
                               device=dev)
            n_valid = torch.as_tensor(n_valid, device=dev)
            for i in range(prompt.shape[1]):
                logits, new = _token_step(params, prompt[0, i:i + 1], states,
                                          cfg)
                live = n_valid > i
                states = tree_map(lambda n, o: torch.where(live, n, o), new,
                                  states)
                last = torch.where(live, logits[0], last)
            return last, states

        return run

    # -- public API ----------------------------------------------------------

    def submit(self, prompt, max_new: int = 16,
               temperature: float = 0.0) -> int:
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
            bucket = 1 << max(0, (n - 1)).bit_length()
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = req["prompt"]
            logits, state = self._prefill_fn(bucket)(
                self.params, torch.from_numpy(padded).to(self.device), n)
            temp = torch.tensor([req["temp"]], device=self.device)
            first = int(self._sample(logits[None], temp)[0])
            self.tokens[slot] = first
            for layer, st in zip(self.states, state):
                layer["ssm"][slot] = st["ssm"][0]
                layer["conv"][slot] = st["conv"][0]
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
            self.tokens, self.states = self._decode_step(
                self.params, self.tokens, self.states, temps)
            toks = self.tokens.cpu().numpy()
            for slot, req in enumerate(self._slots):
                if req is None:
                    continue
                req["out"].append(int(toks[slot]))
                self._finish_if_done(slot)
        return self._results
