"""Serving engine: paged KV cache, batched decode, sampling, scheduler.

Counterpart of kfunca_tpu/models/serve.py, single-device path:

  * Paged KV cache: ONE layer-stacked pool of fused page rows
    (n_layers, n_pages, page_size, 2*Hkv*hd) = [k heads | v heads], the
    JAX engine's fused single-chip layout.  Pages come from a free-list
    allocator; a sequence owns a page table of max_pages_per_seq entries.
    The JAX engine updates its donated pool buffers in place; the port
    writes into the pool tensor in place (`pools[li, page, offset] = kv`).
  * Batched decode step: embed the B last tokens; per layer, scatter the
    new K/V into the pool, attend through the paged decode kernel
    (ops/pallas_kernels/paged_attention.py: the hand-written CUDA kernel on
    the card, its plain version on the CPU), run the MLP; then sample.
    `paged_decode_burst` runs `steps` decode steps per scheduler call (a
    Python loop in place of lax.scan).
  * Sampling: greedy, temperature, nucleus (top-p), top-k and min-p, per
    request; log-probs under the raw distribution.  torch.Generator and
    jax.random draw different numbers, so sampled output matches the JAX
    engine in distribution only; greedy output matches token for token.
  * Continuous batching over fixed decode slots with a FIFO queue; sliding
    window models free the pages that fall behind the window.

Prefill is models/generate.forward_with_cache (plain attention) over the
prompt padded to a page multiple, scattered into the slot's pages.

Later slices of the port (each raises NotImplementedError here): prefix
caching, multi-LoRA, weight and KV quantization, mesh (tensor-parallel)
serving, chunked prefill, logit penalties and constrained decoding, and
split K/V pools (the K6 kernel).
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.pallas_kernels.paged_attention import paged_decode_attention_dma
from ..runtime.backend import resolve_device
from .generate import _rope_at, forward_with_cache, init_kv_cache
from .transformer import (
    TransformerConfig, _plain_mm, apply_norm, apply_qk_norm, embed_tokens,
    lm_head_weight, mlp, split_qkv,
)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# page allocator and admission queue (the JAX package's Python fallbacks)
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list allocator over `n_pages` KV pages."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))

    def alloc(self, count: int) -> list[int] | None:
        """`count` page indices, or None if the pool can't satisfy it."""
        if len(self._free) < count:
            return None
        return [self._free.pop() for _ in range(count)]

    def free(self, pages: list[int]) -> None:
        self._free.extend(pages)

    @property
    def available(self) -> int:
        return len(self._free)


class RequestQueue:
    """FIFO admission queue."""

    def __init__(self):
        self._items: deque[int] = deque()

    def push(self, item: int) -> None:
        self._items.append(item)

    def pop(self) -> int | None:
        return self._items.popleft() if self._items else None

    def __len__(self) -> int:
        return len(self._items)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _categorical(logits, generator):
    """One draw per row from softmax(logits); -1e30 rows weigh nothing."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_tokens(logits, generator, temperature=0.0, top_p=1.0):
    """(B, V) logits -> (B,) int32 tokens.  Greedy when temperature == 0;
    nucleus filtering keeps the smallest prefix of the sorted distribution
    whose cumulative probability reaches top_p."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).int()
    logits = logits.float() / temperature
    if top_p >= 1.0:
        return _categorical(logits, generator).int()
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p  # keeps the top token
    filtered = torch.where(keep, sorted_logits, NEG_INF)
    choice = _categorical(filtered, generator)
    return sorted_idx.gather(-1, choice[:, None])[:, 0].int()


def token_logprobs(logits, tokens):
    """(B, V) raw logits + (B,) chosen tokens -> (B,) fp32 log-probs under
    the model's (untempered) distribution."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return logits.gather(-1, tokens.long()[:, None])[:, 0] - lse


def sample_tokens_per_slot(logits, generator, temperature, top_p, top_k,
                           min_p):
    """Per-slot sampling: every parameter is a (B,) tensor.  temperature
    <= 0 is greedy for that slot.  Filters compose on the sorted
    distribution: nucleus (top_p), top-k rank cut (top_k <= 0 = off) and
    min-p (keep tokens with prob >= min_p * max prob); the argmax token
    always survives."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp(temperature.float(), min=1e-6)[:, None]
    sorted_logits, sorted_idx = torch.sort(logits / t, dim=-1,
                                           descending=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p.float()[:, None]
    ranks = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    k = top_k.long()[:, None]
    keep &= torch.where(k > 0, ranks < k, True)
    keep &= probs >= min_p.float()[:, None] * probs[:, :1]
    keep[:, 0] = True
    filtered = torch.where(keep, sorted_logits, NEG_INF)
    choice = _categorical(filtered, generator)
    sampled = sorted_idx.gather(-1, choice[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy).int()


# ---------------------------------------------------------------------------
# batched paged decode step
# ---------------------------------------------------------------------------


def _paged_block(x, p, pools, li, page_tables, positions,
                 cfg: TransformerConfig, page_size: int):
    """One transformer block over B single tokens against the paged KV.

    x: (B, 1, dm); pools: the layer-stacked fused pool (L, n_pages, page,
    2*Hkv*hd), written in place at [li, page, offset]; page_tables:
    (B, max_pages) int32; positions: (B,) int32 (index of the new token).
    Returns x."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    max_pages = page_tables.shape[1]

    y = apply_norm(x, p, "attn_norm", cfg)
    qkv = _plain_mm(y, p["wqkv"])
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].float()
    q, k, v = split_qkv(qkv.to(y.dtype), cfg)  # q (B,H,1,hd), k/v (B,Hkv,1,hd)
    q, k = apply_qk_norm(q, k, p, cfg)
    if cfg.pos == "rope":  # each sequence at its own absolute position
        theta, pscale = cfg.rope_params()
        q = _rope_at(q, positions[:, None], theta, pscale, cfg.rope_pct)
        k = _rope_at(k, positions[:, None], theta, pscale, cfg.rope_pct)

    # Scatter the new K/V at (li, page_of(pos), pos % page), in place.
    # XLA clamps an out-of-range gather index and torch faults on one:
    # idle slots' positions keep growing inside a burst and can pass the
    # table width, so the page index is clamped as XLA would.  Idle slots
    # all write the same offset of the trash page; which write wins is
    # irrelevant, as nothing reads it.
    page_idx = torch.clamp(positions // page_size, max=max_pages - 1)
    page_slot = page_tables[torch.arange(b, device=x.device), page_idx]
    offset = positions % page_size
    kvnew = torch.cat([k[:, :, 0].reshape(b, -1), v[:, :, 0].reshape(b, -1)],
                      dim=-1)
    pools[li, page_slot.long(), offset.long()] = kvnew.to(pools.dtype)

    n_layers, n_pages = pools.shape[:2]
    qs = (q[:, :, 0] * torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype))
    attn = paged_decode_attention_dma(
        qs.contiguous(), pools.view(n_layers * n_pages, *pools.shape[2:]),
        page_tables, positions, window=cfg.attention_window,
        page_base=li * n_pages)
    attn = attn.to(x.dtype).reshape(b, 1, h * hd)
    o = _plain_mm(attn, p["wo"])
    if "bo" in p:
        o = o + p["bo"].float()
    if cfg.parallel_residual:  # GPT-NeoX/GPT-J: branches share the input
        y = apply_norm(x, p, "mlp_norm", cfg)
        return x + o.to(x.dtype) + mlp(y, p, cfg).to(x.dtype)
    x = x + o.to(x.dtype)
    y = apply_norm(x, p, "mlp_norm", cfg)
    return x + mlp(y, p, cfg).to(x.dtype)


def paged_decode_step(params, pools, page_tables, positions, last_tokens,
                      generator, cfg: TransformerConfig, page_size: int,
                      temperature=0.0, top_p=1.0, sampling=None):
    """One batched decode step over the paged KV (the JAX package's
    _decode_step_impl and its jitted paged_decode_step).

    `sampling`, when given, is a dict of (B,) tensors {temperature, top_p,
    top_k, min_p} for per-slot sampling; it overrides temperature/top_p.
    Writes each slot's new K/V into `pools` in place.  Returns
    (tokens (B,) int32, logprobs (B,) fp32); idle slots decode garbage
    that callers ignore."""
    x = embed_tokens(params, last_tokens.long()[:, None], cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][positions.long()][:, None].to(cfg.act_dtype)
    for li, p in enumerate(params["blocks"]):
        x = _paged_block(x, p, pools, li, page_tables, positions, cfg,
                         page_size)
    x = apply_norm(x, params, "final_norm", cfg)
    logits = _plain_mm(x[:, 0], lm_head_weight(params, x.dtype))
    if sampling is not None:
        tokens = sample_tokens_per_slot(
            logits, generator, sampling["temperature"], sampling["top_p"],
            sampling["top_k"], sampling["min_p"])
    else:
        tokens = sample_tokens(logits, generator, temperature, top_p)
    return tokens, token_logprobs(logits, tokens)


def paged_decode_burst(params, pools, page_tables, positions, last_tokens,
                       generator, cfg: TransformerConfig, page_size: int,
                       steps: int, temperature=0.0, top_p=1.0, sampling=None):
    """`steps` decode steps in one call (the scheduler does its
    bookkeeping after the burst and discards each slot's tail past its
    finish; pages for max_new are reserved at admission, so decoding past
    a finish writes only into pages the slot owns).  Returns
    (tokens (steps, B), logprobs (steps, B))."""
    toks, lps = [], []
    for _ in range(steps):
        last_tokens, lp = paged_decode_step(
            params, pools, page_tables, positions, last_tokens, generator,
            cfg, page_size, temperature, top_p, sampling)
        toks.append(last_tokens)
        lps.append(lp)
        positions = positions + 1
    return torch.stack(toks), torch.stack(lps)


# ---------------------------------------------------------------------------
# scheduler: continuous batching over fixed decode slots
# ---------------------------------------------------------------------------


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (T,) int32
    max_new: int
    tokens: list = field(default_factory=list)  # generated
    done: bool = False
    # per-request sampling overrides (None -> the server-wide default)
    temperature: float | None = None
    top_p: float | None = None
    top_k: int = 0  # 0 = off
    min_p: float = 0.0
    eos: int | None = None  # overrides the server eos_token
    # stop sequences: generation ends when the tail of the output matches
    # any of these token tuples (the stop tokens stay in the output)
    stop: tuple = ()
    # log-prob of each generated token under the raw distribution
    logprobs: list = field(default_factory=list)
    # wall-clock marks (perf_counter) for TTFT/TPOT
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    cancelled: bool = False


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is a later slice of the port")


class InferenceServer:
    """Continuous-batching inference over a paged KV cache.

    `batch_slots` sequences decode together; finished sequences release
    their pages and waiting requests are admitted with a prefill.  Runs on
    `device` (default: the CUDA device; raises without one unless
    device="cpu").  `params` must already be on that device."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        batch_slots: int = 4,
        page_size: int = 16,
        n_pages: int = 256,
        max_pages_per_seq: int = 16,
        temperature: float = 0.0,
        top_p: float = 1.0,
        eos_token: int | None = None,
        seed: int = 0,
        prefix_cache: bool = False,
        max_loras: int = 0,
        quantize_weights: bool = False,
        quantize_kv: bool = False,
        mesh=None,
        prefill_chunk: int | None = None,
        decode_burst: int = 1,
        fused_pool: bool | None = None,
        device=None,
    ):
        if cfg.attention == "mla":
            raise NotImplementedError(
                "this engine's page pools hold per-head K/V; MLA serving is a "
                "later slice of the port")
        for on, what in ((prefix_cache, "prefix caching"),
                         (max_loras, "multi-LoRA serving"),
                         (quantize_weights, "weight-quantized decode"),
                         (quantize_kv, "the int8 KV cache"),
                         (mesh is not None, "mesh (tensor-parallel) serving"),
                         (prefill_chunk is not None, "chunked prefill")):
            if on:
                raise _later(what)
        hkv, hd = cfg.kv_heads, cfg.head_dim
        aligned = (hkv * hd) % 128 == 0 and 2 * hkv <= 128
        if fused_pool is False or not aligned:
            raise _later(
                "split K/V pools (fused_pool=False, or kv_heads*head_dim "
                f"= {hkv * hd} not a multiple of 128), served by the K6 "
                "paged_decode_attention kernel,")
        if decode_burst < 1:
            raise ValueError(f"decode_burst must be >= 1, got {decode_burst}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.act_dtype not in (
                torch.float32, torch.bfloat16):
            raise _later(f"serving {cfg.dtype} pools on the card (the paged "
                         "decode kernel takes float32 and bfloat16)")
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"server on {self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.eos = eos_token
        self.decode_burst = int(decode_burst)
        self.requests: dict[int, Request] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # page n_pages-1 is the TRASH page: never allocated; idle slots
        # point their whole page table at it so their (harmless) decode
        # writes cannot corrupt pages owned by live sequences
        self.trash_page = n_pages - 1
        self.pool = PagePool(n_pages - 1)
        self.queue = RequestQueue()
        self.pools = torch.zeros(
            (cfg.n_layers, n_pages, page_size, 2 * hkv * hd),
            dtype=cfg.act_dtype, device=self.device)
        # model steps run by the decode loop (a burst of k counts k)
        self.decode_steps = 0
        # slot state (host side)
        self.slot_req = [None] * self.B  # req_id or None
        self.slot_pages = [[] for _ in range(self.B)]
        self.slot_watermark = [0] * self.B  # windowed: first live page index
        self.page_tables = np.full((self.B, self.max_pages), self.trash_page,
                                   np.int32)
        self.positions = np.zeros((self.B,), np.int32)  # index of next token
        self.last_tokens = np.zeros((self.B,), np.int32)
        # per-slot sampling params (used once any request overrides the
        # server defaults; idle slots keep the defaults)
        self._per_slot_sampling = False
        self.slot_temp = np.full((self.B,), self.temperature, np.float32)
        self.slot_top_p = np.full((self.B,), self.top_p, np.float32)
        self.slot_top_k = np.zeros((self.B,), np.int32)
        self.slot_min_p = np.zeros((self.B,), np.float32)

    # -- API ---------------------------------------------------------------

    def submit(self, prompt, max_new: int = 16, lora_id: int = 0, *,
               temperature: float | None = None, top_p: float | None = None,
               top_k: int = 0, min_p: float = 0.0, eos: int | None = None,
               stop=(), repetition_penalty: float = 1.0,
               presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
               logit_bias: dict | None = None, allowed_fn=None) -> int:
        """Queue a request; returns its id.  Sampling kwargs override the
        server defaults for this request only.  `stop` is an iterable of
        token sequences; matching the output tail ends the request (the
        stop tokens stay in the output)."""
        if lora_id:
            raise ValueError(f"unknown lora_id {lora_id}")
        if (repetition_penalty != 1.0 or presence_penalty or frequency_penalty
                or logit_bias):
            raise _later("logit penalties and bias")
        if allowed_fn is not None:
            raise _later("constrained decoding (allowed_fn)")
        rid = self._next_id
        self._next_id += 1
        stop = tuple(tuple(int(t) for t in s) for s in stop)
        req = Request(rid, np.asarray(prompt, np.int32), max_new,
                      temperature=temperature, top_p=top_p, top_k=int(top_k),
                      min_p=float(min_p), eos=eos, stop=stop,
                      submitted_at=time.perf_counter())
        if temperature is not None or top_p is not None or top_k or min_p:
            self._per_slot_sampling = True
        self.requests[rid] = req
        self.queue.push(rid)
        return rid

    def cancel(self, req_id: int) -> bool:
        """Abort a queued or decoding request now (its pages are freed; the
        tokens generated so far stay on it).  False if the id is unknown or
        the request already finished."""
        req = self.requests.get(req_id)
        if req is None or req.done:
            return False
        req.cancelled = True
        for slot in range(self.B):
            if self.slot_req[slot] == req_id:
                self._release(slot)
                return True
        # still queued: _admit skips done requests when they surface
        req.done = True
        req.finished_at = time.perf_counter()
        return True

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drive admission + decode until all submitted work completes."""
        for _ in self.stream(max_steps):
            pass
        return {rid: r.tokens for rid, r in self.requests.items() if r.done}

    def stream(self, max_steps: int = 10_000):
        """Incremental driver: yields (req_id, token, logprob, finished)
        events as tokens are produced.  The consumer may submit() between
        yields; the emit loop iterates a snapshot."""
        for _ in range(max_steps):
            before = {rid: len(r.tokens) for rid, r in self.requests.items()}
            self._admit()
            active = any(s is not None for s in self.slot_req)
            if active:
                self._step()
            for rid, r in list(self.requests.items()):
                for i in range(before.get(rid, 0), len(r.tokens)):
                    last = r.done and i == len(r.tokens) - 1
                    yield rid, r.tokens[i], r.logprobs[i], last
            if not active and len(self.queue) == 0:
                break

    def throughput_stats(self) -> dict:
        done = [r for r in self.requests.values() if r.done]
        ttft = [r.first_token_at - r.submitted_at for r in done
                if r.first_token_at]
        tpot = [(r.finished_at - r.first_token_at) / (len(r.tokens) - 1)
                for r in done if r.finished_at and len(r.tokens) > 1]
        return {
            "completed": len(done),
            "generated_tokens": sum(len(r.tokens) for r in done),
            "pages_available": self.pool.available,
            "decode_steps": self.decode_steps,
            # TTFT includes queueing behind a full batch
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "mean_tpot_s": float(np.mean(tpot)) if tpot else 0.0,
        }

    # -- internals -----------------------------------------------------------

    def _admit(self):
        for slot in range(self.B):
            if self.slot_req[slot] is not None:
                continue
            # keep trying the queue for THIS slot: a rejected (oversized)
            # request must not waste the slot for a whole round
            while True:
                if len(self.queue) == 0:
                    return
                rid = self.queue.pop()
                req = self.requests[rid]
                if req.done:  # cancelled while queued
                    continue
                t = len(req.prompt)
                total_pages = -(-(t + req.max_new) // self.page_size)
                first_page = 0
                if self.cfg.attention_window is not None:
                    # pages wholly below the first decode position's window
                    # are never read: decode starts at t, attends > t-window
                    first_page = max(
                        0, (t - self.cfg.attention_window) // self.page_size)
                need = total_pages - first_page
                if total_pages > self.max_pages or need > self.pool.n_pages:
                    # can never fit: reject now rather than requeue forever
                    req.done = True
                    continue
                pages = self.pool.alloc(need)
                if pages is None:
                    self.queue.push(rid)  # no memory NOW: retry next round
                    return
                break
            self.slot_req[slot] = rid
            # table-index aligned: trash placeholders for the below-window
            # pages a windowed config never allocates
            self.slot_pages[slot] = [self.trash_page] * first_page + pages
            self.slot_temp[slot] = (
                self.temperature if req.temperature is None else req.temperature)
            self.slot_top_p[slot] = self.top_p if req.top_p is None else req.top_p
            self.slot_top_k[slot] = req.top_k
            self.slot_min_p[slot] = req.min_p
            self.page_tables[slot] = self.trash_page
            self.page_tables[slot, first_page : first_page + len(pages)] = pages
            first = self._prefill(slot, req, first_page * self.page_size)
            self._finish_admission(slot, req, first)

    def _finish_admission(self, slot: int, req: Request, first: int):
        """Activate the slot for decode and record the first token."""
        self.positions[slot] = len(req.prompt)
        self.last_tokens[slot] = first
        req.tokens.append(int(first))
        req.first_token_at = time.perf_counter()
        if self._finished(req, first):
            self._release(slot)

    def _prefill(self, slot: int, req: Request, skip_len: int) -> int:
        """Prefill the prompt, padded to a page multiple (the JAX engine
        pads so prefill compiles once per length bucket; kept so both
        engines compute the same shapes), then scatter its KV into the
        slot's pages from skip_len on (sliding windows never allocate the
        pages below it) and sample the first token."""
        t = len(req.prompt)
        stp = -(-t // self.page_size) * self.page_size
        padded = np.zeros((1, stp), np.int64)
        padded[0, :t] = req.prompt
        tokens = torch.from_numpy(padded).to(self.device)
        cache = init_kv_cache(self.cfg, 1, stp, self.device)
        logits, cache = forward_with_cache(self.params, tokens, cache, 0,
                                           self.cfg)
        self._prefill_scatter(slot, t, cache, skip_len)
        return self._sample_first(req, logits[:, t - 1])

    def _prefill_scatter(self, slot: int, t: int, cache, skip_len: int):
        """Write prompt positions [skip_len, t) of the dense cache into the
        slot's pages, one indexed write per layer.  The padded tail past t
        is not written."""
        ps = self.page_size
        lo = (skip_len // ps) * ps
        if lo >= t:
            return
        table = torch.as_tensor(self.slot_pages[slot], device=self.device)
        slots = torch.arange(lo, t, device=self.device)
        page_ids, offs = table[slots // ps], slots % ps
        for li, lc in enumerate(cache):
            k = lc["k"][0, :, lo:t].transpose(0, 1).reshape(t - lo, -1)
            v = lc["v"][0, :, lo:t].transpose(0, 1).reshape(t - lo, -1)
            self.pools[li, page_ids, offs] = torch.cat([k, v], dim=-1).to(
                self.pools.dtype)

    def _sample_first(self, req: Request, raw) -> int:
        """Sample the request's first token from its last-prompt logits."""
        if (req.temperature is not None or req.top_p is not None
                or req.top_k or req.min_p):
            def one(v, d, dt=torch.float32):
                return torch.tensor([d if v is None else v], dtype=dt,
                                    device=self.device)
            first = sample_tokens_per_slot(
                raw, self._gen, one(req.temperature, self.temperature),
                one(req.top_p, self.top_p), one(req.top_k, 0, torch.int32),
                one(req.min_p, 0.0))
        else:
            first = sample_tokens(raw, self._gen, self.temperature, self.top_p)
        req.logprobs.append(float(token_logprobs(raw, first)[0]))
        return int(first[0])

    def _step(self):
        dev = self.device
        sampling = None
        if self._per_slot_sampling:
            sampling = {
                "temperature": torch.from_numpy(self.slot_temp).to(dev),
                "top_p": torch.from_numpy(self.slot_top_p).to(dev),
                "top_k": torch.from_numpy(self.slot_top_k).to(dev),
                "min_p": torch.from_numpy(self.slot_min_p).to(dev),
            }
        burst = self._burst_steps()
        args = (self.params, self.pools,
                torch.from_numpy(self.page_tables).to(dev),
                torch.from_numpy(self.positions).to(dev),
                torch.from_numpy(self.last_tokens).to(dev), self._gen,
                self.cfg, self.page_size)
        if burst > 1:
            tokens, lps = paged_decode_burst(
                *args, burst, self.temperature, self.top_p, sampling)
        else:
            tokens, lps = paged_decode_step(
                *args, self.temperature, self.top_p, sampling)
            tokens, lps = tokens[None], lps[None]  # (1, B)
        self.decode_steps += burst
        tokens = tokens.cpu().numpy()  # (steps, B)
        lps = lps.cpu().numpy()
        for slot in range(self.B):
            rid = self.slot_req[slot]
            if rid is None:
                continue
            req = self.requests[rid]
            for i in range(tokens.shape[0]):
                tok = int(tokens[i, slot])
                req.tokens.append(tok)
                req.logprobs.append(float(lps[i, slot]))
                self.positions[slot] += 1
                self.last_tokens[slot] = tok
                if self.cfg.attention_window is not None:
                    self._free_behind_window(slot)
                if self._finished(req, tok):
                    # the burst's tail past the finish is discarded
                    self._release(slot)
                    break

    def _burst_steps(self) -> int:
        """`decode_burst` when every active slot has at least that many
        tokens left (no wasted tail work), else 1."""
        k = self.decode_burst
        if k <= 1:
            return 1
        for slot in range(self.B):
            rid = self.slot_req[slot]
            if rid is not None:
                req = self.requests[rid]
                if req.max_new - len(req.tokens) < k:
                    return 1
        return k

    def _free_behind_window(self, slot: int):
        """Sliding window: pages whose every slot fell below the window are
        recycled now, bounding a sequence's footprint at
        ceil(window/page)+1 pages whatever its length."""
        w = self.cfg.attention_window
        pos = int(self.positions[slot])
        ps = self.page_size
        pages = self.slot_pages[slot]
        pi = self.slot_watermark[slot]
        # page pi is dead when its last slot < pos - w + 1
        while (pi + 1) * ps <= pos - w + 1 and pi < len(pages):
            if pages[pi] != self.trash_page:
                self.pool.free([pages[pi]])
                pages[pi] = self.trash_page
                self.page_tables[slot, pi] = self.trash_page
            pi += 1
        self.slot_watermark[slot] = pi

    def _finished(self, req: Request, tok: int) -> bool:
        if len(req.tokens) >= req.max_new:
            return True
        eos = self.eos if req.eos is None else req.eos
        if eos is not None and tok == eos:
            return True
        for s in req.stop:
            if len(req.tokens) >= len(s) and tuple(req.tokens[-len(s):]) == s:
                return True
        return False

    def _release(self, slot: int):
        req = self.requests[self.slot_req[slot]]
        req.done = True
        req.finished_at = time.perf_counter()
        # windowed slots hold trash markers for never-allocated pages
        self.pool.free([p for p in self.slot_pages[slot]
                        if p != self.trash_page])
        self.slot_watermark[slot] = 0
        self.slot_req[slot] = None
        self.slot_pages[slot] = []
        self.page_tables[slot] = self.trash_page
