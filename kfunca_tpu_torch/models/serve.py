"""Serving engine: paged KV cache, batched decode, sampling, scheduler.

Counterpart of kfunca_tpu/models/serve.py, single-device path:

  * Paged KV cache, layer-stacked.  Fused layout (the default where
    kv_heads*head_dim is a multiple of 128): ONE pool of page rows
    (n_layers, n_pages, page_size, 2*Hkv*hd) = [k heads | v heads].  Split
    layout (fused_pool=False, or unaligned heads): two pools
    (n_layers, n_pages, page_size, Hkv, hd).  quantize_kv stores int8
    vectors with one fp32 scale per (slot, kv head): the fused pool pairs
    with a slot-major (n_layers, n_pages, page_size, 128) scale pool whose
    rows begin [sk heads | sv heads], each split pool with an
    (n_layers, n_pages, page_size, Hkv) scale pool; scale pools start at
    ones.  Pages come from a free-list allocator; a sequence owns a page
    table of max_pages_per_seq entries.  The JAX engine updates its donated
    pool buffers in place; the port writes into the pool tensors in place.
  * Batched decode step: embed the B last tokens; per layer, scatter the
    new K/V into the pool, attend through the paged decode kernels
    (ops/pallas_kernels/paged_attention.py: the hand-written CUDA kernel on
    the card, its plain version on the CPU; `paged_decode_attention_dma`
    for the fused pool, `paged_decode_attention` for split pools), run the
    MLP; then sample.  `paged_decode_burst` runs `steps` decode steps per
    scheduler call (a Python loop in place of lax.scan).
  * Weight-quantized decode (quantize_weights): block matrices and the LM
    head become (int8, column scales) pairs, w8a8 through the int8 matmul
    kernel (ops/quant.py), or (packed int4, group scales) pairs, w4a8.
    Prefill keeps the fp params.
  * Prefix caching (prefix_cache): full prompt pages are content-hashed
    (chained per-page hash) and shared read-only between sequences;
    admission reuses the longest cached page prefix and prefills only the
    suffix.  Pages are refcounted; cache-only pages evict LRU under pool
    pressure.
  * Sampling: greedy, temperature, nucleus (top-p), top-k and min-p, per
    request; log-probs under the raw distribution.  torch.Generator and
    jax.random draw different numbers, so sampled output matches the JAX
    engine in distribution only; greedy output matches token for token.
  * Continuous batching over fixed decode slots with a FIFO queue; sliding
    window models free the pages that fall behind the window.

Prefill is models/generate.forward_with_cache (plain attention) over the
prompt suffix padded to a page multiple, scattered into the slot's pages.

Later slices of the port (each raises NotImplementedError here):
multi-LoRA, mesh (tensor-parallel) serving, chunked prefill, logit
penalties and constrained decoding.
"""

from __future__ import annotations

import math
import time
import hashlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.pallas_kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_dma,
)
from ..ops.quant import (
    gemm_w4, gemm_w8, quantize_cols, quantize_cols_int4, quantize_vecs,
)
from ..runtime.backend import resolve_device
from .generate import _rope_at, forward_with_cache, init_kv_cache
from .transformer import (
    TransformerConfig, _plain_mm, apply_norm, apply_qk_norm, embed_tokens,
    mlp, split_qkv,
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


class PrefixIndex:
    """LRU-ordered prefix-cache index: chained prompt-page content hash ->
    KV page id (the JAX package's Python fallback: a dict in insertion
    order, oldest first).

    Keys are 20-byte sha1 digests that commit to the whole token prefix
    [0, (i+1)*page_size) and the seed (the adapter id)."""

    def __init__(self):
        self._d: dict = {}

    def hash_chain(self, prompt, page_size: int, seed: int) -> list:
        """One chained content hash per FULL page of `prompt` under `seed`."""
        hashes, h = [], np.int32(seed).tobytes()
        for i in range(len(prompt) // page_size):
            h = hashlib.sha1(
                h + np.asarray(prompt[i * page_size:(i + 1) * page_size],
                               np.int32).tobytes()).digest()
            hashes.append(h)
        return hashes

    def get(self, key):
        """Mapped page id, or None (does NOT touch LRU order)."""
        return self._d.get(key)

    def touch(self, key) -> None:
        """Move an entry to most-recently-used."""
        if key in self._d:
            self._d[key] = self._d.pop(key)

    def put(self, key, page: int) -> bool:
        """Insert at MRU; False (and no change) if the key already exists."""
        if key in self._d:
            return False
        self._d[key] = page
        return True

    def erase(self, key):
        """Remove; returns the page that was mapped, or None."""
        return self._d.pop(key, None)

    def lru_items(self) -> list:
        """(key, page) snapshot in LRU order, oldest first."""
        return list(self._d.items())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return self.get(key) is not None


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


def _mm(y, w):
    """Decode-path matmul: fp weight, or a quantized pair from
    quantize_decode_params: (int8, (n,) column scales) runs w8a8 (gemm_w8),
    (packed int4 uint8, (g, n) group scales) runs w4a8 (gemm_w4).  Both
    quantize the activations per row from fp32 and return fp32."""
    if isinstance(w, tuple):
        y2 = y.reshape(-1, y.shape[-1]).float()
        gemm = gemm_w4 if w[0].dtype == torch.uint8 else gemm_w8
        out = gemm(y2, w[0], w[1], out_dtype=torch.float32)
        return out.reshape(*y.shape[:-1], w[1].shape[-1])
    return _plain_mm(y, w)


def _w4_group(k: int) -> int:
    """Largest power-of-two group <= 128 dividing k (group-wise int4
    scales must tile the contraction dim exactly)."""
    for g in (128, 64, 32, 16, 8, 4, 2):
        if k % g == 0:
            return g
    return k


_QUANTIZED = ("wqkv", "wo", "w_gate", "w_up", "w_down", "w_fc", "w_proj")


def quantize_decode_params(params, bits: int = 8):
    """Symmetric quantization of every decode-path matrix: block weights
    become (intN, scale) pairs and the LM head (the tied embedding's
    transpose where there is no "lm_head") is materialized quantized as
    "lm_head"; the paged decode step dispatches on the pair structure
    (_mm).  The embedding gather, norm gains and biases stay as they are.
    Returns a NEW params dict for the decode step; keep the fp params for
    prefill.

    bits=8: per-output-column int8 (w8a8).  bits=4: group-wise int4
    (ops/quant.quantize_cols_int4, packed two values a byte; scales per
    (k-group, column))."""
    if bits == 8:
        quant = quantize_cols
    elif bits == 4:
        def quant(w):
            return quantize_cols_int4(w, group=_w4_group(w.shape[0]))
    else:
        raise ValueError(f"unsupported weight bits {bits} (8 or 4)")
    out = dict(params)
    out["blocks"] = [{k: quant(v) if k in _QUANTIZED else v
                      for k, v in blk.items()} for blk in params["blocks"]]
    head = params.get("lm_head")
    out["lm_head"] = quant(params["embed"].T if head is None else head)
    return out


def _flat(pool):
    """(L, n_pages, ...) layer-stacked pool -> the (L*n_pages, ...) view
    that the kernels index with page_base = layer * n_pages."""
    return pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])


def _paged_block(x, p, pools_k, pools_v, li, page_tables, positions,
                 cfg: TransformerConfig, page_size: int):
    """One transformer block over B single tokens against the paged KV.

    x: (B, 1, dm).  pools_k/pools_v: the layer-stacked pools, written in
    place at [li, page, offset].  Fused layout (pools_v is None): pools_k
    is ONE (L, n_pages, page, 2*Hkv*hd) stack of [k | v] page rows, or with
    int8 KV the pair (int8 stack, fp32 (L, n_pages, page, 128) scale rows
    [sk heads | sv heads | 0]).  Split layout: pools_k and pools_v are
    (L, n_pages, page, Hkv, hd) stacks, or with int8 KV pairs (int8 stack,
    fp32 (L, n_pages, page, Hkv) scales).  page_tables: (B, max_pages)
    int32; positions: (B,) int32 (index of the new token).  Returns x."""
    b = x.shape[0]
    h, hd, hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    max_pages = page_tables.shape[1]

    y = apply_norm(x, p, "attn_norm", cfg)
    qkv = _mm(y, p["wqkv"])
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
    # all write the same offset of the trash page (data and scales, two
    # writes that may pick different winners); which write wins is
    # irrelevant, as nothing reads that page.
    page_idx = torch.clamp(positions // page_size, max=max_pages - 1)
    page_slot = page_tables[torch.arange(b, device=x.device), page_idx].long()
    offset = (positions % page_size).long()
    kv_quant = isinstance(pools_k, tuple)  # int8 KV: (pool_q8, scales) pairs
    fused = pools_v is None
    knew, vnew = k[:, :, 0], v[:, :, 0]  # (B, Hkv, hd)
    if kv_quant:
        knew, sk_new = quantize_vecs(knew)  # (B, Hkv, hd) int8, (B, Hkv)
        vnew, sv_new = quantize_vecs(vnew)
    if fused:
        data = pools_k[0] if kv_quant else pools_k
        data[li, page_slot, offset] = torch.cat(
            [knew.reshape(b, -1), vnew.reshape(b, -1)], dim=-1).to(data.dtype)
        if kv_quant:  # one slot-major scale row per token, lanes past 2*Hkv 0
            pools_k[1][li, page_slot, offset] = torch.nn.functional.pad(
                torch.cat([sk_new, sv_new], dim=-1), (0, 128 - 2 * hkv))
    elif kv_quant:
        pools_k[0][li, page_slot, offset] = knew
        pools_k[1][li, page_slot, offset] = sk_new
        pools_v[0][li, page_slot, offset] = vnew
        pools_v[1][li, page_slot, offset] = sv_new
    else:
        pools_k[li, page_slot, offset] = knew.to(pools_k.dtype)
        pools_v[li, page_slot, offset] = vnew.to(pools_v.dtype)

    # The kernels read layer li's pages straight from the stacked pools
    # through a flattened view and page_base: no pools[li] slice copy.
    n_pages = (pools_k[0] if kv_quant else pools_k).shape[1]
    qs = (q[:, :, 0] * torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)
          ).contiguous()
    kw = dict(window=cfg.attention_window, page_base=li * n_pages)
    if fused and kv_quant:
        attn = paged_decode_attention_dma(
            qs, _flat(pools_k[0]), page_tables, positions,
            scales=_flat(pools_k[1]), **kw)
    elif fused:
        attn = paged_decode_attention_dma(
            qs, _flat(pools_k), page_tables, positions, **kw)
    elif kv_quant:
        attn = paged_decode_attention(
            qs, _flat(pools_k[0]), _flat(pools_v[0]), page_tables, positions,
            scales=(_flat(pools_k[1]), _flat(pools_v[1])), **kw)
    else:
        attn = paged_decode_attention(
            qs, _flat(pools_k), _flat(pools_v), page_tables, positions, **kw)
    attn = attn.to(x.dtype).reshape(b, 1, h * hd)
    o = _mm(attn, p["wo"])
    if "bo" in p:
        o = o + p["bo"].float()
    if cfg.parallel_residual:  # GPT-NeoX/GPT-J: branches share the input
        y = apply_norm(x, p, "mlp_norm", cfg)
        return x + o.to(x.dtype) + mlp(y, p, cfg, mm=_mm).to(x.dtype)
    x = x + o.to(x.dtype)
    y = apply_norm(x, p, "mlp_norm", cfg)
    return x + mlp(y, p, cfg, mm=_mm).to(x.dtype)


def paged_decode_step(params, pools_k, pools_v, page_tables, positions,
                      last_tokens, generator, cfg: TransformerConfig,
                      page_size: int, temperature=0.0, top_p=1.0,
                      sampling=None):
    """One batched decode step over the paged KV (the JAX package's
    _decode_step_impl and its jitted paged_decode_step).

    `sampling`, when given, is a dict of (B,) tensors {temperature, top_p,
    top_k, min_p} for per-slot sampling; it overrides temperature/top_p.
    pools_k/pools_v: the pools in any of _paged_block's four forms
    (pools_v None = fused), each slot's new K/V written in place.  `params`
    may hold quantized (intN, scale) pairs (quantize_decode_params).  Returns
    (tokens (B,) int32, logprobs (B,) fp32); idle slots decode garbage
    that callers ignore."""
    x = embed_tokens(params, last_tokens.long()[:, None], cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][positions.long()][:, None].to(cfg.act_dtype)
    for li, p in enumerate(params["blocks"]):
        x = _paged_block(x, p, pools_k, pools_v, li, page_tables, positions,
                         cfg, page_size)
    x = apply_norm(x, params, "final_norm", cfg)
    # the untied head, the quantized (intN, scale) head, or the tied
    # embedding's transpose: _mm dispatches on the structure
    logits = _mm(x[:, 0], params["lm_head"] if "lm_head" in params
                 else params["embed"].T)
    if sampling is not None:
        tokens = sample_tokens_per_slot(
            logits, generator, sampling["temperature"], sampling["top_p"],
            sampling["top_k"], sampling["min_p"])
    else:
        tokens = sample_tokens(logits, generator, temperature, top_p)
    return tokens, token_logprobs(logits, tokens)


def paged_decode_burst(params, pools_k, pools_v, page_tables, positions,
                       last_tokens, generator, cfg: TransformerConfig,
                       page_size: int, steps: int, temperature=0.0, top_p=1.0,
                       sampling=None):
    """`steps` decode steps in one call (the scheduler does its
    bookkeeping after the burst and discards each slot's tail past its
    finish; pages for max_new are reserved at admission, so decoding past
    a finish writes only into pages the slot owns).  Returns
    (tokens (steps, B), logprobs (steps, B))."""
    toks, lps = [], []
    for _ in range(steps):
        last_tokens, lp = paged_decode_step(
            params, pools_k, pools_v, page_tables, positions, last_tokens,
            generator, cfg, page_size, temperature, top_p, sampling)
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
    device="cpu").  `params` must already be on that device.

    quantize_weights: True or "int8" decodes w8a8, "int4" w4a8 (prefill
    keeps the fp params, so both copies are resident).  quantize_kv stores
    the KV cache as int8 with per-(slot, kv head) scales.  fused_pool: None
    picks the fused [k|v] pool where kv_heads*head_dim is a multiple of 128
    (and 2*kv_heads <= 128), else split pools; False forces split pools.
    prefix_cache shares full prompt pages between sequences (not with a
    sliding window)."""

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
        quantize_weights: bool | str = False,
        quantize_kv: bool = False,
        mesh=None,
        prefill_chunk: int | None = None,
        decode_burst: int = 1,
        fused_pool: bool | None = None,
        device=None,
    ):
        if cfg.attention_window is not None and prefix_cache:
            raise NotImplementedError(
                "prefix caching with sliding windows is not supported (a "
                "window invalidates shared-prefix reuse beyond the window)")
        if cfg.attention == "mla":
            raise NotImplementedError(
                "this engine's page pools hold per-head K/V; MLA serving is a "
                "later slice of the port")
        for on, what in ((max_loras, "multi-LoRA serving"),
                         (mesh is not None, "mesh (tensor-parallel) serving"),
                         (prefill_chunk is not None, "chunked prefill")):
            if on:
                raise _later(what)
        hkv, hd = cfg.kv_heads, cfg.head_dim
        aligned = (hkv * hd) % 128 == 0 and 2 * hkv <= 128
        if fused_pool is None:  # auto; an explicit False is for layout tests
            fused_pool = aligned
        elif fused_pool and not aligned:
            raise ValueError(
                "fused pools need k|v halves that are multiples of 128 "
                f"(kv_heads*head_dim = {hkv * hd}) and scale rows that fit "
                f"128 lanes (2*kv_heads = {2 * hkv})")
        if decode_burst < 1:
            raise ValueError(f"decode_burst must be >= 1, got {decode_burst}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.act_dtype not in (
                torch.float32, torch.bfloat16):
            raise _later(f"serving {cfg.dtype} pools on the card (the paged "
                         "decode kernels take float32 and bfloat16)")
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"server on {self.device}")
        self.params = params
        if quantize_weights:
            bits = {True: 8, "int8": 8, "int4": 4}.get(quantize_weights)
            if bits is None:
                raise ValueError(f"quantize_weights: expected bool, 'int8' "
                                 f"or 'int4', got {quantize_weights!r}")
            self._decode_params = quantize_decode_params(params, bits=bits)
        else:
            self._decode_params = params
        self.cfg = cfg
        self.B = batch_slots
        self.page_size = page_size
        self.max_pages = max_pages_per_seq
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.eos = eos_token
        self.decode_burst = int(decode_burst)
        self.prefix_cache = bool(prefix_cache)
        self._page_refs: dict[int, int] = {}
        self._pcache = PrefixIndex()  # chained page hash -> page id (LRU)
        self.prefix_hit_pages = 0
        self.prefix_fresh_pages = 0
        self.requests: dict[int, Request] = {}
        self._next_id = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # page n_pages-1 is the TRASH page: never allocated; idle slots
        # point their whole page table at it so their (harmless) decode
        # writes cannot corrupt pages owned by live sequences
        self.trash_page = n_pages - 1
        self.pool = PagePool(n_pages - 1)
        self.queue = RequestQueue()
        self.quantize_kv = bool(quantize_kv)
        self.fused_pool = bool(fused_pool)
        dev = self.device
        lead = (cfg.n_layers, n_pages, page_size)

        def pool_of(*tail):  # a data pool, with its scale pool when int8
            if not quantize_kv:
                return torch.zeros(lead + tail, dtype=cfg.act_dtype, device=dev)
            lanes = (128,) if self.fused_pool else (hkv,)
            return (torch.zeros(lead + tail, dtype=torch.int8, device=dev),
                    torch.ones(lead + lanes, dtype=torch.float32, device=dev))

        if self.fused_pool:
            self.pools_k, self.pools_v = pool_of(2 * hkv * hd), None
        else:
            self.pools_k, self.pools_v = pool_of(hkv, hd), pool_of(hkv, hd)
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
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefix_fresh_pages": self.prefix_fresh_pages,
            "cached_pages": len(self._pcache),
            "decode_steps": self.decode_steps,
            # TTFT includes queueing behind a full batch
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "mean_tpot_s": float(np.mean(tpot)) if tpot else 0.0,
        }

    # -- internals -----------------------------------------------------------

    def pool_bytes(self) -> int:
        """Bytes of device memory the KV pools hold (data and scales)."""
        total = 0
        for pool in (self.pools_k, self.pools_v):
            for t in (pool if isinstance(pool, tuple) else (pool,)):
                if t is not None:
                    total += t.numel() * t.element_size()
        return total

    def _incref(self, page: int) -> None:
        self._page_refs[page] = self._page_refs.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        r = self._page_refs.get(page, 0) - 1
        if r <= 0:
            self._page_refs.pop(page, None)
            self.pool.free([page])
        else:
            self._page_refs[page] = r

    def _prefix_hashes(self, prompt: np.ndarray) -> list:
        """Chained content hash per FULL prompt page: page i's key commits
        to the entire token prefix [0, (i+1)*page_size) and the adapter id
        (always 0 until multi-LoRA serving is ported)."""
        return self._pcache.hash_chain(prompt, self.page_size, 0)

    def _evict_one(self) -> bool:
        """Drop the least-recently-used cache entry no sequence is using."""
        for h, page in self._pcache.lru_items():
            if self._page_refs.get(page, 0) == 1:  # cache holds the only ref
                self._pcache.erase(h)
                self._decref(page)
                return True
        return False

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
                reused = []  # (hash key, page) pairs
                hashes: list = []
                if self.prefix_cache:
                    hashes = self._prefix_hashes(req.prompt)
                    # never reuse the page holding the LAST prompt token:
                    # its logits seed sampling, so it must be prefilled
                    for h in hashes[: (t - 1) // self.page_size]:
                        page = self._pcache.get(h)
                        if page is None:
                            break
                        reused.append((h, page))
                # Pin the reused pages BEFORE evicting for room.  The JAX
                # engine takes its references after the allocation, so
                # under pool pressure it can evict a page it is about to
                # reuse and hand the same page out again as a fresh one,
                # whose prefill then overwrites the shared prefix.
                for _, page in reused:
                    self._incref(page)
                while True:
                    fresh = self.pool.alloc(need - len(reused))
                    if fresh is not None:
                        break
                    if not (self.prefix_cache and self._evict_one()):
                        break
                if fresh is None:
                    for _, page in reused:
                        self._decref(page)
                    self.queue.push(rid)  # no memory NOW: retry next round
                    return
                for h, _ in reused:
                    self._pcache.touch(h)  # LRU: move to most-recently-used
                for page in fresh:
                    self._incref(page)
                pages = [page for _, page in reused] + fresh
                self.prefix_hit_pages += len(reused)
                self.prefix_fresh_pages += len(fresh)
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
            first = self._prefill(slot, req, len(reused) * self.page_size,
                                  first_page * self.page_size)
            self._finish_admission(slot, req, first, hashes, len(reused),
                                   pages)

    def _finish_admission(self, slot: int, req: Request, first: int,
                          hashes: list, reused_n: int, pages: list):
        """Publish the prompt's full pages to the prefix cache, activate
        the slot for decode and record the first token."""
        t = len(req.prompt)
        if self.prefix_cache:
            # pure prompt KV: decode writes start at position t, beyond
            # every full page
            for i in range(reused_n, t // self.page_size):
                if self._pcache.put(hashes[i], pages[i]):
                    self._incref(pages[i])
        self.positions[slot] = t
        self.last_tokens[slot] = first
        req.tokens.append(int(first))
        req.first_token_at = time.perf_counter()
        if self._finished(req, first):
            self._release(slot)

    def _prefill(self, slot: int, req: Request, prefix_len: int,
                 skip_len: int) -> int:
        """Prefill the prompt SUFFIX beyond the reused prefix, padded to a
        page multiple (the JAX engine pads so prefill compiles once per
        length bucket; kept so both engines compute the same shapes), then
        scatter its KV into the slot's fresh pages and sample the first
        token.  With prefix_len > 0 the reused pages' KV is gathered from
        the pool into the dense cache first, so the suffix attends the full
        context while the forward runs over the suffix tokens only.
        skip_len (sliding windows) marks the region whose pages were never
        allocated: nothing is scattered there."""
        t = len(req.prompt)
        st = t - prefix_len
        stp = -(-st // self.page_size) * self.page_size
        tokens, cache = self._prefill_cache_init(slot, req, prefix_len, stp)
        logits, cache = forward_with_cache(self.params, tokens, cache,
                                           prefix_len, self.cfg)
        self._prefill_scatter(slot, t, cache, max(prefix_len, skip_len))
        return self._sample_first(req, logits[:, st - 1])

    def _prefill_cache_init(self, slot: int, req: Request, prefix_len: int,
                            stp: int):
        """Padded suffix tokens and a dense KV cache seeded with the reused
        prefix pages' KV, gathered from the pool (dequantized if int8)."""
        cfg = self.cfg
        st = len(req.prompt) - prefix_len
        padded = np.zeros((1, stp), np.int64)
        padded[0, :st] = req.prompt[prefix_len:]
        tokens = torch.from_numpy(padded).to(self.device)
        cache = init_kv_cache(cfg, 1, prefix_len + stp, self.device)
        if not prefix_len:
            return tokens, cache
        hkv, hd = cfg.kv_heads, cfg.head_dim
        pre = torch.as_tensor(
            self.slot_pages[slot][:prefix_len // self.page_size],
            device=self.device)

        def read(pool, li, lanes=slice(None)):
            """(prefix_len, heads, hd) of one pool's reused pages."""
            if not self.quantize_kv:
                return pool[li, pre].reshape(prefix_len, -1, hd)
            x = pool[0][li, pre].reshape(prefix_len, -1, hd).float()
            sc = pool[1][li, pre].reshape(prefix_len, -1)[:, lanes]
            return (x * sc[..., None]).to(cfg.act_dtype)

        for li, lc in enumerate(cache):
            if self.fused_pool:
                kv = read(self.pools_k, li, slice(0, 2 * hkv))
                k, v = kv[:, :hkv], kv[:, hkv:]
            else:
                k, v = read(self.pools_k, li), read(self.pools_v, li)
            lc["k"][0, :, :prefix_len] = k.transpose(0, 1)
            lc["v"][0, :, :prefix_len] = v.transpose(0, 1)
        return tokens, cache

    def _prefill_scatter(self, slot: int, t: int, cache, start: int):
        """Write prompt positions [start rounded down to a page, t) of the
        dense cache (indexed by absolute position) into the slot's pages,
        one indexed write per layer and pool.  The padded tail past t is
        not written."""
        ps = self.page_size
        lo = (start // ps) * ps
        if lo >= t:
            return
        hkv = self.cfg.kv_heads
        table = torch.as_tensor(self.slot_pages[slot], device=self.device)
        slots = torch.arange(lo, t, device=self.device)
        page_ids, offs = table[slots // ps], slots % ps

        def write(pool, li, x, sc=None):
            if self.quantize_kv:
                pool[0][li, page_ids, offs] = x
                pool[1][li, page_ids, offs] = sc
            else:
                pool[li, page_ids, offs] = x.to(pool.dtype)

        for li, lc in enumerate(cache):
            k = lc["k"][0, :, lo:t].transpose(0, 1)  # (n, Hkv, hd)
            v = lc["v"][0, :, lo:t].transpose(0, 1)
            sk = sv = None
            if self.quantize_kv:
                k, sk = quantize_vecs(k)  # (n, Hkv, hd) int8, (n, Hkv)
                v, sv = quantize_vecs(v)
            if not self.fused_pool:
                write(self.pools_k, li, k, sk)
                write(self.pools_v, li, v, sv)
                continue
            sc = None
            if self.quantize_kv:
                sc = torch.nn.functional.pad(torch.cat([sk, sv], dim=-1),
                                             (0, 128 - 2 * hkv))
            write(self.pools_k, li,
                  torch.cat([k.reshape(t - lo, -1), v.reshape(t - lo, -1)],
                            dim=-1), sc)

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
        args = (self._decode_params, self.pools_k, self.pools_v,
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
                self._decref(pages[pi])
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
        for page in self.slot_pages[slot]:
            if page != self.trash_page:  # windowed slots hold trash markers
                self._decref(page)  # cached pages survive on the cache's ref
        self.slot_watermark[slot] = 0
        self.slot_req[slot] = None
        self.slot_pages[slot] = []
        self.page_tables[slot] = self.trash_page
