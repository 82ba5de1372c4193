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
  * Weight-quantized decode (quantize_weights): block matrices (every
    routed expert's three of a MoE block; its router, router bias and
    shared expert stay fp) and the LM head become (int8, column scales)
    pairs, w8a8 through the int8 matmul kernel (ops/quant.py), or (packed
    int4, group scales) pairs, w4a8.  A MoE block's decode MLP runs each
    expert over the slots routed to it: one K5 launch a product at m =
    those rows.  Prefill keeps the fp params.
  * Prefix caching (prefix_cache): full prompt pages are content-hashed
    (chained per-page hash: the native core's 128-bit chain, or sha1 in
    the Python form) and shared read-only between sequences;
    admission reuses the longest cached page prefix and prefills only the
    suffix.  Pages are refcounted; cache-only pages evict LRU under pool
    pressure.
  * Sampling: greedy, temperature, nucleus (top-p), top-k and min-p, per
    request; log-probs under the raw distribution.  torch.Generator and
    jax.random draw different numbers, so sampled output matches the JAX
    engine in distribution only; greedy output matches token for token.
  * Logit processors, per request: the HF repetition penalty, the OpenAI
    presence and frequency penalties and an additive logit bias over each
    slot's token counts (prompt + generated), kept on the device and
    advanced between the steps of a decode burst; constrained decoding
    through a host callback (allowed_fn) that masks the vocabulary before
    every sample.  Log-probs stay those of the raw distribution.
  * Continuous batching over fixed decode slots with a FIFO queue; sliding
    window models free the pages that fall behind the window.  Chunked
    prefill (prefill_chunk) ingests a long prompt a chunk per scheduler
    iteration while the other slots keep decoding.
  * fp32, bf16 and fp16 activations and pools; on the card each runs the
    paged kernels' body of its dtype.
  * Multi-LoRA (max_loras > 0): stacked per-layer wqkv adapters, fp32,
    lora_A (L, max_loras + 1, d_model, r) and lora_B (L, max_loras + 1, r,
    qkv_out), slot 0 the zero adapter.  register_lora adds one and returns
    its id; submit(lora_id=...) picks it per request.  The decode step
    gathers each slot's A and B and adds (y @ A) @ B in fp32 to the slot's
    qkv product (the base's: fp, w8 or w4) before the head split, so one
    batch mixes adapters; prefill runs over the adapter's merged fp
    weights (W + A @ B, cached per id).  Prefix-cache hashes are keyed by
    the adapter, so two adapters never share a page.

Prefill is models/generate.forward_with_cache (plain attention) over the
prompt suffix padded to a page multiple, scattered into the slot's pages.

Tensor-parallel serving (mesh=): a LocalMesh or a (dp, tp) DeviceMesh.
The decode weights are Megatron-sharded by decode_param_specs (the
embedding replicated, an untied lm_head column-parallel over the
vocabulary); each rank keeps split pools of its own kv heads (all of them
where tp does not divide the kv heads: attention is then replicated), runs
its paged attention on them (K6, int8 under quantize_kv) and a
row-parallel wo / down with one all-reduce each (int8 pairs add their
exact integer sums, so a tp decode step makes one device's int8 products
bit for bit); the logits are gathered over tp before sampling, penalties
and allowed_fn.  The prefill keeps the fp params unsharded, as the JAX
server keeps self.params, and each rank takes its kv heads of the prefill's
cache.  (The JAX server pins the XLA gather engine under a mesh; the port
runs its own kernels on every rank.)

Under a mesh each rank adds its heads' columns of the adapter delta (B
split by whole heads as wqkv is, A replicated).  MLA configs are refused:
they serve through models/mla_serve.MLAServer, as in the JAX package.
Under a mesh, MoE blocks with a shared expert or a router bias are refused
(the JAX decode_param_specs has no spec for them).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import time
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
from ..parallel.mesh import P, ShardedParams, as_mesh, shard_tree
from ..runtime import _native
from ..runtime.backend import resolve_device
from ..utils.tree import tree_leaves
from .generate import _rope_at, forward_with_cache, init_kv_cache
from .transformer import (
    TransformerConfig, _plain_mm, _top_level, apply_norm, apply_qk_norm,
    embed_tokens, local_config, mlp, split_qkv, tp_block, tp_embed, tp_logits,
)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# page allocator, admission queue and prefix index: the native core's
# kf_page_pool_*, kf_queue_* and kf_pcache_* when it is loaded, their Python
# forms otherwise (KFUNCA_NO_NATIVE=1), as in the JAX package
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list allocator over `n_pages` KV pages."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._lib = _native.get_lib()
        if self._lib is not None:
            self._id = self._lib.kf_page_pool_create(n_pages)
        else:
            self._free = list(range(n_pages - 1, -1, -1))

    def alloc(self, count: int) -> list[int] | None:
        """`count` page indices, or None if the pool can't satisfy it."""
        if count == 0:
            return []
        if self._lib is not None:
            out = _native.i64_array([0] * count)
            if self._lib.kf_page_alloc(self._id, count, out) < 0:
                return None
            return list(out)
        if len(self._free) < count:
            return None
        return [self._free.pop() for _ in range(count)]

    def free(self, pages: list[int]) -> None:
        if not pages:
            return
        if self._lib is not None:
            self._lib.kf_page_free(self._id, len(pages),
                                   _native.i64_array(list(pages)))
        else:
            self._free.extend(pages)

    @property
    def available(self) -> int:
        if self._lib is not None:
            return int(self._lib.kf_page_pool_available(self._id))
        return len(self._free)


class RequestQueue:
    """FIFO admission queue."""

    def __init__(self):
        self._lib = _native.get_lib()
        if self._lib is not None:
            self._id = self._lib.kf_queue_create()
        else:
            self._items: deque[int] = deque()

    def push(self, item: int) -> None:
        if self._lib is not None:
            self._lib.kf_queue_push(self._id, item)
        else:
            self._items.append(item)

    def pop(self) -> int | None:
        if self._lib is not None:
            v = int(self._lib.kf_queue_pop(self._id))
            return None if v < 0 else v
        return self._items.popleft() if self._items else None

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.kf_queue_size(self._id))
        return len(self._items)


class PrefixIndex:
    """LRU-ordered prefix-cache index: chained prompt-page content hash ->
    KV page id.

    Keys are opaque: (u64, u64) pairs from the native core's 128-bit
    splitmix chain (kf_pcache_hash_chain), or 20-byte sha1 digests from the
    Python form (a dict in insertion order, oldest first).  Both commit to
    the whole token prefix [0, (i+1)*page_size) and the seed (the adapter
    id)."""

    def __init__(self):
        self._lib = _native.get_lib()
        if self._lib is not None:
            self._id = self._lib.kf_pcache_create()
        else:
            self._d: dict = {}

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.kf_pcache_destroy(self._id)

    def hash_chain(self, prompt, page_size: int, seed: int) -> list:
        """One chained content hash per FULL page of `prompt` under `seed`."""
        n_pages = len(prompt) // page_size
        if n_pages == 0:
            return []
        if self._lib is not None:
            toks = np.ascontiguousarray(prompt, dtype=np.int32)
            out = (ctypes.c_uint64 * (2 * n_pages))()
            self._lib.kf_pcache_hash_chain(
                toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(toks), page_size, seed, out)
            return [(out[2 * i], out[2 * i + 1]) for i in range(n_pages)]
        hashes, h = [], np.int32(seed).tobytes()
        for i in range(n_pages):
            h = hashlib.sha1(
                h + np.asarray(prompt[i * page_size:(i + 1) * page_size],
                               np.int32).tobytes()).digest()
            hashes.append(h)
        return hashes

    def get(self, key):
        """Mapped page id, or None (does NOT touch LRU order)."""
        if self._lib is not None:
            v = int(self._lib.kf_pcache_get(self._id, key[0], key[1]))
            return None if v < 0 else v
        return self._d.get(key)

    def touch(self, key) -> None:
        """Move an entry to most-recently-used."""
        if self._lib is not None:
            self._lib.kf_pcache_touch(self._id, key[0], key[1])
        elif key in self._d:
            self._d[key] = self._d.pop(key)

    def put(self, key, page: int) -> bool:
        """Insert at MRU; False (and no change) if the key already exists."""
        if self._lib is not None:
            return int(self._lib.kf_pcache_put(self._id, key[0], key[1],
                                               page)) == 1
        if key in self._d:
            return False
        self._d[key] = page
        return True

    def erase(self, key):
        """Remove; returns the page that was mapped, or None."""
        if self._lib is not None:
            v = int(self._lib.kf_pcache_erase(self._id, key[0], key[1]))
            return None if v < 0 else v
        return self._d.pop(key, None)

    def lru_items(self) -> list:
        """(key, page) snapshot in LRU order, oldest first."""
        if self._lib is not None:
            n = int(self._lib.kf_pcache_size(self._id))
            if n <= 0:
                return []
            ab = (ctypes.c_uint64 * (2 * n))()
            pages = _native.i64_array([0] * n)
            n = int(self._lib.kf_pcache_lru(self._id, ab, pages, n))
            return [((ab[2 * i], ab[2 * i + 1]), int(pages[i]))
                    for i in range(n)]
        return list(self._d.items())

    def __len__(self) -> int:
        if self._lib is not None:
            return max(0, int(self._lib.kf_pcache_size(self._id)))
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


def _mm(y, w, row_absmax=None):
    """Decode-path matmul: fp weight, or a quantized pair from
    quantize_decode_params: (int8, (n,) column scales) runs w8a8 (gemm_w8),
    (packed int4 uint8, (g, n) group scales) runs w4a8 (gemm_w4).  Both
    quantize the activations per row from fp32 (by `row_absmax`, y's shape
    less its last axis, when given) and return fp32."""
    if isinstance(w, tuple):
        y2 = y.reshape(-1, y.shape[-1]).float()
        amax = None if row_absmax is None else row_absmax.reshape(-1)
        gemm = gemm_w4 if w[0].dtype == torch.uint8 else gemm_w8
        out = gemm(y2, w[0], w[1], out_dtype=torch.float32, row_absmax=amax)
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
    (every routed expert's three matrices too) become (intN, scale) pairs;
    a MoE block's router, router_bias and shared expert stay as they are,
    as in the JAX function; and the LM head (the tied embedding's
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
    def qblk(blk):
        out = {k: quant(v) if k in _QUANTIZED else v for k, v in blk.items()}
        if "experts" in blk:
            out["experts"] = [{n: quant(w) for n, w in ex.items()}
                              for ex in blk["experts"]]
        return out

    out = dict(params)
    out["blocks"] = [qblk(blk) for blk in params["blocks"]]
    head = params.get("lm_head")
    out["lm_head"] = quant(params["embed"].T if head is None else head)
    return out


def decode_param_specs(params):
    """Megatron-style TP specs for the decode params tree (the JAX
    function, kfunca_tpu/models/serve.py:717-780): qkv/gate/up
    column-parallel, wo/down row-parallel, norms and the embedding
    replicated, an lm_head column-parallel.  A quantized (intN, scale) pair
    shards its scale with the matrix's output dim: column-parallel int8
    scales over tp, row-parallel ones replicated; int4 group scales
    (k/g, n) follow the matrix on both axes."""

    def col(v):
        if isinstance(v, tuple):
            return (P(None, "tp"), P("tp") if v[1].ndim == 1 else P(None, "tp"))
        return P(None, "tp")

    def row(v):
        if isinstance(v, tuple):
            return (P("tp", None), P() if v[1].ndim == 1 else P("tp", None))
        return P("tp", None)

    def blk_spec(blk):
        gap = [k for k in ("shared", "router_bias") if k in blk]
        if gap:
            # the JAX function names neither, and its server's walk over
            # these specs fails on them (a KeyError): not served over a mesh
            raise NotImplementedError(
                f"tensor-parallel serving of MoE blocks with {gap} (DeepSeek "
                f"routing): the JAX decode_param_specs has no spec for them")
        s = {"attn_norm": P(), "mlp_norm": P(),
             "wqkv": col(blk["wqkv"]), "wo": row(blk["wo"])}
        if "experts" in blk:
            s["router"] = P()
            s["experts"] = [
                {"w_gate": col(ex["w_gate"]), "w_up": col(ex["w_up"]),
                 "w_down": row(ex["w_down"])} for ex in blk["experts"]]
        elif "w_fc" in blk:
            s["w_fc"] = col(blk["w_fc"])
            s["w_proj"] = row(blk["w_proj"])
        else:
            s["w_gate"] = col(blk["w_gate"])
            s["w_up"] = col(blk["w_up"])
            s["w_down"] = row(blk["w_down"])
        if "bqkv" in blk:
            s["bqkv"] = P("tp")
        if "b_fc" in blk:
            s["b_fc"] = P("tp")
        for name in ("bo", "b_proj", "attn_norm_b", "mlp_norm_b"):
            if name in blk:
                s[name] = P()
        return s

    specs = {"embed": P(), "final_norm": P(),
             "blocks": [blk_spec(b) for b in params["blocks"]]}
    if "pos_embed" in params:
        specs["pos_embed"] = P()
    if "final_norm_b" in params:
        specs["final_norm_b"] = P()
    if "lm_head" in params:
        specs["lm_head"] = col(params["lm_head"])
    return specs


def _flat(pool):
    """(L, n_pages, ...) layer-stacked pool -> the (L*n_pages, ...) view
    that the kernels index with page_base = layer * n_pages."""
    return pool.view(pool.shape[0] * pool.shape[1], *pool.shape[2:])


def _paged_heads(y, p, pools_k, pools_v, li, page_tables, positions,
                 cfg: TransformerConfig, page_size: int, lora=None):
    """The attention of one block over B single tokens against the paged
    KV, up to the output projection: y (B, 1, dm) the normed input ->
    (B, 1, n_heads * head_dim) in y's dtype.

    pools_k/pools_v: the layer-stacked pools, written in place at
    [li, page, offset].  Fused layout (pools_v is None): pools_k
    is ONE (L, n_pages, page, 2*Hkv*hd) stack of [k | v] page rows, or with
    int8 KV the pair (int8 stack, fp32 (L, n_pages, page, 128) scale rows
    [sk heads | sv heads | 0]).  Split layout: pools_k and pools_v are
    (L, n_pages, page, Hkv, hd) stacks, or with int8 KV pairs (int8 stack,
    fp32 (L, n_pages, page, Hkv) scales).  page_tables: (B, max_pages)
    int32; positions: (B,) int32 (index of the new token).  lora: None or
    (A (n_adapters, dm, r), B (n_adapters, r, qkv_out), ids (B,)), the
    layer's adapter stacks and each slot's adapter: the slot's
    (y @ A[id]) @ B[id] joins the qkv product in fp32 (adapter 0 is
    zeros)."""
    b = y.shape[0]
    h, hd, hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    max_pages = page_tables.shape[1]

    qkv = _mm(y, p["wqkv"])
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].float()
    if lora is not None:
        a, b_, ids = lora
        qkv = qkv + torch.bmm(torch.bmm(y.float(), a[ids]), b_[ids])
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
    page_slot = page_tables[torch.arange(b, device=y.device), page_idx].long()
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
    return attn.to(y.dtype).reshape(b, 1, h * hd)


def _paged_block(x, p, pools_k, pools_v, li, page_tables, positions,
                 cfg: TransformerConfig, page_size: int, lora=None):
    """One transformer block over B single tokens against the paged KV:
    x (B, 1, dm) -> x.  _paged_heads says what the pools and `lora`
    hold."""
    y = apply_norm(x, p, "attn_norm", cfg)
    attn = _paged_heads(y, p, pools_k, pools_v, li, page_tables, positions,
                        cfg, page_size, lora)
    o = _mm(attn, p["wo"])
    if "bo" in p:
        o = o + p["bo"].float()
    if cfg.parallel_residual:  # GPT-NeoX/GPT-J: branches share the input
        y = apply_norm(x, p, "mlp_norm", cfg)
        return x + o.to(x.dtype) + mlp(y, p, cfg, mm=_mm).to(x.dtype)
    x = x + o.to(x.dtype)
    y = apply_norm(x, p, "mlp_norm", cfg)
    return x + mlp(y, p, cfg, mm=_mm).to(x.dtype)


def apply_logit_penalties(logits, penalties):
    """Logit processors over each slot's token counts (prompt +
    generated): the HF repetition penalty (a seen token's positive logit
    divides, a negative one multiplies), the OpenAI presence (per seen
    token) and frequency (per occurrence) penalties, and an additive bias.
    penalties: dict of counts (B, V), rep (B,), presence (B,), freq (B,),
    bias (B, V)."""
    counts = penalties["counts"].float()
    seen = counts > 0
    rep = penalties["rep"][:, None]
    logits = torch.where(
        seen, torch.where(logits > 0, logits / rep, logits * rep), logits)
    return (logits - penalties["freq"][:, None] * counts
            - penalties["presence"][:, None] * seen + penalties["bias"])


def paged_decode_step(params, pools_k, pools_v, page_tables, positions,
                      last_tokens, generator, cfg: TransformerConfig,
                      page_size: int, temperature=0.0, top_p=1.0,
                      sampling=None, penalties=None, lora=None):
    """One batched decode step over the paged KV (the JAX package's
    _decode_step_impl and its jitted paged_decode_step).

    `sampling`, when given, is a dict of (B,) tensors {temperature, top_p,
    top_k, min_p} for per-slot sampling; it overrides temperature/top_p.
    `penalties`, when given, is apply_logit_penalties' dict; it shapes the
    distribution sampled from, while the log-probs stay the raw ones.
    pools_k/pools_v: the pools in any of _paged_block's four forms
    (pools_v None = fused), each slot's new K/V written in place.  `params`
    may hold quantized (intN, scale) pairs (quantize_decode_params).  Returns
    (tokens (B,) int32, logprobs (B,) fp32); idle slots decode garbage
    that callers ignore.  `lora`, when given, is (A (L, n_adapters, dm,
    r), B (L, n_adapters, r, qkv_out), ids (B,)): each slot's wqkv adapter
    (_paged_heads).

    With a ShardedParams (decode_param_specs' layout) pools_k and pools_v
    are lists, one split pool a held rank, and every rank samples from
    the same gathered logits (held rank 0's copy); lora's B is then a list
    of each held rank's columns of the stack."""
    if isinstance(params, ShardedParams):
        raw = _tp_decode_logits(params, pools_k, pools_v, page_tables,
                                positions, last_tokens, cfg, page_size, lora)
        return _sample(raw, generator, temperature, top_p, sampling,
                       penalties)
    x = embed_tokens(params, last_tokens.long()[:, None], cfg)
    if cfg.pos == "learned":
        # an idle slot's position runs on inside a burst and can pass the
        # table; XLA's gather fills such a row where torch would fault, so
        # the index is clamped (the row is garbage either way, and unread)
        last = params["pos_embed"].shape[0] - 1
        pos = torch.clamp(positions.long(), max=last)
        x = x + params["pos_embed"][pos][:, None].to(cfg.act_dtype)
    for li, p in enumerate(params["blocks"]):
        x = _paged_block(x, p, pools_k, pools_v, li, page_tables, positions,
                         cfg, page_size, None if lora is None
                         else (lora[0][li], lora[1][li], lora[2]))
    x = apply_norm(x, params, "final_norm", cfg)
    # the untied head, the quantized (intN, scale) head, or the tied
    # embedding's transpose: _mm dispatches on the structure
    raw = _mm(x[:, 0], params["lm_head"] if "lm_head" in params
              else params["embed"].T)
    return _sample(raw, generator, temperature, top_p, sampling, penalties)


def _tp_decode_logits(sp: ShardedParams, pools_k, pools_v, page_tables,
                      positions, last_tokens, cfg: TransformerConfig,
                      page_size: int, lora=None):
    """The decode step's raw logits (B, V) over a mesh: each rank's heads
    against its own pools (and its columns of the adapter delta), the
    row-parallel products summed over tp, the logits gathered over tp."""
    n = len(sp.mesh.ranks)
    top = _top_level(sp)
    pos = None
    if cfg.pos == "learned":  # clamped as in paged_decode_step
        pos = torch.clamp(positions.long(),
                          max=top[0]["pos_embed"].shape[0] - 1)[:, None]
    xs = tp_embed(sp, top, [last_tokens.long()[:, None]] * n, cfg,
                  positions=pos)
    lcfg = local_config(cfg, sp)
    for li in range(len(sp.local[0]["blocks"])):
        def heads(i, y, p, li=li):
            ad = None if lora is None else (lora[0][li], lora[1][i][li],
                                            lora[2])
            return _paged_heads(y, p, pools_k[i], pools_v[i], li, page_tables,
                                positions, lcfg, page_size, ad)

        xs = tp_block(xs, [t["blocks"][li] for t in sp.local], cfg, sp,
                      heads, mm=_mm)
    xs = [apply_norm(x, p, "final_norm", cfg)[:, 0] for x, p in zip(xs, top)]
    return tp_logits(sp, top, xs, mm=_mm)[0]


def _sample(raw, generator, temperature, top_p, sampling, penalties):
    """(tokens, raw log-probs) of a decode step's raw logits."""
    logits = raw if penalties is None else apply_logit_penalties(
        raw, penalties)
    if sampling is not None:
        tokens = sample_tokens_per_slot(
            logits, generator, sampling["temperature"], sampling["top_p"],
            sampling["top_k"], sampling["min_p"])
    else:
        tokens = sample_tokens(logits, generator, temperature, top_p)
    return tokens, token_logprobs(raw, tokens)


def paged_decode_burst(params, pools_k, pools_v, page_tables, positions,
                       last_tokens, generator, cfg: TransformerConfig,
                       page_size: int, steps: int, temperature=0.0, top_p=1.0,
                       sampling=None, penalties=None, lora=None):
    """`steps` decode steps in one call (the scheduler does its
    bookkeeping after the burst and discards each slot's tail past its
    finish; pages for max_new are reserved at admission, so decoding past
    a finish writes only into pages the slot owns).  The penalty counts
    advance on the device between the steps (a copy: the caller's counts
    stay as they were); the coefficients, bias and sampling parameters
    hold for the whole burst.  Returns (tokens (steps, B), logprobs
    (steps, B))."""
    toks, lps = [], []
    rows = torch.arange(positions.shape[0], device=positions.device)
    if penalties is not None:
        penalties = {**penalties, "counts": penalties["counts"].float()
                     .clone()}
    for _ in range(steps):
        last_tokens, lp = paged_decode_step(
            params, pools_k, pools_v, page_tables, positions, last_tokens,
            generator, cfg, page_size, temperature, top_p, sampling,
            penalties, lora)
        toks.append(last_tokens)
        lps.append(lp)
        positions = positions + 1
        if penalties is not None:
            penalties["counts"][rows, last_tokens.long()] += 1.0
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
    lora_id: int = 0  # 0 = the base model
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
    # logit processors (HF/OpenAI conventions) over prompt + generated
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    logit_bias: dict | None = None
    # constrained decoding: (generated tokens, prompt) -> (V,) bool allowed
    # mask, or None for no constraint this step; called before every sample
    allowed_fn: object = None
    # wall-clock marks (perf_counter) for TTFT/TPOT
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    cancelled: bool = False


def _penalized(req: Request) -> bool:
    """Whether the request asks for a logit processor."""
    return bool(req.repetition_penalty != 1.0 or req.presence_penalty
                or req.frequency_penalty or req.logit_bias
                or req.allowed_fn is not None)


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
    sliding window).  prefill_chunk (a multiple of page_size) prefills a
    longer prompt suffix that many tokens a scheduler iteration, so the
    other slots keep decoding meanwhile.  decode_burst runs that many
    decode steps a scheduler call when no prefill is in flight and no
    request is constrained.  max_loras > 0 keeps that many wqkv adapters
    of rank lora_rank (register_lora, submit(lora_id=...))."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        batch_slots: int = 4,
        page_size: int | None = 16,
        n_pages: int = 256,
        max_pages_per_seq: int = 16,
        temperature: float = 0.0,
        top_p: float = 1.0,
        eos_token: int | None = None,
        seed: int = 0,
        prefix_cache: bool = False,
        max_loras: int = 0,
        lora_rank: int = 8,
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
                "this engine's page pools hold per-head K/V; MLA models are "
                "served by models.mla_serve.MLAServer (continuous batching "
                "over compressed-latent slots, absorbed-form decode) or "
                "decoded via models.generate.generate()")
        hkv, hd = cfg.kv_heads, cfg.head_dim
        aligned = (hkv * hd) % 128 == 0 and 2 * hkv <= 128
        self.mesh = None if mesh is None else as_mesh(mesh)
        if self.mesh is not None:
            # split pools, sharded over kv heads (the JAX server's layout:
            # a contiguous split of a fused [k | v] row would put k heads
            # and v heads on different ranks)
            if fused_pool:
                raise ValueError("mesh serving keeps split pools; pass "
                                 "fused_pool=False or None")
            fused_pool = False
            if device is not None and resolve_device(device) != \
                    self.mesh.device:
                raise ValueError(f"the mesh is on {self.mesh.device}, not "
                                 f"{device}")
            device = self.mesh.device
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
        if self.mesh is not None:
            self._decode_params = shard_tree(
                self._decode_params, decode_param_specs(self._decode_params),
                self.mesh, cfg)
        self.cfg = cfg
        self.B = batch_slots
        if page_size is None:
            # the card's autotune cache (kfunca.autotune("decode_page",
            # slots, H*hd, context) records the winner), else 16
            from ..runtime import autotune

            hit = autotune.lookup(
                "decode_page", autotune.shape_bucket(batch_slots, hkv * hd),
                torch.bfloat16)
            page_size = int(hit["page_size"]) if hit else 16
        self.page_size = page_size
        if prefill_chunk is not None and (prefill_chunk <= 0
                                          or prefill_chunk % page_size):
            raise ValueError(f"prefill_chunk must be a positive multiple of "
                             f"page_size={page_size}, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self._prefill_state: dict[int, dict] = {}  # slot -> chunked prefill
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

        if self.mesh is not None:  # one split pool a held rank
            lhkv = local_config(cfg, self._decode_params).kv_heads
            hkv = lhkv
            self.pools_k = [pool_of(lhkv, hd) for _ in self.mesh.ranks]
            self.pools_v = [pool_of(lhkv, hd) for _ in self.mesh.ranks]
        elif self.fused_pool:
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
        # logit processors (used once any request asks for one): per-slot
        # coefficients on the host, each slot's token counts (prompt +
        # generated) and bias row on the device
        self._per_slot_penalties = False
        self.slot_rep = np.ones((self.B,), np.float32)
        self.slot_presence = np.zeros((self.B,), np.float32)
        self.slot_freq = np.zeros((self.B,), np.float32)
        self.token_counts = torch.zeros((self.B, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        self.logit_bias = torch.zeros((self.B, cfg.vocab_size),
                                      dtype=torch.float32, device=dev)
        # multi-LoRA: stacked per-layer wqkv adapters, slot 0 the zero
        # (base) adapter; one decode step serves a mixed-adapter batch by
        # per-slot gathers, and prefill runs over the adapter's merged
        # weights (W + A @ B, made once an adapter)
        self.max_loras = int(max_loras)
        self.lora_rank = int(lora_rank)
        self._n_loras = 0
        self._merged_params: dict[int, dict] = {}
        self.lora_A = self.lora_B = None
        self._lora_B_ranks = None  # under a mesh: each held rank's columns
        if self.max_loras:
            stack = (cfg.n_layers, self.max_loras + 1)
            self.lora_A = torch.zeros(stack + (cfg.d_model, self.lora_rank),
                                      dtype=torch.float32, device=dev)
            self.lora_B = torch.zeros(stack + (self.lora_rank, cfg.qkv_out),
                                      dtype=torch.float32, device=dev)
            self._split_lora_B()
        self.slot_lora = np.zeros((self.B,), np.int64)

    # -- API ---------------------------------------------------------------

    def register_lora(self, adapters) -> int:
        """Register a wqkv LoRA adapter; returns its lora_id (>= 1; 0 is the
        base model).  `adapters` is a list of per-layer dicts with "A"
        (d_model, r) and "B" (r, qkv_out) arrays or tensors (models/lora
        .to_serving gives them, the scale folded into B)."""
        if self.max_loras == 0:
            raise ValueError("server constructed with max_loras=0")
        if self._n_loras >= self.max_loras:
            raise ValueError("lora registry full")
        if len(adapters) != self.cfg.n_layers:
            raise ValueError(f"{len(adapters)} adapter layers for a model of "
                             f"{self.cfg.n_layers}")
        want_a = (self.cfg.d_model, self.lora_rank)
        want_b = (self.lora_rank, self.cfg.qkv_out)
        mats = []
        for ad in adapters:
            a = torch.as_tensor(ad["A"]).to(self.device, torch.float32)
            b = torch.as_tensor(ad["B"]).to(self.device, torch.float32)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(f"adapter A {tuple(a.shape)}, B "
                                 f"{tuple(b.shape)}; the server takes "
                                 f"{want_a} and {want_b}")
            mats.append((a, b))
        lid = self._n_loras + 1
        self._n_loras = lid
        for li, (a, b) in enumerate(mats):
            self.lora_A[li, lid] = a
            self.lora_B[li, lid] = b
        self._split_lora_B()
        return lid

    def _split_lora_B(self):
        """Under a mesh, each held rank's columns of lora_B: its heads of
        the [q | k | v] width, as decode_param_specs splits wqkv (all of
        them where attention is replicated)."""
        if self.mesh is None:
            return
        shard = self._decode_params.shards["blocks"][0]["wqkv"]
        shard = shard[0] if isinstance(shard, tuple) else shard
        if shard.tp_dim is None:
            self._lora_B_ranks = [self.lora_B] * len(self.mesh.ranks)
            return
        self._lora_B_ranks = [self.lora_B.index_select(3, shard._tp_index(
            self.mesh.index(r, "tp"), self.mesh.tp, self.device))
            for r in self.mesh.ranks]

    def _params_for(self, lora_id: int):
        """The fp params, or adapter lora_id's merged weights (wqkv + A @ B
        cast to wqkv's dtype), made once an adapter."""
        if lora_id == 0:
            return self.params
        merged = self._merged_params.get(lora_id)
        if merged is None:
            merged = dict(self.params)
            blocks = []
            for li, blk in enumerate(self.params["blocks"]):
                blk = dict(blk)
                delta = self.lora_A[li, lora_id] @ self.lora_B[li, lora_id]
                blk["wqkv"] = blk["wqkv"] + delta.to(blk["wqkv"].dtype)
                blocks.append(blk)
            merged["blocks"] = blocks
            self._merged_params[lora_id] = merged
        return merged

    def submit(self, prompt, max_new: int = 16, lora_id: int = 0, *,
               temperature: float | None = None, top_p: float | None = None,
               top_k: int = 0, min_p: float = 0.0, eos: int | None = None,
               stop=(), repetition_penalty: float = 1.0,
               presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
               logit_bias: dict | None = None, allowed_fn=None) -> int:
        """Queue a request; returns its id.  Sampling kwargs override the
        server defaults for this request only.  `stop` is an iterable of
        token sequences; matching the output tail ends the request (the
        stop tokens stay in the output).  `repetition_penalty` (HF),
        `presence_penalty` / `frequency_penalty` (OpenAI) and `logit_bias`
        ({token: additive bias}) shape every sample over the request's
        prompt + generated tokens.  `allowed_fn(generated, prompt) -> (V,)
        bool | None` constrains decoding: called on the host before every
        sample, its mask suppresses disallowed tokens (a -1e30 bias) for
        this request; it must leave at least one token allowed.  Reported
        log-probs stay those of the raw distribution.  lora_id picks a
        registered adapter (register_lora; 0 is the base model)."""
        if lora_id and not (self.max_loras and 0 < lora_id <= self._n_loras):
            raise ValueError(f"unknown lora_id {lora_id}")
        rid = self._next_id
        self._next_id += 1
        stop = tuple(tuple(int(t) for t in s) for s in stop)
        req = Request(rid, np.asarray(prompt, np.int32), max_new,
                      lora_id=int(lora_id), temperature=temperature, top_p=top_p, top_k=int(top_k),
                      min_p=float(min_p), eos=eos, stop=stop,
                      repetition_penalty=float(repetition_penalty),
                      presence_penalty=float(presence_penalty),
                      frequency_penalty=float(frequency_penalty),
                      logit_bias=dict(logit_bias) if logit_bias else None,
                      allowed_fn=allowed_fn,
                      submitted_at=time.perf_counter())
        if temperature is not None or top_p is not None or top_k or min_p:
            self._per_slot_sampling = True
        if _penalized(req):
            self._per_slot_penalties = True
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
                self._prefill_state.pop(slot, None)
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
            self._advance_prefills()
            active = any(self.slot_req[s] is not None
                         and s not in self._prefill_state
                         for s in range(self.B))
            if active:
                self._step()
            for rid, r in list(self.requests.items()):
                for i in range(before.get(rid, 0), len(r.tokens)):
                    last = r.done and i == len(r.tokens) - 1
                    yield rid, r.tokens[i], r.logprobs[i], last
            if not active and not self._prefill_state and len(self.queue) == 0:
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
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves([self.pools_k, self.pools_v]))

    def _incref(self, page: int) -> None:
        self._page_refs[page] = self._page_refs.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        r = self._page_refs.get(page, 0) - 1
        if r <= 0:
            self._page_refs.pop(page, None)
            self.pool.free([page])
        else:
            self._page_refs[page] = r

    def _prefix_hashes(self, prompt: np.ndarray, lora_id: int = 0) -> list:
        """Chained content hash per FULL prompt page: page i's key commits
        to the entire token prefix [0, (i+1)*page_size) and the adapter id
        (another adapter's K/V of the same tokens differs)."""
        return self._pcache.hash_chain(prompt, self.page_size, lora_id)

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
                    hashes = self._prefix_hashes(req.prompt, req.lora_id)
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
            self.slot_lora[slot] = req.lora_id
            # table-index aligned: trash placeholders for the below-window
            # pages a windowed config never allocates
            self.slot_pages[slot] = [self.trash_page] * first_page + pages
            self.slot_temp[slot] = (
                self.temperature if req.temperature is None else req.temperature)
            self.slot_top_p[slot] = self.top_p if req.top_p is None else req.top_p
            self.slot_top_k[slot] = req.top_k
            self.slot_min_p[slot] = req.min_p
            if self._per_slot_penalties:
                self._set_penalties(slot, req)
            self.page_tables[slot] = self.trash_page
            prefix_len = len(reused) * self.page_size
            skip_len = first_page * self.page_size
            st = t - prefix_len
            if self.prefill_chunk is not None and st > self.prefill_chunk:
                # resumable chunked prefill: the table stays on the trash
                # page (decode writes cannot reach the slot's real pages)
                # until the last chunk scatters; _advance_prefills runs a
                # chunk a scheduler iteration while the others decode
                stp = -(-st // self.page_size) * self.page_size
                tokens, cache = self._prefill_cache_init(slot, req,
                                                         prefix_len, stp)
                self._prefill_state[slot] = dict(
                    req=req, tokens=tokens, cache=cache,
                    prefix_len=prefix_len, skip_len=skip_len, next=0, st=st,
                    stp=stp, hashes=hashes, reused_n=len(reused),
                    pages=pages, first_page=first_page)
                continue
            self.page_tables[slot, first_page : first_page + len(pages)] = pages
            first = self._prefill(slot, req, prefix_len, skip_len)
            self._finish_admission(slot, req, first, hashes, len(reused),
                                   pages)

    def _set_penalties(self, slot: int, req: Request):
        """The slot's penalty coefficients, its token counts starting at
        the prompt's, and its dense bias row."""
        self.slot_rep[slot] = req.repetition_penalty
        self.slot_presence[slot] = req.presence_penalty
        self.slot_freq[slot] = req.frequency_penalty
        counts = np.bincount(req.prompt, minlength=self.cfg.vocab_size)
        bias = np.zeros((self.cfg.vocab_size,), np.float32)
        for tok, b in (req.logit_bias or {}).items():
            bias[int(tok)] = float(b)
        self.token_counts[slot] = torch.from_numpy(
            counts[: self.cfg.vocab_size].astype(np.float32)).to(self.device)
        self.logit_bias[slot] = torch.from_numpy(bias).to(self.device)

    def _advance_prefills(self):
        """One prefill chunk for every mid-prefill slot.  A slot whose last
        chunk completes scatters its KV, installs its page table and
        decodes from this same iteration on."""
        for slot in list(self._prefill_state):
            stt = self._prefill_state[slot]
            req, c0 = stt["req"], stt["next"]
            cl = min(self.prefill_chunk, stt["stp"] - c0)
            logits, stt["cache"] = forward_with_cache(
                self._params_for(req.lora_id), stt["tokens"][:, c0 : c0 + cl], stt["cache"],
                stt["prefix_len"] + c0, self.cfg)
            stt["next"] = c0 + cl
            if stt["next"] < stt["stp"]:
                continue
            # the last chunk holds the last prompt token (the suffix is
            # padded by < page_size <= prefill_chunk)
            self._prefill_scatter(slot, len(req.prompt), stt["cache"],
                                  max(stt["prefix_len"], stt["skip_len"]))
            fp = stt["first_page"]
            self.page_tables[slot, fp : fp + len(stt["pages"])] = stt["pages"]
            first = self._sample_first(slot, req,
                                       logits[:, stt["st"] - 1 - c0])
            del self._prefill_state[slot]
            self._finish_admission(slot, req, first, stt["hashes"],
                                   stt["reused_n"], stt["pages"])

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
        if self._per_slot_penalties:
            self.token_counts[slot, int(first)] += 1.0
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
        logits, cache = forward_with_cache(self._params_for(req.lora_id),
                                           tokens, cache, prefix_len, self.cfg)
        self._prefill_scatter(slot, t, cache, max(prefix_len, skip_len))
        return self._sample_first(slot, req, logits[:, st - 1])

    def _rank_pools(self):
        """[(pools_k, pools_v, the kv heads of the dense cache they hold)]
        a held rank (one entry, every head, without a mesh)."""
        if self.mesh is None:
            return [(self.pools_k, self.pools_v, slice(None))]
        sp = self._decode_params
        n = local_config(self.cfg, sp).kv_heads
        tps = [self.mesh.index(r, "tp") for r in self.mesh.ranks]
        heads = [slice(t * n, (t + 1) * n) if sp.attn_split else slice(None)
                 for t in tps]
        return list(zip(self.pools_k, self.pools_v, heads))

    def _prefill_cache_init(self, slot: int, req: Request, prefix_len: int,
                            stp: int):
        """Padded suffix tokens and a dense KV cache seeded with the reused
        prefix pages' KV, gathered from the pool (dequantized if int8);
        under a mesh each rank's pools give their kv heads."""
        cfg = self.cfg
        st = len(req.prompt) - prefix_len
        padded = np.zeros((1, stp), np.int64)
        padded[0, :st] = req.prompt[prefix_len:]
        tokens = torch.from_numpy(padded).to(self.device)
        cache = init_kv_cache(cfg, 1, prefix_len + stp, self.device)
        if not prefix_len:
            return tokens, cache
        hd = cfg.head_dim
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

        hkv = cfg.kv_heads
        for pools_k, pools_v, heads in self._rank_pools():
            for li, lc in enumerate(cache):
                if self.fused_pool:
                    kv = read(pools_k, li, slice(0, 2 * hkv))
                    k, v = kv[:, :hkv], kv[:, hkv:]
                else:
                    k, v = read(pools_k, li), read(pools_v, li)
                lc["k"][0, heads, :prefix_len] = k.transpose(0, 1)
                lc["v"][0, heads, :prefix_len] = v.transpose(0, 1)
        return tokens, cache

    def _prefill_scatter(self, slot: int, t: int, cache, start: int):
        """Write prompt positions [start rounded down to a page, t) of the
        dense cache (indexed by absolute position) into the slot's pages,
        one indexed write per layer and pool (under a mesh, each rank's
        kv heads into its pools).  The padded tail past t is not
        written."""
        ps = self.page_size
        lo = (start // ps) * ps
        if lo >= t:
            return
        table = torch.as_tensor(self.slot_pages[slot], device=self.device)
        slots = torch.arange(lo, t, device=self.device)
        page_ids, offs = table[slots // ps], slots % ps

        def write(pool, li, x, sc=None):
            if self.quantize_kv:
                pool[0][li, page_ids, offs] = x
                pool[1][li, page_ids, offs] = sc
            else:
                pool[li, page_ids, offs] = x.to(pool.dtype)

        for pools_k, pools_v, heads in self._rank_pools():
            for li, lc in enumerate(cache):
                k = lc["k"][0, heads, lo:t].transpose(0, 1)  # (n, Hkv, hd)
                v = lc["v"][0, heads, lo:t].transpose(0, 1)
                sk = sv = None
                if self.quantize_kv:
                    k, sk = quantize_vecs(k)  # (n, Hkv, hd) int8, (n, Hkv)
                    v, sv = quantize_vecs(v)
                if not self.fused_pool:
                    write(pools_k, li, k, sk)
                    write(pools_v, li, v, sv)
                    continue
                sc = None
                if self.quantize_kv:
                    hkv = k.shape[1]
                    sc = torch.nn.functional.pad(torch.cat([sk, sv], dim=-1),
                                                 (0, 128 - 2 * hkv))
                write(pools_k, li,
                      torch.cat([k.reshape(t - lo, -1), v.reshape(t - lo, -1)],
                                dim=-1), sc)

    def _constraint_row(self, req: Request):
        """(V,) fp32 suppression bias from the request's allowed_fn on the
        device, or None when it is unconstrained this step."""
        if req.allowed_fn is None:
            return None
        allow = req.allowed_fn(req.tokens, req.prompt)
        if allow is None:
            return None
        allow = np.asarray(allow, bool)
        if allow.shape != (self.cfg.vocab_size,):
            raise ValueError(f"allowed_fn must return (vocab_size,) bool, "
                             f"got {allow.shape}")
        row = np.where(allow, np.float32(0.0), np.float32(NEG_INF))
        return torch.from_numpy(row).to(self.device)

    def _bias_with_constraints(self):
        """This step's (B, V) bias: each slot's logit_bias row plus, for a
        constrained slot, its allowed_fn suppression."""
        bias = self.logit_bias
        for slot in range(self.B):
            rid = self.slot_req[slot]
            if rid is None or slot in self._prefill_state:
                continue
            row = self._constraint_row(self.requests[rid])
            if row is not None:
                if bias is self.logit_bias:
                    bias = bias.clone()
                bias[slot] += row
        return bias

    def _sample_first(self, slot: int, req: Request, raw) -> int:
        """Sample the request's first token from its last-prompt logits
        (penalized over the prompt's counts when the request asks)."""
        last = raw
        if _penalized(req):
            bias = self.logit_bias[slot]
            row = self._constraint_row(req)
            if row is not None:
                bias = bias + row

            def vec(v):
                return torch.tensor([v], dtype=torch.float32,
                                    device=self.device)
            last = apply_logit_penalties(raw, {
                "counts": self.token_counts[slot][None],
                "rep": vec(req.repetition_penalty),
                "presence": vec(req.presence_penalty),
                "freq": vec(req.frequency_penalty), "bias": bias[None]})
        if (req.temperature is not None or req.top_p is not None
                or req.top_k or req.min_p):
            def one(v, d, dt=torch.float32):
                return torch.tensor([d if v is None else v], dtype=dt,
                                    device=self.device)
            first = sample_tokens_per_slot(
                last, self._gen, one(req.temperature, self.temperature),
                one(req.top_p, self.top_p), one(req.top_k, 0, torch.int32),
                one(req.min_p, 0.0))
        else:
            first = sample_tokens(last, self._gen, self.temperature,
                                  self.top_p)
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
        penalties = None
        if self._per_slot_penalties:
            penalties = {
                "counts": self.token_counts,
                "rep": torch.from_numpy(self.slot_rep).to(dev),
                "presence": torch.from_numpy(self.slot_presence).to(dev),
                "freq": torch.from_numpy(self.slot_freq).to(dev),
                "bias": self._bias_with_constraints(),
            }
        lora = None
        if self.max_loras:
            lora = (self.lora_A, self._lora_B_ranks or self.lora_B,
                    torch.from_numpy(self.slot_lora).to(dev))
        burst = self._burst_steps()
        args = (self._decode_params, self.pools_k, self.pools_v,
                torch.from_numpy(self.page_tables).to(dev),
                torch.from_numpy(self.positions).to(dev),
                torch.from_numpy(self.last_tokens).to(dev), self._gen,
                self.cfg, self.page_size)
        if burst > 1:
            tokens, lps = paged_decode_burst(
                *args, burst, self.temperature, self.top_p, sampling,
                penalties, lora)
        else:
            tokens, lps = paged_decode_step(
                *args, self.temperature, self.top_p, sampling, penalties,
                lora)
            tokens, lps = tokens[None], lps[None]  # (1, B)
        self.decode_steps += burst
        tokens = tokens.cpu().numpy()  # (steps, B)
        lps = lps.cpu().numpy()
        counted = []  # (slot, token) of every accepted token
        for slot in range(self.B):
            rid = self.slot_req[slot]
            if rid is None or slot in self._prefill_state:
                continue  # a mid-prefill slot decoded against the trash page
            req = self.requests[rid]
            for i in range(tokens.shape[0]):
                tok = int(tokens[i, slot])
                req.tokens.append(tok)
                req.logprobs.append(float(lps[i, slot]))
                counted.append((slot, tok))
                self.positions[slot] += 1
                self.last_tokens[slot] = tok
                if self.cfg.attention_window is not None:
                    self._free_behind_window(slot)
                if self._finished(req, tok):
                    # the burst's tail past the finish is discarded
                    self._release(slot)
                    break
        if self._per_slot_penalties and counted:
            idx = torch.tensor(counted, device=dev).T
            self.token_counts.index_put_(
                (idx[0], idx[1]), torch.ones(len(counted), device=dev),
                accumulate=True)

    def _burst_steps(self) -> int:
        """`decode_burst` when no prefill is in flight (chunks advance a
        scheduler iteration each), no active slot is constrained (allowed_fn
        needs a host callback a token) and every active slot has at least
        that many tokens left (no wasted tail work); else 1."""
        k = self.decode_burst
        if k <= 1 or self._prefill_state:
            return 1
        for slot in range(self.B):
            rid = self.slot_req[slot]
            if rid is not None:
                req = self.requests[rid]
                if (req.allowed_fn is not None
                        or req.max_new - len(req.tokens) < k):
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
        self.slot_lora[slot] = 0
        self.slot_req[slot] = None
        self.slot_pages[slot] = []
        self.page_tables[slot] = self.trash_page
