"""Autoregressive generation with a dense KV cache, and the serving
engine's prefill.

Counterpart of kfunca_tpu/models/generate.py (init_kv_cache, _rope_at,
cached_attention_mixer, _block_with_cache, forward_with_cache, generate,
beam_search).  The attention here is plain fp32 einsum attention over the cache with a
position mask, as in the JAX package, which computes it outside any
Pallas kernel.  The JAX cache update is a functional
dynamic_update_slice; the port writes the new K/V into the cache tensors
in place and returns the same list.  The JAX generate and beam_search
compile prefill and a lax.scan of decode steps into one program; here the
decode loop is a Python loop.
"""

from __future__ import annotations

import math

import torch

from ..runtime.backend import resolve_device
from .transformer import (
    TransformerConfig, _plain_mm, apply_norm, apply_qk_norm, embed_tokens,
    lm_head_weight, mlp, split_qkv,
)

NEG_INF = -1e30


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None):
    """Per-layer {"k", "v"} zeros of (batch, kv_heads, max_len, head_dim)."""
    if cfg.attention == "mla":
        raise NotImplementedError("MLA caches are a later slice of the port")
    dev = resolve_device(device)
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.act_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.act_dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _rope_at(x, positions, theta: float, pos_scale: float = 1.0,
             pct: float = 1.0):
    """RoPE at explicit absolute positions; x: (B, H, T, D).  positions is
    (T,) for one position per token shared by the batch, or (B, T) for
    each sequence's own positions (the decode step's case, a vmap in the
    JAX package).  pos_scale < 1 is linear position interpolation; pct < 1
    rotates only the first pct of the head dims (GPT-NeoX rotary_pct)."""
    if pct < 1.0:
        rot = int(x.shape[-1] * pct) & ~1
        return torch.cat([_rope_at(x[..., :rot], positions, theta, pos_scale),
                          x[..., rot:]], dim=-1)
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = (positions.float() * pos_scale)[..., None] * freqs  # (.., T, half)
    if ang.ndim == 3:
        ang = ang[:, None]  # (B, 1, T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def cached_attention_mixer(y, p, layer_cache, start_pos: int,
                           cfg: TransformerConfig):
    """Causal attention over T new tokens at absolute start_pos, writing
    their K/V into the cache: y (B, T, d) normed input -> (o (B, T, d)
    fp32, layer_cache)."""
    b, t, dm = y.shape
    h, hd, hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    max_len = layer_cache["k"].shape[2]
    if start_pos + t > max_len:
        raise ValueError(f"{t} tokens at {start_pos} overrun a cache of "
                         f"{max_len}")

    qkv = _plain_mm(y, p["wqkv"])
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].float()
    q, k, v = split_qkv(qkv.to(y.dtype), cfg)
    q, k = apply_qk_norm(q, k, p, cfg)
    positions = start_pos + torch.arange(t, device=y.device)
    if cfg.pos == "rope":
        theta, pscale = cfg.rope_params()
        q = _rope_at(q, positions, theta, pscale, cfg.rope_pct)
        k = _rope_at(k, positions, theta, pscale, cfg.rope_pct)
    # in place (the JAX cache update is a dynamic_update_slice)
    layer_cache["k"][:, :, start_pos : start_pos + t] = k
    layer_cache["v"][:, :, start_pos : start_pos + t] = v
    kc, vc = layer_cache["k"], layer_cache["v"]

    # grouped queries (B, Hkv, G, T, hd) against the shared kv head
    group = h // hkv
    qg = q.reshape(b, hkv, group, t, hd)
    s = torch.einsum("bkgtd,bkld->bkgtl", qg.float(), kc.float()) * (
        1.0 / math.sqrt(hd))
    q_pos = positions[:, None]
    l_pos = torch.arange(max_len, device=y.device)[None, :]
    mask = l_pos <= q_pos
    if cfg.attention_window is not None:
        mask = mask & (l_pos > q_pos - cfg.attention_window)
    s = torch.where(mask, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    attn = torch.einsum("bkgtl,bkld->bkgtd", prob, vc.float()).to(y.dtype)
    attn = attn.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, dm)
    o = _plain_mm(attn, p["wo"])
    if "bo" in p:
        o = o + p["bo"].float()
    return o, layer_cache


def _block_with_cache(x, p, layer_cache, start_pos: int,
                      cfg: TransformerConfig):
    """One block over T new tokens at start_pos -> (x, layer_cache)."""
    y = apply_norm(x, p, "attn_norm", cfg)
    o, layer_cache = cached_attention_mixer(y, p, layer_cache, start_pos, cfg)
    if cfg.parallel_residual:  # GPT-NeoX/GPT-J: branches share the input
        y = apply_norm(x, p, "mlp_norm", cfg)
        return (x + o.to(x.dtype) + mlp(y, p, cfg).to(x.dtype), layer_cache)
    x = x + o.to(x.dtype)
    y = apply_norm(x, p, "mlp_norm", cfg)
    return x + mlp(y, p, cfg).to(x.dtype), layer_cache


def forward_with_cache(params, tokens, cache, start_pos: int,
                       cfg: TransformerConfig):
    """tokens (B, T) at absolute start_pos -> (logits (B, T, V) fp32,
    cache)."""
    x = embed_tokens(params, tokens, cfg)
    if cfg.pos == "learned":
        pos = start_pos + torch.arange(tokens.shape[1], device=tokens.device)
        x = x + params["pos_embed"][pos].to(cfg.act_dtype)
    for p, lc in zip(params["blocks"], cache):
        x, _ = _block_with_cache(x, p, lc, start_pos, cfg)
    x = apply_norm(x, params, "final_norm", cfg)
    return _plain_mm(x, lm_head_weight(params, x.dtype)), cache


@torch.no_grad()
def generate(params, prompt, cfg: TransformerConfig, max_new: int,
             temperature: float = 0.0, generator=None):
    """Greedy (temperature 0) or sampled generation.

    prompt: (B, T_prompt) integer tensor on the params' device.  Returns
    (B, max_new) int32 generated tokens.  Sampling draws from `generator`
    (a torch.Generator on that device; seeded with 0 when None).  torch and
    jax.random draw different numbers, so only greedy output equals the
    JAX package's token for token."""
    b, t_prompt = prompt.shape
    dev = prompt.device
    cache = init_kv_cache(cfg, b, t_prompt + max_new, dev)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg)
    last = logits[:, -1]
    toks = []
    for i in range(max_new):
        if temperature == 0.0:
            tok = torch.argmax(last, dim=-1)
        else:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        toks.append(tok.int())
        lg, cache = forward_with_cache(params, tok[:, None], cache,
                                       t_prompt + i, cfg)
        last = lg[:, -1]
    return torch.stack(toks, dim=1)


@torch.no_grad()
def beam_search(params, prompt, cfg: TransformerConfig, max_new: int,
                beam: int = 4, length_penalty: float = 0.0,
                eos: int | None = None):
    """Beam-search decoding, beams as batch lanes.

    prompt (B, T) integer tensor -> (tokens (B, beam, max_new) int32,
    scores (B, beam) fp32), beams sorted best-first.  Scores are summed raw
    log-probs; with length_penalty a > 0 the final ranking divides by the
    GNMT penalty ((5 + len) / 6) ** a.  `eos` freezes finished beams: they
    emit eos forever at unchanged score, so shorter finished hypotheses
    compete with live ones.  Prefill runs once at (B, T); the cache is then
    tiled to B*beam lanes and reordered by parent beam each step."""
    b, t_prompt = prompt.shape
    dev = prompt.device
    w, v_size = beam, cfg.vocab_size

    cache = init_kv_cache(cfg, b, t_prompt + max_new, dev)
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg)
    cache = [{k: v.repeat_interleave(w, dim=0) for k, v in lc.items()}
             for lc in cache]
    lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
    lp = lp.repeat_interleave(w, dim=0)  # (B*w, V)

    # beam 0 starts at 0, the rest at -1e30, so step 1 picks w DISTINCT
    # continuations of the single prompt hypothesis
    scores = torch.tensor([0.0] + [NEG_INF] * (w - 1), device=dev).repeat(b, 1)
    seqs = torch.zeros((b, w, max_new), dtype=torch.int32, device=dev)
    done = torch.zeros((b, w), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, w), dtype=torch.int32, device=dev)
    if eos is not None:  # finished beams: only eos continues, at no cost
        frozen = torch.full((v_size,), NEG_INF, device=dev)
        frozen[eos] = 0.0

    for i in range(max_new):
        lp = lp.reshape(b, w, v_size)
        if eos is not None:
            lp = torch.where(done[:, :, None], frozen, lp)
        total = scores[:, :, None] + lp  # (B, w, V)
        # sorted, and lax.top_k's order among equal values: lowest index first
        scores, top_idx = torch.topk(total.reshape(b, w * v_size), w, dim=1)
        parent = top_idx // v_size  # (B, w)
        tok = top_idx % v_size

        # reorder histories and per-beam state by parent
        seqs = seqs.gather(1, parent[:, :, None].expand(-1, -1, max_new))
        seqs[:, :, i] = tok.int()
        done = done.gather(1, parent)
        lengths = lengths.gather(1, parent)
        lengths = torch.where(done, lengths, lengths + 1)
        if eos is not None:
            done = done | (tok == eos)
        # reorder the KV cache: lane index = batch index * w + parent
        lane = (torch.arange(b, device=dev)[:, None] * w + parent).reshape(-1)
        cache = [{k: v[lane] for k, v in lc.items()} for lc in cache]

        lg, cache = forward_with_cache(params, tok.reshape(b * w, 1), cache,
                                       t_prompt + i, cfg)
        lp = torch.log_softmax(lg[:, -1].float(), dim=-1)

    ranked = scores
    if length_penalty > 0.0:
        ranked = scores / ((5.0 + lengths.float()) / 6.0) ** length_penalty
    order = torch.argsort(-ranked, dim=1, stable=True)
    seqs = seqs.gather(1, order[:, :, None].expand(-1, -1, max_new))
    return seqs, ranked.gather(1, order)
