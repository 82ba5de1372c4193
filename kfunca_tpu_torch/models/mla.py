"""Multi-head latent attention (MLA, DeepSeek-V2/V3).

Counterpart of kfunca_tpu/models/mla.py.  Queries, keys and values are
low-rank factored through a shared latent: K/V expand from one compressed
vector c_kv a position, so the decode cache a layer is (kv_lora_rank +
qk_rope_head_dim) values a position whatever the head count, and decode
runs in the absorbed form (q projected once through w_uk into latent
space, scores dotted against the latent cache, values re-expanded through
w_uv only after the weighted sum).

Training takes the expanded form.  With equal head dims (qk_nope + qk_rope
== v_head_dim, the JAX default 64 + 64 = 128) it runs the flash kernels
(causal_attention_fn: K1 and K2 on the card), scale 1/sqrt(qk); any other
geometry (DeepSeek-V3's qk 192 against v 128) the einsum oracle
`_sdpa_xla`, as the JAX package does.  The absorbed and per-slot decode
forms are fp32 einsums, which the JAX package also computes outside any
Pallas kernel.

Param layout of a block (in place of "wqkv"; "wo" stays):
    w_dq (d, q_rank), q_norm (q_rank,), w_uq (q_rank, h*qk_head)  [q_rank>0]
    w_q  (d, h*qk_head)                                           [q_rank=0]
    w_dkv (d, kv_rank + qk_rope): the latent and the SHARED rope key
    kv_norm (kv_rank,): RMSNorm on the latent
    w_uk (kv_rank, h*qk_nope), w_uv (kv_rank, h*v_dim)
"q_norm" is the query latent's norm here, never the per-head qk norm.
RoPE rotates only the decoupled rope dims: per head on q_pe, one shared
head on k_pe, broadcast to every head at score time.

Every projection rounds to the activation dtype (the JAX module's own _mm),
and the latent's RMSNorm runs on the rounded value.

Over tensor parallelism the work splits at `mla_latent`: the latent (and
the query latent) is computed on every rank from replicated weights, then
each rank expands its own heads (w_q / w_uq, w_uk, w_uv split by whole
heads) and wo is row-parallel (models/transformer.tp_block).
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import _sdpa_xla, causal_attention_fn
from .generate import _rope_at
from .transformer import (
    TransformerConfig, _mm_with_lora, _plain_mm, _rope, apply_norm, mlp,
    rms_norm,
)

NEG_INF = -1e30


def mla_dims(cfg: TransformerConfig):
    """(h, qk_head, nope, rope, v_dim, kv_rank) for the config."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    v_dim = cfg.v_head_dim or (nope + rope)
    return cfg.n_heads, nope + rope, nope, rope, v_dim, cfg.kv_lora_rank


def init_mla_block(linear, full, cfg: TransformerConfig):
    """MLA attention params for one block (the caller adds norms and the
    MLP), drawn by transformer.init_params's linear(fan_in, fan_out) and
    full(n, value) in the JAX function's key order."""
    h, qk, nope, rope, v_dim, d_c = mla_dims(cfg)
    blk = {}
    if cfg.q_lora_rank:
        blk["w_dq"] = linear(cfg.d_model, cfg.q_lora_rank)
        blk["q_norm"] = full(cfg.q_lora_rank, 1.0)
        blk["w_uq"] = linear(cfg.q_lora_rank, h * qk)
    else:
        blk["w_q"] = linear(cfg.d_model, h * qk)
    blk["w_dkv"] = linear(cfg.d_model, d_c + rope)
    blk["kv_norm"] = full(d_c, 1.0)
    blk["w_uk"] = linear(d_c, h * nope)
    blk["w_uv"] = linear(d_c, h * v_dim)
    blk["wo"] = linear(h * v_dim, cfg.d_model)
    return blk


def _mm(y, w):
    """y @ w summed in fp32 and rounded to y's dtype."""
    return _plain_mm(y, w).to(y.dtype)


def _wo(attn, p):
    """The output projection, with the block's wo adapter where it has one
    (the JAX _mm_with_lora)."""
    return _mm_with_lora(attn, p["wo"], p, "wo")


def _pe_rope(x, cfg: TransformerConfig, positions=None):
    """RoPE on the decoupled rope dims (B, H, T, D), honouring
    cfg.rope_interleave: the interleaved (2i, 2i+1) pairs are
    de-interleaved into the half-split layout, rotated, and interleaved
    again.  `positions` as generate._rope_at takes them ((T,) or (B, T));
    None is 0..T-1."""
    theta, pscale = cfg.rope_params()

    def base(xx):
        if positions is None:
            return _rope(xx, theta, pscale)
        return _rope_at(xx, positions, theta, pscale)

    if not cfg.rope_interleave:
        return base(x)
    half = x.shape[-1] // 2
    r = base(torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1))
    return torch.stack([r[..., :half], r[..., half:]], dim=-1).reshape(x.shape)


def _query_input(y, p, cfg: TransformerConfig):
    """The normed query latent (q_lora_rank > 0), or y itself."""
    if not cfg.q_lora_rank:
        return y
    return rms_norm(_mm(y, p["w_dq"]), p["q_norm"], cfg.norm_eps)


def mla_latent(y, p, cfg: TransformerConfig):
    """What every head reads, from replicated weights: (the query's input,
    _query_input's; c_kv (B, S, d_c) normed; k_pe (B, 1, S, rope) before
    RoPE)."""
    return (_query_input(y, p, cfg), *_project_latent(y, p, cfg))


def _heads_q(qin, p, cfg: TransformerConfig):
    """The query input -> (q_nope (B,h,S,nope), q_pe (B,h,S,rope)), pre-rope."""
    h, qk, nope, _, _, _ = mla_dims(cfg)
    q = _mm(qin, p["w_uq"] if cfg.q_lora_rank else p["w_q"])
    b, s, _ = qin.shape
    q = q.reshape(b, s, h, qk).transpose(1, 2)
    return q[..., :nope], q[..., nope:]


def _project_q(y, p, cfg: TransformerConfig):
    """y (B,S,d) -> (q_nope (B,h,S,nope), q_pe (B,h,S,rope)), pre-rope."""
    return _heads_q(_query_input(y, p, cfg), p, cfg)


def _project_latent(y, p, cfg: TransformerConfig):
    """y (B,S,d) -> (c_kv (B,S,d_c) RMS-normed, k_pe (B,1,S,rope) pre-rope)."""
    _, _, _, rope, _, d_c = mla_dims(cfg)
    ckv = _mm(y, p["w_dkv"])
    c = rms_norm(ckv[..., :d_c], p["kv_norm"], cfg.norm_eps)
    return c, ckv[..., d_c:][:, None]  # one shared rope head


def mla_heads(lat, p, cfg: TransformerConfig):
    """Expanded-form causal attention of cfg's heads over mla_latent's
    `lat`, up to the output projection: (B, S, h * v_dim) in the
    activation dtype."""
    h, qk, nope, rope, v_dim, d_c = mla_dims(cfg)
    qin, c, k_pe = lat
    b, s, _ = c.shape
    q_nope, q_pe = _heads_q(qin, p, cfg)
    q_pe = _pe_rope(q_pe, cfg)
    k_pe = _pe_rope(k_pe, cfg)
    k_nope = _mm(c, p["w_uk"]).reshape(b, s, h, nope).transpose(1, 2)
    v = _mm(c, p["w_uv"]).reshape(b, s, h, v_dim).transpose(1, 2)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, h, s, rope)], dim=-1)
    if v_dim == qk:  # the flash kernels' contract: equal head dims
        attn = causal_attention_fn(q, k, v.contiguous())
    else:
        attn = _sdpa_xla(q, k, v)
    return attn.transpose(1, 2).reshape(b, s, h * v_dim)


def mla_attention(y, p, cfg: TransformerConfig):
    """Expanded-form causal MLA over a full sequence (the training path).
    y: (B, S, d) normed block input -> the post-wo output (B, S, d) fp32."""
    return _wo(mla_heads(mla_latent(y, p, cfg), p, cfg), p)


# -- absorbed-form cached decode -----------------------------------------------


def init_mla_cache(cfg: TransformerConfig, batch: int, max_len: int,
                   device=None):
    """Per-layer compressed cache in the activation dtype: the RMS-normed
    latent "ckv" (batch, max_len, d_c) and the shared rope key "kpe"
    (batch, max_len, rope)."""
    from ..runtime.backend import resolve_device

    _, _, _, rope, _, d_c = mla_dims(cfg)
    dev = resolve_device(device)
    return [{"ckv": torch.zeros((batch, max_len, d_c), dtype=cfg.act_dtype,
                                device=dev),
             "kpe": torch.zeros((batch, max_len, rope), dtype=cfg.act_dtype,
                                device=dev)}
            for _ in range(cfg.n_layers)]


def _absorbed(q_nope, q_pe, ckv, kpe, mask, p, cfg: TransformerConfig):
    """Scores of q against the latent cache, the probability-weighted
    latent sum, and its re-expansion through w_uv: (B, T, h * v_dim) fp32.
    q_nope (B,h,T,nope), q_pe (B,h,T,rope) roped, ckv (B,L,d_c), kpe
    (B,L,rope), mask broadcasting to (B,h,T,L)."""
    h, qk, nope, _, v_dim, d_c = mla_dims(cfg)
    w_uk = p["w_uk"].reshape(d_c, h, nope).float()
    q_abs = torch.einsum("bhtn,chn->bhtc", q_nope.float(), w_uk)
    s = torch.einsum("bhtc,blc->bhtl", q_abs, ckv.float())
    s = s + torch.einsum("bhtr,blr->bhtl", q_pe.float(), kpe.float())
    s = s * (1.0 / math.sqrt(qk))
    s = torch.where(mask, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    ol = torch.einsum("bhtl,blc->bhtc", prob, ckv.float())
    w_uv = p["w_uv"].reshape(d_c, h, v_dim).float()
    out = torch.einsum("bhtc,chv->bthv", ol, w_uv)
    return out.reshape(out.shape[0], out.shape[1], h * v_dim)


def mla_cached_heads(lat, p, layer_cache, start_pos: int,
                     cfg: TransformerConfig):
    """Absorbed-form attention of T new tokens at absolute start_pos over
    mla_latent's `lat`, writing their latent and rope key into the cache
    (in place; the JAX update is a dynamic_update_slice): (B, T,
    h * v_dim) in the activation dtype."""
    qin, c, k_pe = lat
    b, t, _ = c.shape
    max_len = layer_cache["ckv"].shape[1]
    if start_pos + t > max_len:
        raise ValueError(f"{t} tokens at {start_pos} overrun a cache of "
                         f"{max_len}")
    positions = start_pos + torch.arange(t, device=c.device)
    q_nope, q_pe = _heads_q(qin, p, cfg)
    q_pe = _pe_rope(q_pe, cfg, positions)
    k_pe = _pe_rope(k_pe, cfg, positions)[:, 0]  # (B, T, rope)
    ckv, kpe = layer_cache["ckv"], layer_cache["kpe"]
    ckv[:, start_pos:start_pos + t] = c.to(ckv.dtype)
    kpe[:, start_pos:start_pos + t] = k_pe.to(kpe.dtype)
    mask = (torch.arange(max_len, device=c.device)[None, :]
            <= positions[:, None])
    return _absorbed(q_nope, q_pe, ckv, kpe, mask, p, cfg).to(c.dtype)


def mla_attend_cached(y, p, layer_cache, start_pos: int,
                      cfg: TransformerConfig):
    """Absorbed-form MLA over T new tokens at absolute start_pos: y (B, T,
    d) normed -> (o (B, T, d) fp32, layer_cache)."""
    heads = mla_cached_heads(mla_latent(y, p, cfg), p, layer_cache,
                             start_pos, cfg)
    return _wo(heads, p), layer_cache


def mla_block_with_cache(x, p, layer_cache, start_pos: int,
                         cfg: TransformerConfig):
    """A whole MLA block (attention and MLP residuals) for the decode path,
    generate._block_with_cache's shape -> (x, layer_cache)."""
    y = apply_norm(x, p, "attn_norm", cfg)
    o, layer_cache = mla_attend_cached(y, p, layer_cache, start_pos, cfg)
    if cfg.parallel_residual:
        y = apply_norm(x, p, "mlp_norm", cfg)
        return (x + o.to(x.dtype) + mlp(y, p, cfg).to(x.dtype), layer_cache)
    x = x + o.to(x.dtype)
    y = apply_norm(x, p, "mlp_norm", cfg)
    return x + mlp(y, p, cfg).to(x.dtype), layer_cache


def _pe_rope_perslot(x, cfg: TransformerConfig, positions):
    """_pe_rope of one token a slot at each slot's own position: x
    (B, H, 1, D), positions (B,)."""
    return _pe_rope(x, cfg, positions[:, None])


def mla_attend_cached_perslot(y, p, layer_cache, positions,
                              cfg: TransformerConfig):
    """Absorbed-form MLA decode of ONE token a slot: y (B, 1, d) normed,
    positions (B,) each slot's absolute position (clamped to max_len - 1,
    as the JAX scatter clamps).  Writes each slot's latent and rope key at
    its own position (in place) and scores each slot against its own
    history.  Returns (o (B, 1, d) fp32, layer_cache)."""
    h, qk, nope, rope, v_dim, d_c = mla_dims(cfg)
    b = y.shape[0]
    ckv, kpe = layer_cache["ckv"], layer_cache["kpe"]
    max_len = ckv.shape[1]
    pos = torch.clamp(positions.long(), max=max_len - 1)
    qin, c, k_pe = mla_latent(y, p, cfg)
    q_nope, q_pe = _heads_q(qin, p, cfg)
    q_pe = _pe_rope_perslot(q_pe, cfg, pos)
    k_pe = _pe_rope_perslot(k_pe, cfg, pos)[:, 0]  # (B, 1, rope)
    bi = torch.arange(b, device=y.device)
    ckv[bi, pos] = c[:, 0].to(ckv.dtype)
    kpe[bi, pos] = k_pe[:, 0].to(kpe.dtype)
    mask = (torch.arange(max_len, device=y.device)[None, None, None, :]
            <= pos[:, None, None, None])
    out = _absorbed(q_nope, q_pe, ckv, kpe, mask, p, cfg).to(y.dtype)
    return _wo(out, p), layer_cache
