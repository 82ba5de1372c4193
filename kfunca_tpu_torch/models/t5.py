"""T5-family encoder-decoder: seq2seq training, cached generation, HF interop
and a tensor-parallel form.

Counterpart of kfunca_tpu/models/t5.py, with its parameter layout
(models/weights.t5_params_from_jax carries a JAX pytree across): a
bidirectional encoder, a causal decoder with cross-attention over the
encoder output, and T5's bucketed relative position bias (no absolute
positions), one table a stack shared by its layers.  Both generations:
the original T5 (ReLU MLP, tied head with the d_model**-0.5 rescale) and
t5-v1.1 / Flan-T5 (gated tanh-GELU MLP, untied lm_head).

What HF parity forces, as in the JAX module: NO 1/sqrt(d) score scale,
d_kv independent of d_model / n_heads (the inner width n_heads * d_kv),
RMSNorm everywhere, bias-free cross-attention, masking as where(mask, s,
-1e30) before the softmax.  Attention is an fp32 einsum with the additive
bias, which the JAX package also leaves to XLA: no kernel of the port
serves it.

The bucket of a relative offset truncates a float32 log to an integer,
so an ulp of the logarithm can move a bucket where the quotient lands near
an integer.  The bucket tables are computed on the host in float32, once
for each (query offset, Tq, Tk), and moved to the device as integers.

Generation is a host loop of single-token decode steps: the encoder and
each decoder layer's cross-attention K/V once, then a self-attention cache
written in place (the JAX dynamic_update_slice).

The forward, the loss and generation run over the held ranks of a mesh
(`seq2seq.Ranks`): a plain param tree is one rank holding everything, a
ShardedParams (shard_t5_params) the ranks of a (dp, tp) mesh, each with
its own heads (q / k / v column-parallel, o row-parallel, the bias tables
over their head axis), its columns of the MLP's wi and rows of wo, and
its slice of d_model of the embedding; the activations between sub-layers
are replicated, one all-reduce after each row-parallel product.  So the
tp forward, loss and generate are the single-device code.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import collectives as cc
from ..parallel.mesh import P, ShardedParams, as_mesh, shard_tree
from ..runtime.backend import resolve_device
from .hf import _Reader, is_checkpoint_path, read_hf_dir
from .mamba import _linear
from .seq2seq import (Ranks, attend, cached_kv, fixed_kv, kv_of, merge_heads,
                      new_caches, split_heads)
from .transformer import (_DTYPES, _masked_mean, _plain_mm, rms_norm,
                          row_parallel)

IGNORE = -100


@dataclass(frozen=True)
class T5Config:
    """The JAX package's T5Config, field for field."""

    vocab_size: int = 512
    d_model: int = 256
    n_heads: int = 4
    d_kv: int = 64  # per-head width: the inner width is n_heads * d_kv
    d_ff: int = 512
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    dtype: str = "bfloat16"  # activation dtype; params stay fp32
    norm_eps: float = 1e-6
    rel_buckets: int = 32
    rel_max_distance: int = 128
    mlp_type: str = "relu"  # "relu" (T5) or "gated-gelu" (v1.1 / Flan-T5)
    tied_head: bool = True  # logits = (x * d_model**-0.5) @ embed.T
    decoder_start_id: int = 0
    pad_id: int = 0

    @property
    def inner_dim(self) -> int:
        return self.n_heads * self.d_kv

    @property
    def kv_heads(self) -> int:
        """Every head has keys and values of its own: parallel.mesh splits
        attention by whole heads where tp divides them."""
        return self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# -- params -------------------------------------------------------------------


def init_t5_params(seed: int, cfg: T5Config, device=None, dtype=torch.float32):
    """Random params with the JAX laws (embedding N(0, 1), bias tables
    N(0, 0.1^2), norms 1, matrices U(-1/sqrt(fan_in), 1/sqrt(fan_in))),
    drawn from a torch.Generator seeded with `seed` on `device` (default:
    the CUDA device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, inner = cfg.d_model, cfg.inner_dim

    def normal(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    def attn():
        return {"wq": _linear(gen, d, inner, dtype),
                "wk": _linear(gen, d, inner, dtype),
                "wv": _linear(gen, d, inner, dtype),
                "wo": _linear(gen, inner, d, dtype)}

    def mlp():
        if cfg.mlp_type == "gated-gelu":
            return {"wi_0": _linear(gen, d, cfg.d_ff, dtype),
                    "wi_1": _linear(gen, d, cfg.d_ff, dtype),
                    "wo": _linear(gen, cfg.d_ff, d, dtype)}
        return {"wi": _linear(gen, d, cfg.d_ff, dtype),
                "wo": _linear(gen, cfg.d_ff, d, dtype)}

    params = {
        "embed": normal((cfg.vocab_size, d)),
        "enc_rel_bias": normal((cfg.rel_buckets, cfg.n_heads), 0.1),
        "dec_rel_bias": normal((cfg.rel_buckets, cfg.n_heads), 0.1),
        "enc_final_norm": ones(), "dec_final_norm": ones(),
        "encoder": [{"attn_norm": ones(), "attn": attn(), "mlp_norm": ones(),
                     "mlp": mlp()} for _ in range(cfg.n_enc_layers)],
        "decoder": [{"attn_norm": ones(), "attn": attn(), "cross_norm": ones(),
                     "cross": attn(), "mlp_norm": ones(), "mlp": mlp()}
                    for _ in range(cfg.n_dec_layers)],
    }
    if not cfg.tied_head:
        params["lm_head"] = _linear(gen, d, cfg.vocab_size, dtype)
    return params


# -- relative position bias ---------------------------------------------------


def relative_position_bucket(rel, bidirectional: bool, num_buckets: int = 32,
                             max_distance: int = 128):
    """T5's bucket of each relative offset (rel = key_pos - query_pos), on
    rel's device: half the buckets exact small offsets, half log-spaced
    out to max_distance; a bidirectional stack splits them by sign.  The
    JAX function's float32 arithmetic, step for step."""
    rel = rel.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n = n // 2
        ret = ret + (rel > 0).to(torch.int32) * n
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = n // 2
    is_small = rel < max_exact
    relf = torch.clamp(rel.to(torch.float32), min=1.0)
    large = max_exact + (torch.log(relf / max_exact)
                         / math.log(max_distance / max_exact)
                         * (n - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=n - 1)
    return ret + torch.where(is_small, rel, large)


@lru_cache(maxsize=64)
def _host_buckets(q0: int, tq: int, tk: int, bidirectional: bool,
                  num_buckets: int, max_distance: int) -> torch.Tensor:
    """The (tq, tk) buckets of queries at q0.. against keys at 0.., computed
    on the host (the CPU's float32 log) once for each argument set."""
    rel = (torch.arange(tk)[None, :] - torch.arange(q0, q0 + tq)[:, None])
    return relative_position_bucket(rel, bidirectional, num_buckets,
                                    max_distance).long()


def _rel_bias(table, buckets):
    """(H, Tq, Tk) fp32 additive score bias of a (buckets, H) table."""
    return table[buckets].permute(2, 0, 1).float()


def _proj(y, a, name, cfg):
    """A head projection (B, H, T, d_kv) in y's dtype."""
    return split_heads(_plain_mm(y, a[name]).to(y.dtype), cfg)


def _attn_out(r: Ranks, xs, attns, q_ins, kv, biases=None, mask=None):
    """x + wo(attend(...)) over the held ranks: q_ins the normed query
    inputs, kv(i, a) rank i's (k, v), biases one a rank or None; wo
    row-parallel (one all-reduce)."""
    q_ins = cc.copy(q_ins, r.mesh)
    heads = []
    for i, (x, a, q_in) in enumerate(zip(xs, attns, q_ins)):
        k, v = kv(i, a)
        q = _proj(q_in, a, "wq", r.lcfg)
        bias = None if biases is None else biases[i]
        heads.append(merge_heads(attend(q, k, v, bias, mask).to(x.dtype)))
    outs = row_parallel(heads, [a["wo"] for a in attns], r.mesh, _plain_mm,
                        True)
    return [x + o.to(x.dtype) for x, o in zip(xs, outs)]


def _kv_heads(y, a, cfg):
    """The (k, v) heads of y, in its dtype."""
    return _proj(y, a, "wk", cfg), _proj(y, a, "wv", cfg)


def _mlp_out(r: Ranks, xs, ps, cfg: T5Config):
    ys = cc.copy([rms_norm(x, p["mlp_norm"], cfg.norm_eps)
                  for x, p in zip(xs, ps)], r.mesh)
    acts = []
    for y, p in zip(ys, ps):
        m = p["mlp"]
        if cfg.mlp_type == "gated-gelu":
            h = F.gelu(_plain_mm(y, m["wi_0"]), approximate="tanh")
            acts.append((h * _plain_mm(y, m["wi_1"])).to(y.dtype))
        else:
            acts.append(torch.relu(_plain_mm(y, m["wi"])).to(y.dtype))
    outs = row_parallel(acts, [p["mlp"]["wo"] for p in ps], r.mesh,
                        _plain_mm, True)
    return [x + o.to(x.dtype) for x, o in zip(xs, outs)]


def _embed(r: Ranks, tokens, cfg: T5Config):
    """Replicated (B, T, d_model) embeddings: each rank's slice of d_model
    gathered over tp."""
    tokens = tokens.long()
    xs = [t["embed"][tokens].to(cfg.act_dtype) for t in r.ps]
    if xs[0].shape[-1] != cfg.d_model:
        xs = cc.gather(xs, r.mesh, "tp", -1)
    return xs


def _biases(r: Ranks, key, buckets):
    return [_rel_bias(t[key], buckets) for t in r.ps]


def _encode(r: Ranks, tokens, cfg: T5Config, valid=None):
    s = tokens.shape[1]
    xs = _embed(r, tokens, cfg)
    biases = _biases(r, "enc_rel_bias", _host_buckets(
        0, s, s, True, cfg.rel_buckets, cfg.rel_max_distance).to(r.device))
    mask = None if valid is None else valid[:, None, None, :]
    for ps in r.layers("encoder"):
        ys = [rms_norm(x, p["attn_norm"], cfg.norm_eps)
              for x, p in zip(xs, ps)]
        xs = _attn_out(r, xs, [p["attn"] for p in ps], ys,
                       kv_of(r, ys, _kv_heads), biases, mask)
        xs = _mlp_out(r, xs, ps, cfg)
    return [rms_norm(x, t["enc_final_norm"], cfg.norm_eps)
            for x, t in zip(xs, r.ps)]


def _decode(r: Ranks, encs, dec_tokens, cfg: T5Config, enc_valid=None):
    t = dec_tokens.shape[1]
    xs = _embed(r, dec_tokens, cfg)
    biases = _biases(r, "dec_rel_bias", _host_buckets(
        0, t, t, False, cfg.rel_buckets, cfg.rel_max_distance).to(r.device))
    pos = torch.arange(t, device=r.device)
    causal = (pos[None, :] <= pos[:, None])[None, None]
    xmask = None if enc_valid is None else enc_valid[:, None, None, :]
    encs = [e.to(cfg.act_dtype) for e in encs]
    cross = kv_of(r, encs, _kv_heads)
    for ps in r.layers("decoder"):
        ys = [rms_norm(x, p["attn_norm"], cfg.norm_eps)
              for x, p in zip(xs, ps)]
        xs = _attn_out(r, xs, [p["attn"] for p in ps], ys,
                       kv_of(r, ys, _kv_heads), biases, causal)
        ys = [rms_norm(x, p["cross_norm"], cfg.norm_eps)
              for x, p in zip(xs, ps)]
        xs = _attn_out(r, xs, [p["cross"] for p in ps], ys, cross, None,
                       xmask)
        xs = _mlp_out(r, xs, ps, cfg)
    return [rms_norm(x, t["dec_final_norm"], cfg.norm_eps)
            for x, t in zip(xs, r.ps)]


def _head(r: Ranks, xs, cfg: T5Config):
    """fp32 logits: a tied head rescales by d_model**-0.5 and is
    row-parallel over the embedding's d_model slices; an untied lm_head
    splits the vocabulary (gathered over tp)."""
    if cfg.tied_head:
        xs = [x * torch.tensor(cfg.d_model ** -0.5, dtype=x.dtype)
              for x in xs]
        heads = [t["embed"].t() for t in r.ps]
        if heads[0].shape[0] != cfg.d_model:
            xs = cc.scatter(xs, r.mesh, "tp", -1)
        return row_parallel(xs, heads, r.mesh, _plain_mm, True)
    out = [_plain_mm(x, t["lm_head"]) for x, t in
           zip(cc.copy(xs, r.mesh), r.ps)]
    if out[0].shape[-1] != cfg.vocab_size:
        out = cc.gather(out, r.mesh, "tp", -1)
    return out


def t5_encode(params, tokens, cfg: T5Config, valid=None):
    """tokens (B, S) integers, valid (B, S) bool or None -> (B, S, d_model)
    in the activation dtype.  Padding neither attends nor is attended."""
    r = Ranks(params, cfg)
    tokens, valid = r.inputs(tokens, valid)
    return _encode(r, tokens, cfg, valid)[0]


def t5_decode(params, enc_out, dec_tokens, cfg: T5Config, enc_valid=None):
    """Teacher-forced decoder over enc_out -> (B, T, d_model) before the
    head."""
    r = Ranks(params, cfg)
    enc_out, dec_tokens, enc_valid = r.inputs(enc_out, dec_tokens,
                                             enc_valid)
    return _decode(r, [enc_out] * len(r.ps), dec_tokens, cfg, enc_valid)[0]


def t5_head(params, x, cfg: T5Config):
    """(.., d_model) -> fp32 logits (.., vocab)."""
    r = Ranks(params, cfg)
    return _head(r, [x] * len(r.ps), cfg)[0]


def _forward(r: Ranks, enc_tokens, dec_tokens, cfg, enc_valid):
    encs = _encode(r, enc_tokens, cfg, enc_valid)
    return _head(r, _decode(r, encs, dec_tokens, cfg, enc_valid), cfg)


def t5_forward(params, enc_tokens, dec_tokens, cfg: T5Config, enc_valid=None):
    """The seq2seq forward -> (B, T, vocab) fp32 logits.  `params` a tree
    or a ShardedParams (then the logits of the first held rank, which
    every rank holds)."""
    r = Ranks(params, cfg)
    enc_tokens, dec_tokens, enc_valid = r.inputs(enc_tokens, dec_tokens,
                                                enc_valid)
    return _forward(r, enc_tokens, dec_tokens, cfg, enc_valid)[0]


# -- training -----------------------------------------------------------------


def shift_right(labels, cfg: T5Config):
    """HF _shift_right: decoder inputs = [start_id, labels[:-1]], IGNORE
    positions replaced by pad."""
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_id,
                       dtype=labels.dtype, device=labels.device)
    inp = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(inp == IGNORE, torch.full_like(inp, cfg.pad_id), inp)


def t5_loss(params, enc_tokens, labels, cfg: T5Config, enc_valid=None):
    """Token-mean NLL with teacher forcing; labels == IGNORE count
    nothing."""
    r = Ranks(params, cfg)
    enc_tokens, labels, enc_valid = r.inputs(enc_tokens, labels, enc_valid)
    logits = _forward(r, enc_tokens, shift_right(labels, cfg), cfg,
                      enc_valid)[0]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return _masked_mean(nll, labels, IGNORE)


def make_t5_train_step(cfg: T5Config, oc=None, device=None):
    """step(params, opt_state, enc_tokens, labels, enc_valid=None) ->
    (params, opt_state, loss) on `device` (default: the CUDA device); the
    update is in place (models/train.py)."""
    from .train import OptConfig, make_loss_train_step

    inner = make_loss_train_step(
        lambda p, x, y: t5_loss(p, x[0], y, cfg, *x[1:]),
        oc or OptConfig(lr=1e-3), device)

    def step(params, opt_state, enc_tokens, labels, enc_valid=None):
        inputs = (enc_tokens,) if enc_valid is None else (enc_tokens,
                                                          enc_valid)
        return inner(params, opt_state, inputs, labels)

    return step


# -- generation (cached) ------------------------------------------------------


@torch.no_grad()
def t5_generate(params, enc_tokens, cfg: T5Config, max_new_tokens: int = 32,
                eos_id: int = 1, enc_valid=None):
    """Greedy generation: the encoder and each layer's cross-attention K/V
    once, then a host loop of single-token decode steps over a
    self-attention cache.  Returns (B, max_new_tokens) int32; positions
    after a sequence's EOS hold pad_id."""
    r = Ranks(params, cfg)
    enc_tokens, enc_valid = r.inputs(enc_tokens, enc_valid)
    b = enc_tokens.shape[0]
    max_len = max_new_tokens + 1
    cross = fixed_kv(r, _encode(r, enc_tokens, cfg, enc_valid), _kv_heads)
    xmask = None if enc_valid is None else enc_valid[:, None, None, :]
    caches = new_caches(r, b, max_len, cfg.d_kv, cfg.act_dtype)
    buckets = _host_buckets(0, max_len, max_len, False, cfg.rel_buckets,
                            cfg.rel_max_distance).to(r.device)
    tok = torch.full((b,), cfg.decoder_start_id, dtype=torch.int32,
                     device=r.device)
    done = torch.zeros((b,), dtype=torch.bool, device=r.device)
    out = []
    for pos in range(max_new_tokens):
        xs = _embed(r, tok[:, None], cfg)
        biases = _biases(r, "dec_rel_bias", buckets[pos:pos + 1, :pos + 1])
        for li, ps in enumerate(r.layers("decoder")):
            ys = [rms_norm(x, p["attn_norm"], cfg.norm_eps)
                  for x, p in zip(xs, ps)]
            xs = _attn_out(r, xs, [p["attn"] for p in ps], ys,
                           cached_kv(r, ys, caches, li, pos, _kv_heads),
                           biases)
            ys = [rms_norm(x, p["cross_norm"], cfg.norm_eps)
                  for x, p in zip(xs, ps)]
            xs = _attn_out(r, xs, [p["cross"] for p in ps], ys, cross[li],
                           None, xmask)
            xs = _mlp_out(r, xs, ps, cfg)
        hs = [rms_norm(x, t["dec_final_norm"], cfg.norm_eps)
              for x, t in zip(xs, r.ps)]
        logits = _head(r, [h[:, 0] for h in hs], cfg)[0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(done, torch.full_like(nxt, cfg.pad_id), nxt)
        done = done | (nxt == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)


# -- HuggingFace interop (T5ForConditionalGeneration) -------------------------


def config_from_hf_t5(hf_config, dtype: str = "bfloat16") -> T5Config:
    """A transformers T5Config (or config.json's dict) as a T5Config;
    feed_forward_proj "relu" or "gated-gelu"."""
    g = (hf_config.get if isinstance(hf_config, dict)
         else lambda k, d=None: getattr(hf_config, k, d))
    proj = g("feed_forward_proj", "relu")
    if proj not in ("relu", "gated-gelu"):
        raise NotImplementedError(f"feed_forward_proj={proj!r}")
    return T5Config(
        vocab_size=g("vocab_size"), d_model=g("d_model"),
        n_heads=g("num_heads"), d_kv=g("d_kv"), d_ff=g("d_ff"),
        n_enc_layers=g("num_layers"),
        n_dec_layers=g("num_decoder_layers") or g("num_layers"),
        dtype=dtype, norm_eps=g("layer_norm_epsilon", 1e-6),
        rel_buckets=g("relative_attention_num_buckets", 32),
        rel_max_distance=g("relative_attention_max_distance", 128),
        mlp_type=proj, tied_head=bool(g("tie_word_embeddings", True)),
        decoder_start_id=g("decoder_start_token_id", 0) or 0,
        pad_id=g("pad_token_id", 0) or 0)


_EMBED_KEYS = ("shared.weight", "encoder.embed_tokens.weight",
               "decoder.embed_tokens.weight")


def params_from_hf_t5(state_dict, cfg: T5Config, device=None):
    """A T5ForConditionalGeneration state dict -> params, fp32 on `device`
    (default: the CUDA device).  The embedding is shared.weight (or a tied
    copy where a file keeps only that); the bias tables live on block 0's
    self-attention; every Linear transposes (out, in) -> (in, out)."""
    r = _Reader(state_dict, resolve_device(device))
    A, W = r.A, r.W

    def attn(prefix):
        return {ours: W(f"{prefix}.{theirs}.weight") for ours, theirs in
                (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))}

    def mlp(prefix):
        names = (("wi_0", "wi_1", "wo") if cfg.mlp_type == "gated-gelu"
                 else ("wi", "wo"))
        return {n: W(f"{prefix}.{n}.weight") for n in names}

    rel = "layer.0.SelfAttention.relative_attention_bias.weight"
    params = {
        "embed": A(next(k for k in _EMBED_KEYS if k in r)),
        "enc_rel_bias": A(f"encoder.block.0.{rel}"),
        "dec_rel_bias": A(f"decoder.block.0.{rel}"),
        "enc_final_norm": A("encoder.final_layer_norm.weight"),
        "dec_final_norm": A("decoder.final_layer_norm.weight"),
        "encoder": [], "decoder": [],
    }
    if not cfg.tied_head:
        params["lm_head"] = W("lm_head.weight")
    for i in range(cfg.n_enc_layers):
        b = f"encoder.block.{i}.layer"
        params["encoder"].append({
            "attn_norm": A(f"{b}.0.layer_norm.weight"),
            "attn": attn(f"{b}.0.SelfAttention"),
            "mlp_norm": A(f"{b}.1.layer_norm.weight"),
            "mlp": mlp(f"{b}.1.DenseReluDense")})
    for i in range(cfg.n_dec_layers):
        b = f"decoder.block.{i}.layer"
        params["decoder"].append({
            "attn_norm": A(f"{b}.0.layer_norm.weight"),
            "attn": attn(f"{b}.0.SelfAttention"),
            "cross_norm": A(f"{b}.1.layer_norm.weight"),
            "cross": attn(f"{b}.1.EncDecAttention"),
            "mlp_norm": A(f"{b}.2.layer_norm.weight"),
            "mlp": mlp(f"{b}.2.DenseReluDense")})
    return params


def from_hf_t5(model_or_path, dtype: str = "bfloat16", device=None):
    """(params, cfg) from a checkpoint directory (read without
    transformers: config.json over hf.FAMILY_CONFIG_DEFAULTS["t5"], then
    the weights) or a transformers T5ForConditionalGeneration; fp32 params
    on `device` (default: the CUDA device)."""
    if is_checkpoint_path(model_or_path):
        hc, sd = read_hf_dir(model_or_path)
    else:
        hc, sd = model_or_path.config, model_or_path.state_dict()
    cfg = config_from_hf_t5(hc, dtype=dtype)
    return params_from_hf_t5(sd, cfg, device), cfg


def to_hf_t5(params, cfg: T5Config) -> dict:
    """params -> a T5ForConditionalGeneration state dict of fp32 numpy
    arrays (HF names and (out, in) orientation), for export."""

    def a(t):
        return t.detach().float().cpu().numpy()

    sd = {"shared.weight": a(params["embed"])}
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    sd["decoder.embed_tokens.weight"] = sd["shared.weight"]
    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    sd[f"encoder.{rel}"] = a(params["enc_rel_bias"])
    sd[f"decoder.{rel}"] = a(params["dec_rel_bias"])
    sd["encoder.final_layer_norm.weight"] = a(params["enc_final_norm"])
    sd["decoder.final_layer_norm.weight"] = a(params["dec_final_norm"])
    if not cfg.tied_head:
        sd["lm_head.weight"] = a(params["lm_head"]).T

    def put_attn(prefix, at):
        for ours, theirs in (("wq", "q"), ("wk", "k"), ("wv", "v"),
                             ("wo", "o")):
            sd[f"{prefix}.{theirs}.weight"] = a(at[ours]).T

    def put_mlp(prefix, m):
        for k in m:
            sd[f"{prefix}.{k}.weight"] = a(m[k]).T

    for i, p in enumerate(params["encoder"]):
        b = f"encoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = a(p["attn_norm"])
        put_attn(f"{b}.0.SelfAttention", p["attn"])
        sd[f"{b}.1.layer_norm.weight"] = a(p["mlp_norm"])
        put_mlp(f"{b}.1.DenseReluDense", p["mlp"])
    for i, p in enumerate(params["decoder"]):
        b = f"decoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = a(p["attn_norm"])
        put_attn(f"{b}.0.SelfAttention", p["attn"])
        sd[f"{b}.1.layer_norm.weight"] = a(p["cross_norm"])
        put_attn(f"{b}.1.EncDecAttention", p["cross"])
        sd[f"{b}.2.layer_norm.weight"] = a(p["mlp_norm"])
        put_mlp(f"{b}.2.DenseReluDense", p["mlp"])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


# -- mesh parallelism (dp x tp) -----------------------------------------------


def t5_param_specs(params, cfg: T5Config) -> dict:
    """The JAX specs: q / k / v column-parallel (heads over tp), o
    row-parallel, the MLP's wi* column / wo row, the bias tables over their
    head axis, the embedding and an untied head over their last axis,
    norms replicated."""

    def attn():
        return {"wq": P(None, "tp"), "wk": P(None, "tp"),
                "wv": P(None, "tp"), "wo": P("tp", None)}

    def mlp():
        if cfg.mlp_type == "gated-gelu":
            return {"wi_0": P(None, "tp"), "wi_1": P(None, "tp"),
                    "wo": P("tp", None)}
        return {"wi": P(None, "tp"), "wo": P("tp", None)}

    out = {
        "embed": P(None, "tp"),
        "enc_rel_bias": P(None, "tp"), "dec_rel_bias": P(None, "tp"),
        "enc_final_norm": P(), "dec_final_norm": P(),
        "encoder": [{"attn_norm": P(), "attn": attn(), "mlp_norm": P(),
                     "mlp": mlp()} for _ in params["encoder"]],
        "decoder": [{"attn_norm": P(), "attn": attn(), "cross_norm": P(),
                     "cross": attn(), "mlp_norm": P(), "mlp": mlp()}
                    for _ in params["decoder"]],
    }
    if "lm_head" in params:
        out["lm_head"] = P(None, "tp")
    return out


def shard_t5_params(params, mesh, cfg: T5Config) -> ShardedParams:
    """What each held rank of a (dp, tp) mesh holds under t5_param_specs:
    whole heads a rank (tp must divide n_heads).  Every function of this
    module takes the result in place of params."""
    mesh = as_mesh(mesh)
    if cfg.n_heads % mesh.tp:
        raise ValueError(f"tp {mesh.tp} does not divide the {cfg.n_heads} "
                         f"heads")
    return shard_tree(params, t5_param_specs(params, cfg), mesh, cfg)
