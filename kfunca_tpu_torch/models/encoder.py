"""Bidirectional text encoder: masked-LM pretraining and sentence embeddings.

Counterpart of kfunca_tpu/models/encoder.py, with its parameter layout
(models/weights.encoder_params_from_jax carries a JAX pytree across) and
its two architectures:

  * "preln": vision._encoder_block (RMSNorm -> bidirectional fp32 attention
    -> SwiGLU) with a (B, S) validity mask over learned positions, the MLM
    head the tied embedding streamed through the chunked-vocab
    cross-entropy (models/loss.py: no (B, S, V) logits), mean-pooled
    unit-norm sentence embeddings;
  * "bert": the original post-norm BERT stack (word + position +
    token-type embeddings through a LayerNorm, LayerNorm after each
    residual add, biased projections, exact GELU), the layout HF BERT
    checkpoints import into (`from_hf_bert`).

`mlm_corrupt` draws the 80/10/10 corruption from a torch.Generator, where
the JAX function draws from a jax.random key: the same laws, other
numbers, so the two agree in distribution only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device
from .hf import _Reader, is_checkpoint_path, read_hf_dir
from .loss import chunked_softmax_xent
from .transformer import _DTYPES, _plain_mm, layer_norm, rms_norm
from .vision import (_encoder_block, encoder_attention, encoder_block_params,
                     merge_heads, split_heads)

IGNORE = -100


@dataclass(frozen=True)
class EncoderConfig:
    """The JAX package's EncoderConfig, field for field."""

    vocab_size: int = 1024
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    max_seq_len: int = 128
    dtype: str = "bfloat16"
    mask_token: int = 1  # the [MASK] id
    arch: str = "preln"  # "preln" or "bert"
    type_vocab: int = 0  # token-type vocabulary (BERT: 2)
    norm_eps: float = 1e-12  # LayerNorm eps of arch="bert"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def init_encoder_params(seed: int, cfg: EncoderConfig, device=None,
                        dtype=torch.float32):
    """Random params of cfg.arch with the JAX laws (preln: embedding
    N(0, 0.02^2), positions N(0, 0.01^2), the blocks as vision's), drawn
    from a torch.Generator seeded with `seed` on `device` (default: the
    CUDA device)."""
    if cfg.arch == "bert":
        return init_bert_params(seed, cfg, device, dtype)
    if cfg.arch != "preln":
        raise ValueError(f"unknown encoder arch {cfg.arch!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    return {
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02),
        "pos_embed": normal((cfg.max_seq_len, cfg.d_model), 0.01),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "blocks": [encoder_block_params(gen, cfg.d_model, cfg.d_ff, dtype)
                   for _ in range(cfg.n_layers)],
    }


def encode(params, tokens, cfg: EncoderConfig, valid=None, token_type=None):
    """tokens (B, S) integers, valid (B, S) bool or None -> (B, S, d_model).
    Padding (valid False) positions are no key of any attention.
    `token_type` (B, S) segment ids apply to arch="bert" only."""
    if cfg.arch == "bert":
        return bert_encode(params, tokens, cfg, valid, token_type)
    s = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cfg.act_dtype)
    x = x + params["pos_embed"][:s].to(cfg.act_dtype)
    for p in params["blocks"]:
        x = _encoder_block(x, p, cfg, mask=valid)
    return rms_norm(x, params["final_norm"])


def embed_pooled(params, tokens, cfg: EncoderConfig, valid=None):
    """Mean-pooled unit-norm sentence embeddings (B, d_model) fp32, padding
    left out of the mean."""
    x = encode(params, tokens, cfg, valid).float()
    if valid is None:
        pooled = x.mean(dim=1)
    else:
        w = valid.float()[..., None]
        pooled = (x * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(
        pooled, dim=-1, keepdim=True).clamp_min(1e-8)


def mlm_corrupt(gen, tokens, cfg: EncoderConfig, mask_prob: float = 0.15):
    """BERT 80/10/10 corruption drawn from the torch.Generator `gen` (on
    tokens' device).  Returns (inputs, targets): targets hold the original
    token at selected positions and IGNORE elsewhere; inputs replace a
    selected position with [MASK] (80%), a random token (10%) or keep it
    (10%)."""
    dev = tokens.device
    sel = torch.rand(tokens.shape, generator=gen, device=dev) < mask_prob
    targets = torch.where(sel, tokens, torch.full_like(tokens, IGNORE))
    u = torch.rand(tokens.shape, generator=gen, device=dev)
    rand_tok = torch.randint(0, cfg.vocab_size, tokens.shape, generator=gen,
                             device=dev, dtype=tokens.dtype)
    inputs = torch.where(
        sel & (u < 0.8), torch.full_like(tokens, cfg.mask_token),
        torch.where(sel & (u >= 0.9), rand_tok, tokens))
    return inputs, targets


def mlm_loss(params, inputs, targets, cfg: EncoderConfig, valid=None,
             vocab_chunk: int = 1024):
    """Mean NLL over the target != IGNORE positions; the tied embedding
    head streamed in vocab chunks."""
    x = encode(params, inputs, cfg, valid)
    d = x.shape[-1]
    flat_t = targets.reshape(-1).long()
    mask = (flat_t != IGNORE).float()
    safe = torch.where(flat_t == IGNORE, torch.zeros_like(flat_t), flat_t)
    nll = chunked_softmax_xent(x.reshape(-1, d), params["embed"].t(), safe,
                               vocab_chunk)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def make_mlm_train_step(cfg: EncoderConfig, oc=None, mask_prob: float = 0.15,
                        vocab_chunk: int = 1024, device=None):
    """step(params, opt_state, gen, tokens, valid=None) -> (params,
    opt_state, loss) on `device` (default: the CUDA device): the corruption
    is drawn from the torch.Generator `gen` inside the step; the update is
    in place (models/train.py)."""
    from .train import (OptConfig, apply_update, check_params_device,
                        value_and_grad_aux)

    dev = resolve_device(device)
    oc = oc or OptConfig(lr=3e-4, weight_decay=0.01)

    def step(params, opt_state, gen, tokens, valid=None):
        check_params_device(params, dev)
        tokens = torch.as_tensor(tokens).to(dev)
        valid = None if valid is None else torch.as_tensor(valid).to(dev)
        inputs, targets = mlm_corrupt(gen, tokens, cfg, mask_prob)
        loss, _, grads = value_and_grad_aux(
            lambda p: (mlm_loss(p, inputs, targets, cfg, valid, vocab_chunk),
                       None), params)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, loss

    return step


# -- the BERT architecture and its HF import -----------------------------------


def _bert_block(x, p, cfg: EncoderConfig, mask=None):
    """Post-norm BERT block.  `mask` (B, S) bool marks the valid keys."""
    qkv = (_plain_mm(x, p["wqkv"]) + p["bqkv"].float()).to(x.dtype)
    attn = encoder_attention(*split_heads(qkv, cfg.n_heads), mask)
    attn = merge_heads(attn.to(x.dtype))
    o = _plain_mm(attn, p["wo"]) + p["bo"].float()
    x = layer_norm(x + o.to(x.dtype), p["attn_norm"], p["attn_norm_b"],
                   cfg.norm_eps)
    hdn = _plain_mm(x, p["w_fc"]) + p["b_fc"].float()
    act = F.gelu(hdn, approximate="none").to(x.dtype)  # erf GELU
    out = _plain_mm(act, p["w_proj"]) + p["b_proj"].float()
    return layer_norm(x + out.to(x.dtype), p["mlp_norm"], p["mlp_norm_b"],
                      cfg.norm_eps)


def bert_encode(params, tokens, cfg: EncoderConfig, valid=None,
                token_type=None):
    """tokens (B, S) -> the last hidden states (B, S, d), HF
    BertModel.last_hidden_state; token_type defaults to segment 0."""
    s = tokens.shape[1]
    tokens = tokens.long()
    x = params["embed"][tokens].float() + params["pos_embed"][:s].float()
    if cfg.type_vocab:
        tt = (torch.zeros_like(tokens) if token_type is None
              else token_type.long())
        x = x + params["type_embed"][tt].float()
    x = layer_norm(x, params["embed_norm"], params["embed_norm_b"],
                   cfg.norm_eps).to(cfg.act_dtype)
    for p in params["blocks"]:
        x = _bert_block(x, p, cfg, mask=valid)
    return x


def bert_pooled(params, tokens, cfg: EncoderConfig, valid=None,
                token_type=None):
    """HF BertModel.pooler_output: tanh(dense([CLS] hidden)), fp32."""
    x = bert_encode(params, tokens, cfg, valid, token_type)
    cls = x[:, 0].float()
    return torch.tanh(cls @ params["pooler_w"].float()
                      + params["pooler_b"].float())


def init_bert_params(seed: int, cfg: EncoderConfig, device=None,
                     dtype=torch.float32):
    """Random params of arch="bert" (HF initializer_range 0.02: matrices
    N(0, 0.02^2), biases 0, LayerNorm gains 1), drawn from a
    torch.Generator seeded with `seed` on `device` (default: the CUDA
    device)."""
    if cfg.arch != "bert":
        raise ValueError(f"init_bert_params needs arch='bert', not "
                         f"{cfg.arch!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff

    def n(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def full(k, value):
        return torch.full((k,), value, dtype=dtype, device=dev)

    params = {"embed": n(cfg.vocab_size, d), "pos_embed": n(cfg.max_seq_len, d),
              "embed_norm": full(d, 1.0), "embed_norm_b": full(d, 0.0),
              "pooler_w": n(d, d), "pooler_b": full(d, 0.0), "blocks": []}
    if cfg.type_vocab:
        params["type_embed"] = n(cfg.type_vocab, d)
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "wqkv": n(d, 3 * d), "bqkv": full(3 * d, 0.0),
            "wo": n(d, d), "bo": full(d, 0.0),
            "attn_norm": full(d, 1.0), "attn_norm_b": full(d, 0.0),
            "w_fc": n(d, f), "b_fc": full(f, 0.0),
            "w_proj": n(f, d), "b_proj": full(d, 0.0),
            "mlp_norm": full(d, 1.0), "mlp_norm_b": full(d, 0.0),
        })
    return params


def strip_prefix(sd: dict, prefix: str) -> dict:
    """A task model's state dict (keys under `prefix`, as BertForMaskedLM's
    under "bert.") as its base model's; a base model's as it is."""
    if not any(k.startswith(prefix) for k in sd):
        return sd
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def from_hf_bert(model_or_path, dtype: str = "float32", device=None):
    """(params, cfg) from a checkpoint directory (read without
    transformers) or a transformers BertModel (or a wrapper exposing
    .bert), fp32 on `device` (default: the CUDA device).  HF keys:
    embeddings.{word,position,token_type}_embeddings + LayerNorm,
    encoder.layer.N.attention.self.{query,key,value} /
    attention.output.dense + LayerNorm / intermediate.dense / output.dense +
    LayerNorm, pooler.dense."""
    dev = resolve_device(device)
    if is_checkpoint_path(model_or_path):
        hc, sd = read_hf_dir(model_or_path)
    else:
        hf = getattr(model_or_path, "bert", model_or_path)
        hc, sd = hf.config.to_dict(), hf.state_dict()
    sd = strip_prefix(sd, "bert.")
    act = hc.get("hidden_act", "gelu")
    if act != "gelu":
        raise NotImplementedError(f"BERT activation {act!r} (erf gelu only)")
    cfg = EncoderConfig(
        vocab_size=hc["vocab_size"], d_model=hc["hidden_size"],
        n_heads=hc["num_attention_heads"], n_layers=hc["num_hidden_layers"],
        d_ff=hc["intermediate_size"], max_seq_len=hc["max_position_embeddings"],
        dtype=dtype, arch="bert", type_vocab=hc["type_vocab_size"],
        norm_eps=float(hc["layer_norm_eps"]))

    r = _Reader(sd, dev)  # fp32 on dev; W transposes HF (out, in)
    A, W = r.A, r.W
    params = {
        "embed": A("embeddings.word_embeddings.weight"),
        "pos_embed": A("embeddings.position_embeddings.weight"),
        "type_embed": A("embeddings.token_type_embeddings.weight"),
        "embed_norm": A("embeddings.LayerNorm.weight"),
        "embed_norm_b": A("embeddings.LayerNorm.bias"),
        "blocks": [],
    }
    if "pooler.dense.weight" in sd:
        params["pooler_w"] = W("pooler.dense.weight")
        params["pooler_b"] = A("pooler.dense.bias")
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        qkv = [p + f"attention.self.{n}" for n in ("query", "key", "value")]
        params["blocks"].append({
            "wqkv": torch.cat([W(n + ".weight") for n in qkv], dim=1),
            "bqkv": torch.cat([A(n + ".bias") for n in qkv]),
            "wo": W(p + "attention.output.dense.weight"),
            "bo": A(p + "attention.output.dense.bias"),
            "attn_norm": A(p + "attention.output.LayerNorm.weight"),
            "attn_norm_b": A(p + "attention.output.LayerNorm.bias"),
            "w_fc": W(p + "intermediate.dense.weight"),
            "b_fc": A(p + "intermediate.dense.bias"),
            "w_proj": W(p + "output.dense.weight"),
            "b_proj": A(p + "output.dense.bias"),
            "mlp_norm": A(p + "output.LayerNorm.weight"),
            "mlp_norm_b": A(p + "output.LayerNorm.bias"),
        })
    return params, cfg
