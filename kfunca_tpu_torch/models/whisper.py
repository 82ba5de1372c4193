"""Whisper-family speech-to-text: a mel encoder-decoder with cached
generation, HF interop and a tensor-parallel form.

Counterpart of kfunca_tpu/models/whisper.py, with its parameter layout
(models/weights.whisper_params_from_jax carries a JAX pytree across): two
temporal convolutions (the second of stride 2) over the mel spectrogram,
sinusoidal encoder positions, a pre-LayerNorm encoder, and a causal text
decoder with learned positions, cross-attention over the encoder output
and the tied head.  What HF parity forces, as in the JAX module: biased
q / v / out projections and a bias-free k, q scaled by head_dim**-0.5 in
fp32 before the cast, exact (erf) GELU.

The convolutions follow the JAX numerics: 16-bit operands, fp32
accumulation and an fp32 result, then the fp32 bias and GELU, then the
cast.  A 16-bit F.conv1d would round its output to 16 bits first, so the
conv runs in fp32 on the operands rounded to the activation dtype (their
products are exact in fp32).  Attention is an fp32 einsum, as in the JAX
package: no kernel of the port serves it.

Generation mirrors models/t5.py: the encoder and each layer's
cross-attention K/V once, a forced prompt fed token by token, then a host
loop of single-token decode steps over a self-attention cache written in
place.  The forward, the loss and generation run over the held ranks of
a mesh (models/seq2seq.Ranks, as t5.py's do; a plain tree is one rank):
under
shard_whisper_params each rank holds its heads (q / k / v and their
biases column-parallel, out row-parallel), its columns of fc1 and rows of
fc2, conv1's output channels and conv2's input channels (one all-reduce
before conv2's bias), its slice of d_model of the embedding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..parallel import collectives as cc
from ..parallel.mesh import P, ShardedParams, as_mesh, shard_tree
from ..runtime.backend import resolve_device
from .hf import _Reader, is_checkpoint_path, read_hf_dir
from .mamba import _linear
from .seq2seq import (Ranks, attend, cached_kv, fixed_kv, kv_of, merge_heads,
                      new_caches, split_heads)
from .transformer import (_DTYPES, _masked_mean, _plain_mm, layer_norm,
                          row_parallel)

IGNORE = -100


@dataclass(frozen=True)
class WhisperConfig:
    """The JAX package's WhisperConfig, field for field."""

    vocab_size: int = 512
    n_mels: int = 80
    d_model: int = 256
    n_heads: int = 4
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    d_ff: int = 1024
    max_source_positions: int = 1500  # frames after the stride-2 conv
    max_target_positions: int = 448
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    decoder_start_id: int = 0
    eos_id: int = 1

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        """Every head has keys and values of its own (parallel.mesh's
        whole-head rule)."""
        return self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's encoder position table (sin and cos halves over
    log-spaced frequencies), fp32 on `device` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        dim // 2, dtype=torch.float32, device=dev))
    ang = torch.arange(length, dtype=torch.float32, device=dev)[:, None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init_whisper_params(seed: int, cfg: WhisperConfig, device=None,
                        dtype=torch.float32):
    """Random params with the JAX laws (convs N(0, 1 / (3 Cin)), embedding
    and decoder positions N(0, 0.02^2), matrices U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), biases 0, norms 1, the sinusoid table), drawn from a
    torch.Generator seeded with `seed` on `device` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    def attn():
        return {"wq": _linear(gen, d, d, dtype), "bq": full(d, 0.0),
                "wk": _linear(gen, d, d, dtype),
                "wv": _linear(gen, d, d, dtype), "bv": full(d, 0.0),
                "wo": _linear(gen, d, d, dtype), "bo": full(d, 0.0)}

    def block(cross):
        blk = {"attn": attn(), "mlp": {
            "fc1": _linear(gen, d, f, dtype), "fc1_b": full(f, 0.0),
            "fc2": _linear(gen, f, d, dtype), "fc2_b": full(d, 0.0)}}
        for name in ("attn_norm", "mlp_norm") + (("cross_norm",) if cross
                                                 else ()):
            blk[name], blk[name + "_b"] = full(d, 1.0), full(d, 0.0)
        if cross:
            blk["cross"] = attn()
        return blk

    params = {
        "conv1_w": normal((3, cfg.n_mels, d), 1 / math.sqrt(3 * cfg.n_mels)),
        "conv1_b": full(d, 0.0),
        "conv2_w": normal((3, d, d), 1 / math.sqrt(3 * d)),
        "conv2_b": full(d, 0.0),
        "enc_pos": sinusoidal_positions(cfg.max_source_positions, d,
                                        dev).to(dtype),
        "embed": normal((cfg.vocab_size, d), 0.02),
        "dec_pos": normal((cfg.max_target_positions, d), 0.02),
        "enc_final_norm": full(d, 1.0), "enc_final_norm_b": full(d, 0.0),
        "dec_final_norm": full(d, 1.0), "dec_final_norm_b": full(d, 0.0),
        "encoder": [block(False) for _ in range(cfg.n_enc_layers)],
        "decoder": [block(True) for _ in range(cfg.n_dec_layers)],
    }
    return params


# -- the blocks, over the held ranks ------------------------------------------


def _proj(y, a, name):
    """y @ w (+ its bias where it has one), fp32."""
    out = _plain_mm(y, a["w" + name])
    if "b" + name in a:
        out = out + a["b" + name].float()
    return out


def _kv_heads(y, a, cfg):
    return (split_heads(_proj(y, a, "k").to(y.dtype), cfg),
            split_heads(_proj(y, a, "v").to(y.dtype), cfg))


def _attn_out(r: Ranks, xs, attns, q_ins, kv, mask=None):
    """x + out(attend(...)) over the held ranks; kv(i, a) rank i's (k, v);
    out row-parallel (one all-reduce), its bias added once after it."""
    scale = r.cfg.head_dim ** -0.5
    q_ins = cc.copy(q_ins, r.mesh)
    heads = []
    for i, (x, a, q_in) in enumerate(zip(xs, attns, q_ins)):
        q = split_heads((_proj(q_in, a, "q") * scale).to(q_in.dtype), r.lcfg)
        heads.append(merge_heads(attend(q, *kv(i, a), None, mask).to(x.dtype)))
    outs = row_parallel(heads, [a["wo"] for a in attns], r.mesh, _plain_mm,
                        True)
    return [x + (o + a["bo"].float()).to(x.dtype)
            for x, o, a in zip(xs, outs, attns)]


def _mlp_out(r: Ranks, xs, ps, cfg: WhisperConfig):
    ys = cc.copy([layer_norm(x, p["mlp_norm"], p["mlp_norm_b"], cfg.norm_eps)
                  for x, p in zip(xs, ps)], r.mesh)
    acts = [F.gelu(_plain_mm(y, p["mlp"]["fc1"]) + p["mlp"]["fc1_b"].float(),
                   approximate="none").to(y.dtype) for y, p in zip(ys, ps)]
    outs = row_parallel(acts, [p["mlp"]["fc2"] for p in ps], r.mesh,
                        _plain_mm, True)
    return [x + (o + p["mlp"]["fc2_b"].float()).to(x.dtype)
            for x, o, p in zip(xs, outs, ps)]


def _norm(xs, ps, name, cfg: WhisperConfig):
    return [layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)
            for x, p in zip(xs, ps)]


def _conv1d(x, w, stride: int):
    """x (B, T, Cin), w (k, Cin, Cout), padding 1 -> (B, T', Cout) fp32:
    the operands rounded to x's dtype, multiplied and summed in fp32 (the
    JAX conv's preferred_element_type), before any bias."""
    out = F.conv1d(x.float().transpose(1, 2),
                   w.to(x.dtype).float().permute(2, 1, 0), stride=stride,
                   padding=1)
    return out.transpose(1, 2)


def _encode(r: Ranks, features, cfg: WhisperConfig):
    x = features.transpose(1, 2).to(cfg.act_dtype)  # (B, T, mels)
    xs = cc.copy([x] * len(r.ps), r.mesh)
    hs = [F.gelu(_conv1d(x, t["conv1_w"], 1) + t["conv1_b"].float(),
                 approximate="none").to(cfg.act_dtype)
          for x, t in zip(xs, r.ps)]
    parts = [_conv1d(h, t["conv2_w"], 2) for h, t in zip(hs, r.ps)]
    if r.ps[0]["conv2_w"].shape[1] != cfg.d_model:  # input channels split
        parts = cc.reduce(parts, r.mesh)
    xs = [F.gelu(p + t["conv2_b"].float(), approximate="none").to(
        cfg.act_dtype) for p, t in zip(parts, r.ps)]
    xs = [x + t["enc_pos"][: x.shape[1]].to(x.dtype) for x, t in zip(xs, r.ps)]
    for ps in r.layers("encoder"):
        ys = _norm(xs, ps, "attn_norm", cfg)
        xs = _attn_out(r, xs, [p["attn"] for p in ps], ys,
                       kv_of(r, ys, _kv_heads))
        xs = _mlp_out(r, xs, ps, cfg)
    return _norm(xs, r.ps, "enc_final_norm", cfg)


def _embed(r: Ranks, tokens, positions, cfg: WhisperConfig):
    """Token embeddings (each rank's slice of d_model gathered over tp)
    plus the learned positions at `positions`."""
    tokens = tokens.long()
    xs = [t["embed"][tokens].to(cfg.act_dtype) for t in r.ps]
    if xs[0].shape[-1] != cfg.d_model:
        xs = cc.gather(xs, r.mesh, "tp", -1)
    return [x + t["dec_pos"][positions].to(x.dtype) for x, t in zip(xs, r.ps)]


def _decode(r: Ranks, encs, tokens, cfg: WhisperConfig):
    t = tokens.shape[1]
    pos = torch.arange(t, device=r.device)
    xs = _embed(r, tokens, pos, cfg)
    causal = (pos[None, :] <= pos[:, None])[None, None]
    cross = kv_of(r, [e.to(cfg.act_dtype) for e in encs], _kv_heads)
    for ps in r.layers("decoder"):
        ys = _norm(xs, ps, "attn_norm", cfg)
        xs = _attn_out(r, xs, [p["attn"] for p in ps], ys,
                       kv_of(r, ys, _kv_heads), causal)
        ys = _norm(xs, ps, "cross_norm", cfg)
        xs = _attn_out(r, xs, [p["cross"] for p in ps], ys, cross)
        xs = _mlp_out(r, xs, ps, cfg)
    return _norm(xs, r.ps, "dec_final_norm", cfg)


def _head(r: Ranks, xs):
    """The tied head's fp32 logits: row-parallel over the embedding's
    d_model slices."""
    heads = [t["embed"].t() for t in r.ps]
    if heads[0].shape[0] != xs[0].shape[-1]:
        xs = cc.scatter(xs, r.mesh, "tp", -1)
    return row_parallel(xs, heads, r.mesh, _plain_mm, True)


def whisper_encode(params, features, cfg: WhisperConfig):
    """features (B, n_mels, T) mel spectrogram (HF input_features) ->
    (B, T // 2, d_model) in the activation dtype."""
    r = Ranks(params, cfg)
    return _encode(r, r.tensor(features), cfg)[0]


def whisper_decode(params, enc_out, tokens, cfg: WhisperConfig):
    """Teacher-forced decoder -> (B, T, d_model) before the tied head."""
    r = Ranks(params, cfg)
    enc_out, tokens = r.inputs(enc_out, tokens)
    return _decode(r, [enc_out] * len(r.ps), tokens, cfg)[0]


def _forward(r: Ranks, features, tokens, cfg):
    return _head(r, _decode(r, _encode(r, features, cfg), tokens, cfg))


def whisper_forward(params, features, tokens, cfg: WhisperConfig):
    """(B, n_mels, T) x (B, Td) -> (B, Td, vocab) fp32 logits.  `params` a
    tree or a ShardedParams (then the first held rank's logits, which
    every rank holds)."""
    r = Ranks(params, cfg)
    return _forward(r, r.tensor(features), r.tensor(tokens), cfg)[0]


def whisper_loss(params, features, labels, cfg: WhisperConfig):
    """Teacher forcing: inputs [start, labels[:-1]] (IGNORE fed as 0);
    labels == IGNORE count nothing."""
    r = Ranks(params, cfg)
    features, labels = r.inputs(features, labels)
    labels = labels.long()
    start = torch.full((labels.shape[0], 1), cfg.decoder_start_id,
                       dtype=labels.dtype, device=labels.device)
    inp = torch.cat([start, labels[:, :-1]], dim=1)
    inp = torch.where(inp == IGNORE, torch.zeros_like(inp), inp)
    logits = _forward(r, features, inp, cfg)[0]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return _masked_mean(nll, labels, IGNORE)


def make_whisper_train_step(cfg: WhisperConfig, oc=None, device=None):
    """step(params, opt_state, features, labels) -> (params, opt_state,
    loss) on `device` (default: the CUDA device); the update is in place
    (models/train.py)."""
    from .train import OptConfig, make_loss_train_step

    return make_loss_train_step(
        lambda p, x, y: whisper_loss(p, x, y, cfg), oc or OptConfig(lr=1e-3),
        device)


# -- cached generation --------------------------------------------------------


@torch.no_grad()
def whisper_generate(params, features, cfg: WhisperConfig,
                     max_new_tokens: int = 32, prompt=None):
    """Greedy transcription: the encoder and each layer's cross-attention
    K/V once, `prompt` (B, P) forced after the start token (the task and
    language prefix), then max_new_tokens single-token decode steps over a
    self-attention cache.  Returns (B, max_new_tokens) int32; positions
    after a sequence's EOS hold eos_id."""
    r = Ranks(params, cfg)
    features, prompt = r.inputs(features, prompt)
    b = features.shape[0]
    p_len = 0 if prompt is None else prompt.shape[1]
    max_len = p_len + max_new_tokens + 1
    cross = fixed_kv(r, _encode(r, features, cfg), _kv_heads)
    caches = new_caches(r, b, max_len, cfg.head_dim, cfg.act_dtype)

    def decode_one(tok, pos: int):
        """One token a row at `pos` -> fp32 logits (B, vocab)."""
        xs = _embed(r, tok[:, None], torch.tensor([pos], device=r.device),
                    cfg)
        for li, ps in enumerate(r.layers("decoder")):
            ys = _norm(xs, ps, "attn_norm", cfg)
            xs = _attn_out(r, xs, [p["attn"] for p in ps], ys,
                           cached_kv(r, ys, caches, li, pos, _kv_heads))
            ys = _norm(xs, ps, "cross_norm", cfg)
            xs = _attn_out(r, xs, [p["cross"] for p in ps], ys, cross[li])
            xs = _mlp_out(r, xs, ps, cfg)
        hs = _norm(xs, r.ps, "dec_final_norm", cfg)
        return _head(r, [h[:, 0] for h in hs])[0]

    tok = torch.full((b,), cfg.decoder_start_id, dtype=torch.int32,
                     device=r.device)
    for i in range(p_len):  # the forced prompt: its logits are not read
        decode_one(tok, i)
        tok = prompt[:, i].to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=r.device)
    out = []
    for i in range(max_new_tokens):
        nxt = torch.argmax(decode_one(tok, p_len + i), dim=-1).to(torch.int32)
        tok = torch.where(done, torch.full_like(nxt, cfg.eos_id), nxt)
        done = done | (nxt == cfg.eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)


# -- HuggingFace interop (WhisperForConditionalGeneration) --------------------


def config_from_hf_whisper(hf_config, dtype: str = "bfloat16"
                           ) -> WhisperConfig:
    """A transformers WhisperConfig (or config.json's dict) as a
    WhisperConfig (the encoder's widths serve both stacks)."""
    g = (hf_config.get if isinstance(hf_config, dict)
         else lambda k, d=None: getattr(hf_config, k, d))
    return WhisperConfig(
        vocab_size=g("vocab_size"), n_mels=g("num_mel_bins", 80),
        d_model=g("d_model"), n_heads=g("encoder_attention_heads"),
        n_enc_layers=g("encoder_layers"), n_dec_layers=g("decoder_layers"),
        d_ff=g("encoder_ffn_dim"),
        max_source_positions=g("max_source_positions", 1500),
        max_target_positions=g("max_target_positions", 448), dtype=dtype,
        decoder_start_id=g("decoder_start_token_id", 0) or 0,
        eos_id=g("eos_token_id", 1) or 1)


def params_from_hf_whisper(state_dict, cfg: WhisperConfig, device=None):
    """A WhisperForConditionalGeneration state dict -> params, fp32 on
    `device` (default: the CUDA device): Conv1d (out, in, k) -> (k, in,
    out), Linears transposed; the head is the tied embedding."""
    r = _Reader(state_dict, resolve_device(device))
    A, W = r.A, r.W

    def attn(prefix):
        return {"wq": W(f"{prefix}.q_proj.weight"),
                "bq": A(f"{prefix}.q_proj.bias"),
                "wk": W(f"{prefix}.k_proj.weight"),
                "wv": W(f"{prefix}.v_proj.weight"),
                "bv": A(f"{prefix}.v_proj.bias"),
                "wo": W(f"{prefix}.out_proj.weight"),
                "bo": A(f"{prefix}.out_proj.bias")}

    def block(prefix, cross):
        blk = {"attn": attn(f"{prefix}.self_attn"), "mlp": {
            "fc1": W(f"{prefix}.fc1.weight"), "fc1_b": A(f"{prefix}.fc1.bias"),
            "fc2": W(f"{prefix}.fc2.weight"),
            "fc2_b": A(f"{prefix}.fc2.bias")}}
        norms = [("attn_norm", "self_attn_layer_norm"),
                 ("mlp_norm", "final_layer_norm")]
        if cross:
            blk["cross"] = attn(f"{prefix}.encoder_attn")
            norms.append(("cross_norm", "encoder_attn_layer_norm"))
        for ours, theirs in norms:
            blk[ours] = A(f"{prefix}.{theirs}.weight")
            blk[ours + "_b"] = A(f"{prefix}.{theirs}.bias")
        return blk

    m = "model."
    return {
        "conv1_w": A(m + "encoder.conv1.weight").permute(2, 1, 0).contiguous(),
        "conv1_b": A(m + "encoder.conv1.bias"),
        "conv2_w": A(m + "encoder.conv2.weight").permute(2, 1, 0).contiguous(),
        "conv2_b": A(m + "encoder.conv2.bias"),
        "enc_pos": A(m + "encoder.embed_positions.weight"),
        "embed": A(m + "decoder.embed_tokens.weight"),
        "dec_pos": A(m + "decoder.embed_positions.weight"),
        "enc_final_norm": A(m + "encoder.layer_norm.weight"),
        "enc_final_norm_b": A(m + "encoder.layer_norm.bias"),
        "dec_final_norm": A(m + "decoder.layer_norm.weight"),
        "dec_final_norm_b": A(m + "decoder.layer_norm.bias"),
        "encoder": [block(f"{m}encoder.layers.{i}", False)
                    for i in range(cfg.n_enc_layers)],
        "decoder": [block(f"{m}decoder.layers.{i}", True)
                    for i in range(cfg.n_dec_layers)],
    }


def from_hf_whisper(model_or_path, dtype: str = "bfloat16", device=None):
    """(params, cfg) from a checkpoint directory (read without
    transformers: config.json over hf.FAMILY_CONFIG_DEFAULTS["whisper"],
    then the weights) or a transformers WhisperForConditionalGeneration;
    fp32 params on `device` (default: the CUDA device)."""
    if is_checkpoint_path(model_or_path):
        hc, sd = read_hf_dir(model_or_path)
    else:
        hc, sd = model_or_path.config, model_or_path.state_dict()
    cfg = config_from_hf_whisper(hc, dtype=dtype)
    return params_from_hf_whisper(sd, cfg, device), cfg


# -- mesh parallelism (dp x tp) -----------------------------------------------


def whisper_param_specs(params) -> dict:
    """The JAX specs: q / k / v column-parallel with their biases (k has
    none), out row-parallel (its bias replicated), fc1 column / fc2 row,
    conv1 over its output channels and conv2 over its input channels, the
    embedding over d_model, norms and position tables replicated."""

    def attn():
        return {"wq": P(None, "tp"), "bq": P("tp"), "wk": P(None, "tp"),
                "wv": P(None, "tp"), "bv": P("tp"), "wo": P("tp", None),
                "bo": P()}

    def block(cross):
        blk = {"attn": attn(), "mlp": {"fc1": P(None, "tp"), "fc1_b": P("tp"),
                                       "fc2": P("tp", None), "fc2_b": P()},
               "attn_norm": P(), "attn_norm_b": P(), "mlp_norm": P(),
               "mlp_norm_b": P()}
        if cross:
            blk.update(cross=attn(), cross_norm=P(), cross_norm_b=P())
        return blk

    return {
        "conv1_w": P(None, None, "tp"), "conv1_b": P("tp"),
        "conv2_w": P(None, "tp", None), "conv2_b": P(),
        "enc_pos": P(), "dec_pos": P(), "embed": P(None, "tp"),
        "enc_final_norm": P(), "enc_final_norm_b": P(),
        "dec_final_norm": P(), "dec_final_norm_b": P(),
        "encoder": [block(False) for _ in params["encoder"]],
        "decoder": [block(True) for _ in params["decoder"]],
    }


def shard_whisper_params(params, mesh, cfg: WhisperConfig) -> ShardedParams:
    """What each held rank of a (dp, tp) mesh holds under
    whisper_param_specs: whole heads a rank (tp must divide n_heads).
    Every function of this module takes the result in place of params."""
    mesh = as_mesh(mesh)
    if cfg.n_heads % mesh.tp:
        raise ValueError(f"tp {mesh.tp} does not divide the {cfg.n_heads} "
                         f"heads")
    return shard_tree(params, whisper_param_specs(params), mesh, cfg)
