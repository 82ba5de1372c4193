"""Hybrid attention + selective-SSM LM (the Jamba architecture class).

Counterpart of kfunca_tpu/models/hybrid.py.  One residual stack
interleaves the two sequence mixers the port already has: causal flash
attention (models/transformer.attention_mixer, K1 forward and K2 backward
on the card) and the Mamba selective SSM (models/mamba.mamba_mixer, K11).
Every layer is mixer -> residual -> SwiGLU MLP -> residual.  Decode carries
a KV cache on the attention layers (models/generate.cached_attention_mixer)
and the O(1) recurrent state on the SSM layers; `generate` runs it in a
Python loop (the JAX package compiles one lax.scan program).  Parameter
layout and names are the JAX package's (models/weights.hybrid_params_from_jax).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..runtime.backend import resolve_device
from .mamba import (
    MambaConfig, _linear, _mixer_step, greedy_decode, init_mamba_mixer,
    mamba_mixer, token_nll,
)
from .transformer import (
    _DTYPES, TransformerConfig, _plain_mm, attention_mixer, mlp, rms_norm,
)

IGNORE = -100


@dataclass(frozen=True)
class HybridConfig:
    """The JAX package's HybridConfig, field for field."""

    vocab_size: int = 512
    d_model: int = 256
    n_layers: int = 8
    d_ff: int = 704
    # attention sub-config (applies to the attention layers)
    n_heads: int = 4
    n_kv_heads: int | None = None
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    attention_window: int | None = None
    # SSM sub-config (applies to the mamba layers)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    scan_chunk: int | None = 128
    # layer i is attention iff i % attn_every == attn_offset; an explicit
    # `pattern` of "attn" / "mamba" strings overrides both
    attn_every: int = 4
    attn_offset: int = 2
    pattern: tuple[str, ...] | None = None
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def layer_kinds(self) -> tuple[str, ...]:
        if self.pattern is not None:
            if len(self.pattern) != self.n_layers or not all(
                    k in ("attn", "mamba") for k in self.pattern):
                raise ValueError(f"pattern {self.pattern} is not {self.n_layers}"
                                 f" of 'attn' / 'mamba'")
            return tuple(self.pattern)
        return tuple(
            "attn" if i % self.attn_every == self.attn_offset else "mamba"
            for i in range(self.n_layers))

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def tcfg(self) -> TransformerConfig:
        """Sub-config driving the reused attention mixer."""
        return TransformerConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            n_layers=self.n_layers, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            attention_window=self.attention_window,
            norm_eps=self.norm_eps, dtype=self.dtype)

    @property
    def mcfg(self) -> MambaConfig:
        """Sub-config driving the reused SSM mixer."""
        return MambaConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, d_state=self.d_state,
            d_conv=self.d_conv, expand=self.expand, dt_rank=self.dt_rank,
            scan_chunk=self.scan_chunk, norm_eps=self.norm_eps,
            dtype=self.dtype)


def init_hybrid_params(seed: int, cfg: HybridConfig, device=None,
                       dtype=torch.float32):
    """Random params with the JAX init_hybrid_params laws, from a
    torch.Generator seeded with `seed` on `device` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tc, dm = cfg.tcfg, cfg.d_model

    def ones():
        return torch.ones((dm,), dtype=dtype, device=dev)

    params = {
        "embed": (torch.randn((cfg.vocab_size, dm), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": ones(),
        "blocks": [],
    }
    for kind in cfg.layer_kinds():
        blk = {"attn_norm": ones(), "mlp_norm": ones(),
               "w_gate": _linear(gen, dm, cfg.d_ff, dtype),
               "w_up": _linear(gen, dm, cfg.d_ff, dtype),
               "w_down": _linear(gen, cfg.d_ff, dm, dtype)}
        if kind == "attn":
            blk["wqkv"] = _linear(gen, dm, tc.qkv_out, dtype)
            blk["wo"] = _linear(gen, dm, dm, dtype)
        else:
            blk.update(init_mamba_mixer(gen, cfg.mcfg, dtype))
        params["blocks"].append(blk)
    return params


def _hybrid_block(x, p, kind: str, cfg: HybridConfig):
    y = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if kind == "attn":
        o = attention_mixer(y, p, cfg.tcfg)
    else:
        o = mamba_mixer(y, p, cfg.mcfg)
    x = x + o.to(x.dtype)
    y = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp(y, p, cfg.tcfg).to(x.dtype)


def hidden_states(params, tokens, cfg: HybridConfig):
    x = params["embed"][tokens.long()].to(cfg.act_dtype)
    for p, kind in zip(params["blocks"], cfg.layer_kinds()):
        x = _hybrid_block(x, p, kind, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params, tokens, cfg: HybridConfig):
    """tokens (B, S) integers -> fp32 logits (B, S, vocab); tied head."""
    return _plain_mm(hidden_states(params, tokens, cfg), params["embed"].t())


def loss_fn(params, tokens, targets, cfg: HybridConfig,
            ignore_index: int | None = IGNORE):
    return token_nll(forward(params, tokens, cfg), targets, ignore_index)


def make_hybrid_train_step(cfg: HybridConfig, oc=None, device=None):
    """train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss) on `device` (default: the CUDA device); the update is in place."""
    from .train import OptConfig, make_loss_train_step

    oc = oc or OptConfig(lr=1e-3)
    return make_loss_train_step(
        lambda p, t, y: loss_fn(p, t, y, cfg), oc, device)


# -- decode: KV cache on attention layers, recurrent state on SSM layers ------


def init_hybrid_state(cfg: HybridConfig, batch: int, max_len: int,
                      device=None):
    """Attention layers: a (B, kv_heads, max_len, head_dim) K and V cache;
    SSM layers: the (B, d_inner, d_state) fp32 state and the conv tail."""
    dev = resolve_device(device)
    tc, mc = cfg.tcfg, cfg.mcfg
    states = []
    for kind in cfg.layer_kinds():
        if kind == "attn":
            shape = (batch, tc.kv_heads, max_len, tc.head_dim)
            states.append({"k": torch.zeros(shape, dtype=cfg.act_dtype,
                                            device=dev),
                           "v": torch.zeros(shape, dtype=cfg.act_dtype,
                                            device=dev)})
        else:
            states.append({
                "ssm": torch.zeros((batch, mc.d_inner, mc.d_state),
                                   dtype=torch.float32, device=dev),
                "conv": torch.zeros((batch, mc.d_conv - 1, mc.d_inner),
                                    dtype=cfg.act_dtype, device=dev)})
    return states


def _hybrid_token_step(params, tok, states, pos: int, cfg: HybridConfig):
    """One token (B,) through the whole stack at absolute position `pos` ->
    (logits (B, V), new states).  The KV caches are written in place."""
    from .generate import cached_attention_mixer

    x = params["embed"][tok.long()].to(cfg.act_dtype)
    new_states = []
    for p, st, kind in zip(params["blocks"], states, cfg.layer_kinds()):
        y = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        if kind == "attn":
            o, st = cached_attention_mixer(y[:, None], p, st, int(pos),
                                           cfg.tcfg)
            o = o[:, 0]
        else:
            o, st = _mixer_step(y, p, st, cfg.mcfg)
        x = x + o.to(x.dtype)
        y = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + mlp(y, p, cfg.tcfg).to(x.dtype)
        new_states.append(st)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _plain_mm(x, params["embed"].t()), new_states


def generate(params, prompt, cfg: HybridConfig, max_new_tokens: int = 32,
             eos_id: int = -1):
    """Greedy generation: the prompt streams through the recurrent step
    (the attention layers fill their KV cache on the way), then new tokens
    follow.  prompt (B, S) integers on the params' device ->
    (B, max_new_tokens) int32; slots after an EOS are 0."""
    b, s = prompt.shape
    return greedy_decode(
        lambda tok, st, pos: _hybrid_token_step(params, tok, st, pos, cfg),
        init_hybrid_state(cfg, b, s + max_new_tokens, prompt.device), prompt,
        max_new_tokens, eos_id)
