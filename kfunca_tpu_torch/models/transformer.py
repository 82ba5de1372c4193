"""Decoder-only transformer LM: config, parameters and the dense block pieces.

Counterpart of kfunca_tpu/models/transformer.py.  The parameter layout is
the JAX package's, so both packages compute with the same weights
(models/weights.py carries them across): matrices are (in, out), the
attention projection is one fused "wqkv" of width (H + 2*Hkv) * hd, heads
are (B, H, S, hd), and the dict keys are the same.  Parameters may be
stored in any float dtype; every use casts them to the activation dtype
first, as the JAX package does.

Ported here: the config, init_params, the norms, split_qkv, apply_qk_norm,
the matmul helper and the dense MLP (swiglu, geglu, gelu).  The training
forward (flash attention), MoE, MLA and LoRA are later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's TransformerConfig, field for field (see
    kfunca_tpu/models/transformer.py for what each switch selects)."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1408
    max_seq_len: int = 1024
    dtype: str = "bfloat16"  # activation/compute dtype
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    rope_scaling: float = 1.0
    rope_scaling_type: str = "linear"
    remat: bool = False
    n_kv_heads: int | None = None
    attention_window: int | None = None
    n_experts: int = 0
    moe_top_k: int = 2
    n_shared_experts: int = 0
    moe_d_ff: int | None = None
    moe_score: str = "softmax"
    moe_norm_topk: bool = True
    moe_routed_scale: float = 1.0
    moe_n_group: int = 1
    moe_topk_group: int = 1
    moe_score_bias: bool = False
    moe_first_dense: int = 0
    rope_interleave: bool = False
    norm: str = "rms"
    pos: str = "rope"
    mlp_type: str = "swiglu"
    proj_bias: bool = False
    rope_pct: float = 1.0
    parallel_residual: bool = False
    gelu_exact: bool = False
    qk_norm: bool = False
    embed_scale: bool = False
    attention: str = "mha"
    q_lora_rank: int = 0
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 64
    v_head_dim: int | None = None

    @property
    def kv_heads(self) -> int:
        hkv = self.n_kv_heads or self.n_heads
        if self.n_heads % hkv:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"kv heads {hkv}")
        return hkv

    @property
    def qkv_out(self) -> int:
        return (self.n_heads + 2 * self.kv_heads) * self.head_dim

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def rope_params(self) -> tuple[float, float]:
        """Effective (theta, position_scale) under rope_scaling."""
        if self.rope_scaling == 1.0:
            return self.rope_theta, 1.0
        if self.rope_scaling_type == "linear":
            return self.rope_theta, 1.0 / self.rope_scaling
        if self.rope_scaling_type == "ntk":
            d = self.head_dim
            return self.rope_theta * self.rope_scaling ** (d / (d - 2)), 1.0
        raise ValueError(f"unknown rope_scaling_type {self.rope_scaling_type!r}")


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention == "mla":
        raise NotImplementedError("MLA blocks are a later slice of the port")
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are a later slice of the port")


def init_params(seed: int, cfg: TransformerConfig, device=None,
                dtype: torch.dtype = torch.float32):
    """Random parameters with the JAX init_params distributions: embedding
    N(0, 0.02^2), learned positions N(0, 0.01^2), matrices
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norm gains 1 (0 for rms_offset),
    biases 0.  Drawn from a torch.Generator seeded with `seed` on the
    target device (torch and jax.random give different numbers; tests
    share weights through models/weights.py instead).  `dtype` is the
    storage dtype: bf16 halves the memory of a full-size model on the
    card."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gain0 = 0.0 if cfg.norm == "rms_offset" else 1.0

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def linear(fan_in, fan_out):
        s = 1.0 / math.sqrt(fan_in)
        u = torch.rand((fan_in, fan_out), generator=gen, device=dev)
        return (u * (2 * s) - s).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    dm = cfg.d_model
    params = {"embed": normal((cfg.vocab_size, dm), 0.02),
              "final_norm": full(dm, gain0), "blocks": []}
    if cfg.pos == "learned":
        params["pos_embed"] = normal((cfg.max_seq_len, dm), 0.01)
    if cfg.norm == "layernorm":
        params["final_norm_b"] = full(dm, 0.0)
    for _ in range(cfg.n_layers):
        blk = {"attn_norm": full(dm, gain0), "wqkv": linear(dm, cfg.qkv_out),
               "wo": linear(dm, dm), "mlp_norm": full(dm, gain0)}
        if cfg.qk_norm:
            blk["q_norm"] = full(cfg.head_dim, 1.0)
            blk["k_norm"] = full(cfg.head_dim, 1.0)
        if cfg.norm == "layernorm":
            blk["attn_norm_b"] = full(dm, 0.0)
            blk["mlp_norm_b"] = full(dm, 0.0)
        if cfg.proj_bias:
            blk["bqkv"] = full(cfg.qkv_out, 0.0)
            blk["bo"] = full(dm, 0.0)
        if cfg.mlp_type == "gelu":
            blk["w_fc"] = linear(dm, cfg.d_ff)
            blk["w_proj"] = linear(cfg.d_ff, dm)
            if cfg.proj_bias:
                blk["b_fc"] = full(cfg.d_ff, 0.0)
                blk["b_proj"] = full(dm, 0.0)
        else:
            blk["w_gate"] = linear(dm, cfg.d_ff)
            blk["w_up"] = linear(dm, cfg.d_ff)
            blk["w_down"] = linear(cfg.d_ff, dm)
        params["blocks"].append(blk)
    return params


def lm_head_weight(params, dtype):
    """(d_model, vocab) LM head: the untied "lm_head" entry when present,
    else the tied embedding transpose."""
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return head.to(dtype)


def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm with fp32 statistics whatever the activation dtype."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * gamma.to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    """Mean-centred LayerNorm with bias, fp32 statistics."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def apply_norm(x, p, name, cfg: TransformerConfig):
    """cfg-dispatched norm: p[name] is the gain; LayerNorm reads the bias
    from p[name + "_b"]."""
    if cfg.norm == "rms":
        return rms_norm(x, p[name], cfg.norm_eps)
    if cfg.norm == "rms_offset":  # Gemma: gain is (1 + w)
        return rms_norm(x, p[name].float() + 1.0, cfg.norm_eps)
    return layer_norm(x, p[name], p[name + "_b"], cfg.norm_eps)


def split_qkv(qkv, cfg: TransformerConfig):
    """(B, S, qkv_out) fused projection -> q (B,H,S,hd), k/v (B,Hkv,S,hd)."""
    b, s, _ = qkv.shape
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = qkv[..., : h * hd].reshape(b, s, h, hd).transpose(1, 2)
    k = qkv[..., h * hd : (h + hkv) * hd].reshape(b, s, hkv, hd).transpose(1, 2)
    v = qkv[..., (h + hkv) * hd :].reshape(b, s, hkv, hd).transpose(1, 2)
    return q, k, v


def apply_qk_norm(q, k, p, cfg: TransformerConfig):
    """Per-head q/k RMSNorm (cfg.qk_norm) after the head split, before
    RoPE; a no-op when the switch is off."""
    if not cfg.qk_norm:
        return q, k
    return (rms_norm(q, p["q_norm"], cfg.norm_eps),
            rms_norm(k, p["k_norm"], cfg.norm_eps))


def _plain_mm(y, w):
    """y @ w in y's dtype with an fp32 result, like the JAX package's
    jnp.dot(y, w.astype(y.dtype), preferred_element_type=float32): the
    product of a bf16 pair is NOT rounded to bf16 before the caller uses
    it (the MLP's gate/up reach silu in fp32).  On the card that is
    torch.mm's out_dtype=float32; on the CPU, which lacks it, the bf16
    inputs are widened to fp32, whose products of bf16 values are exact."""
    if isinstance(w, tuple):
        raise NotImplementedError(
            "quantized (intN, scale) weights are a later slice of the port")
    w = w.to(y.dtype)
    if y.dtype == torch.float32:
        return y @ w
    if y.is_cuda:
        out = torch.mm(y.reshape(-1, y.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*y.shape[:-1], w.shape[1])
    return y.float() @ w.float()


def mlp(y, p, cfg: TransformerConfig):
    """Dense MLP (swiglu, geglu or tanh/erf-GELU); returns fp32."""
    if "experts" in p:
        raise NotImplementedError("MoE blocks are a later slice of the port")
    if cfg.mlp_type == "gelu":
        h = _plain_mm(y, p["w_fc"])
        if "b_fc" in p:
            h = h + p["b_fc"].float()
        approx = "none" if cfg.gelu_exact else "tanh"
        act = F.gelu(h, approximate=approx).to(y.dtype)
        out = _plain_mm(act, p["w_proj"])
        if "b_proj" in p:
            out = out + p["b_proj"].float()
        return out
    gate = _plain_mm(y, p["w_gate"])
    up = _plain_mm(y, p["w_up"])
    g = (F.gelu(gate, approximate="tanh") if cfg.mlp_type == "geglu"
         else F.silu(gate))
    return _plain_mm((g * up).to(y.dtype), p["w_down"])


def embed_tokens(params, tokens, cfg: TransformerConfig):
    """Token embedding in the activation dtype; cfg.embed_scale applies
    Gemma's sqrt(d_model) normalizer, cast to the activation dtype."""
    x = params["embed"][tokens].to(cfg.act_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype)
    return x
