"""Decoder-only transformer LM: config, parameters and the dense block pieces.

Counterpart of kfunca_tpu/models/transformer.py.  The parameter layout is
the JAX package's, so both packages compute with the same weights
(models/weights.py carries them across): matrices are (in, out), the
attention projection is one fused "wqkv" of width (H + 2*Hkv) * hd, heads
are (B, H, S, hd), and the dict keys are the same.  Parameters may be
stored in any float dtype; every use casts them to the activation dtype
first, as the JAX package does.

Ported here: the config, init_params, the norms, RoPE, split_qkv,
apply_qk_norm, the matmul helper, the dense MLP (swiglu, geglu, gelu), the
attention mixer over the flash kernels (ops/attention.py), the block, the
training forward and the two losses.  MoE, MLA and LoRA are later slices
and raise NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_attention_fn, make_flash_attention
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


def _rope(x, theta: float, pos_scale: float = 1.0, pct: float = 1.0):
    """Rotary embeddings over the head dim at positions 0..S-1; x:
    (B, H, S, D).  pos_scale < 1 is linear position interpolation; pct < 1
    rotates only the first pct of the head dims, the tail passes through."""
    if pct < 1.0:
        rot = int(x.shape[-1] * pct) & ~1  # even
        return torch.cat([_rope(x[..., :rot], theta, pos_scale), x[..., rot:]],
                         dim=-1)
    s, half = x.shape[2], x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(s, dtype=torch.float32, device=x.device) * pos_scale
    ang = pos[:, None] * freqs[None, :]  # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class _MmFp32Out(torch.autograd.Function):
    """(N, in) @ (in, out) on the card for a 16-bit y with an fp32 result:
    torch.mm's out_dtype=float32, which has no autograd formula of its own.

    The weight arrives in its storage dtype (fp32 master params in
    training) and is cast inside, so the backward hands back dw in that
    dtype with no 16-bit rounding.  The backward's products are 16-bit
    with fp32 accumulation, as the forward's: the fp32 cotangent g is
    ROUNDED to y's dtype first (the JAX package multiplies the fp32
    cotangent as it is), dy = g @ w.T comes back in y's dtype and
    dw = y.T @ g in fp32.  The cast weight is made again in the backward
    rather than saved."""

    @staticmethod
    def forward(ctx, y, w):
        ctx.save_for_backward(y, w)
        return torch.mm(y, w.to(y.dtype), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.to(y.dtype)
        dy = dw = None
        if ctx.needs_input_grad[0]:
            dy = torch.mm(g, w.to(y.dtype).t())
        if ctx.needs_input_grad[1]:
            dw = torch.mm(y.t(), g, out_dtype=torch.float32).to(w.dtype)
        return dy, dw


def _plain_mm(y, w):
    """y @ w in y's dtype with an fp32 result, like the JAX package's
    jnp.dot(y, w.astype(y.dtype), preferred_element_type=float32): the
    product of a bf16 pair is NOT rounded to bf16 before the caller uses
    it (the MLP's gate/up reach silu in fp32).  On the card that is
    torch.mm's out_dtype=float32 (differentiable through _MmFp32Out); on
    the CPU, which lacks it, the bf16 inputs are widened to fp32, whose
    products of bf16 values are exact."""
    if isinstance(w, tuple):
        raise NotImplementedError(
            "quantized (intN, scale) weights are a later slice of the port")
    if y.dtype == torch.float32:
        return y @ w.to(y.dtype)
    if y.is_cuda:
        out = _MmFp32Out.apply(y.reshape(-1, y.shape[-1]), w)
        return out.reshape(*y.shape[:-1], w.shape[1])
    return y.float() @ w.to(y.dtype).float()


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


def attention_mixer(y, p, cfg: TransformerConfig):
    """Causal self-attention over the normed block input y (B, S, d): fused
    QKV projection -> RoPE -> flash kernel -> output projection.  Returns
    the post-wo output (B, S, d) fp32."""
    if cfg.attention == "mla":
        raise NotImplementedError("MLA blocks are a later slice of the port")
    if "lora" in p:
        raise NotImplementedError("LoRA adapters are a later slice of the port")
    b, s, dm = y.shape
    qkv = _plain_mm(y, p["wqkv"])
    if "bqkv" in p:
        qkv = qkv + p["bqkv"].float()
    q, k, v = split_qkv(qkv.to(y.dtype), cfg)
    q, k = apply_qk_norm(q, k, p, cfg)
    if cfg.pos == "rope":
        theta, pscale = cfg.rope_params()
        q = _rope(q, theta, pscale, cfg.rope_pct)
        k = _rope(k, theta, pscale, cfg.rope_pct)
    if cfg.kv_heads == cfg.n_heads and cfg.attention_window is None:
        attn = causal_attention_fn(q, k, v)
    else:
        attn = make_flash_attention(window=cfg.attention_window)(q, k, v)
    attn = attn.transpose(1, 2).reshape(b, s, dm)
    o = _plain_mm(attn, p["wo"])
    if "bo" in p:
        o = o + p["bo"].float()
    return o


def _block(x, p, cfg: TransformerConfig):
    y = apply_norm(x, p, "attn_norm", cfg)
    o = attention_mixer(y, p, cfg)
    if cfg.parallel_residual:  # GPT-NeoX/GPT-J: branches share the input
        y = apply_norm(x, p, "mlp_norm", cfg)
        return x + o.to(x.dtype) + mlp(y, p, cfg).to(x.dtype)
    x = x + o.to(x.dtype)
    y = apply_norm(x, p, "mlp_norm", cfg)
    return x + mlp(y, p, cfg).to(x.dtype)


def embed_tokens(params, tokens, cfg: TransformerConfig):
    """Token embedding in the activation dtype; cfg.embed_scale applies
    Gemma's sqrt(d_model) normalizer, cast to the activation dtype."""
    x = params["embed"][tokens.long()].to(cfg.act_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype)
    return x


def hidden_states(params, tokens, cfg: TransformerConfig):
    """tokens: (B, S) integers -> final-norm trunk output (B, S, d_model).
    cfg.remat recomputes each block in the backward pass instead of saving
    its activations (torch.utils.checkpoint, non-reentrant)."""
    _check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][: tokens.shape[1]].to(cfg.act_dtype)
    for p in params["blocks"]:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_block, x, p, cfg, use_reentrant=False)
        else:
            x = _block(x, p, cfg)
    return apply_norm(x, params, "final_norm", cfg)


def _head(params):
    """The (d_model, vocab) head in its storage dtype: the tied embedding's
    gradient is then the sum of the gather's and the head's."""
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def forward(params, tokens, cfg: TransformerConfig):
    """tokens: (B, S) integers -> logits (B, S, vocab) fp32."""
    return _plain_mm(hidden_states(params, tokens, cfg), _head(params))


def _masked_mean(nll, targets, ignore_index):
    """Token-mean NLL; positions with target == ignore_index contribute
    nothing (padding / prompt-only tokens in SFT)."""
    if ignore_index is None:
        return nll.mean()
    mask = (targets != ignore_index).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params, tokens, targets, cfg: TransformerConfig,
            ignore_index: int | None = None):
    logits = forward(params, tokens, cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = targets.long()
    safe = targets if ignore_index is None else targets.clamp_min(0)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return _masked_mean(nll, targets, ignore_index)


def loss_fn_chunked(params, tokens, targets, cfg: TransformerConfig,
                    vocab_chunk: int = 4096, ignore_index: int | None = None):
    """loss_fn without ever materializing the (B, S, vocab) logits: the LM
    head is streamed in vocab chunks with an online logsumexp
    (models/loss.py).  Same loss and gradients; peak memory drops from
    O(B*S*V) to O(B*S*vocab_chunk)."""
    from .loss import chunked_softmax_xent

    x = hidden_states(params, tokens, cfg)
    b, s, d = x.shape
    # ignored targets (< 0) never hit any chunk, so their gathered logit is
    # 0 and their nll is just the (finite) lse, masked out below
    nll = chunked_softmax_xent(x.reshape(b * s, d), _head(params),
                               targets.reshape(-1), vocab_chunk)
    return _masked_mean(nll, targets.reshape(-1), ignore_index)
