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
routed MoE MLP (Mixtral, Qwen3-MoE and DeepSeek-V3 routing), the attention
mixer over the flash kernels (ops/attention.py) or over multi-head latent
attention (models/mla.py), the block, the training forward and the two
losses, and the low-rank adapter hooks that models/lora.py attaches
(a block's "lora" entry: wqkv and wo, the dense MLP's w_gate, w_up and
w_down, an MLA block's wo).  A quantized (intN, scale) weight of a frozen
QLoRA base dequantizes per product and is made again in the backward.

The MoE MLP routes as the JAX function does (fp32 router logits, softmax
or sigmoid scores, the selection bias, group-limited selection with masked
experts at 0.0, mixing weights from the raw scores), with ties broken
toward the lower expert index as lax.top_k breaks them.  Where the JAX
function runs every expert over every token and scales the unrouted ones
by an exact 0, the port runs each expert over the rows routed to it only
and adds its weighted output back in expert order: the same sums, since
adding +0.0 changes none.

Tensor and data parallelism: `hidden_states`, `forward` and the losses
also take a parallel.mesh.ShardedParams.  Each rank then runs its own
heads (K1 and K2 per rank, through ops/attention; an MLA block's heads
over the latent every rank computes) and a row-parallel wo with one
all-reduce over tp, a column-parallel gate/up (or w_fc) and a
row-parallel down (or w_proj) with one all-reduce (a MoE block: every
expert split so, its partial outputs summed locally, one all-reduce),
norms on replicated activations, the embedding over d_model
(all-gathered) and the head as param_specs lays it out: an untied lm_head column-parallel over the
vocabulary (the loss vocab-parallel, models/loss.py), a tied one
row-parallel.  fsdp leaves are all-gathered over dp a layer at a time.
The collectives are parallel/collectives.py's, so one code path serves
a LocalMesh (all ranks in lockstep on one device) and a DeviceMesh (one
rank a process).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_attention_fn, make_flash_attention
from ..parallel import collectives as cc
from ..parallel.mesh import LocalMesh, ShardedParams
from ..runtime.backend import resolve_device
from ..utils.tree import tree_leaves, tree_unflatten

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


def init_params(seed: int, cfg: TransformerConfig, device=None,
                dtype: torch.dtype = torch.float32):
    """Random parameters with the JAX init_params distributions and keys:
    embedding N(0, 0.02^2), learned positions N(0, 0.01^2), matrices
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norm gains 1 (0 for rms_offset),
    biases and the MoE router bias 0; MLA blocks as mla.init_mla_block,
    MoE blocks (layers from cfg.moe_first_dense on) a "router", a list
    "experts" of SwiGLUs at moe_d_ff (or d_ff) and, with shared experts,
    one "shared" SwiGLU at moe_d_ff * n_shared_experts.  Drawn from a
    torch.Generator seeded with `seed` on the target device (torch and
    jax.random give different numbers; tests share weights through
    models/weights.py instead).  `dtype` is the storage dtype: bf16 halves
    the memory of a full-size model on the card."""
    from .mla import init_mla_block

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

    def swiglu(width):
        return {"w_gate": linear(dm, width), "w_up": linear(dm, width),
                "w_down": linear(width, dm)}

    dm = cfg.d_model
    params = {"embed": normal((cfg.vocab_size, dm), 0.02),
              "final_norm": full(dm, gain0), "blocks": []}
    if cfg.pos == "learned":
        params["pos_embed"] = normal((cfg.max_seq_len, dm), 0.01)
    if cfg.norm == "layernorm":
        params["final_norm_b"] = full(dm, 0.0)
    for i in range(cfg.n_layers):
        if cfg.attention == "mla":
            blk = {"attn_norm": full(dm, gain0), "mlp_norm": full(dm, gain0),
                   **init_mla_block(linear, full, cfg)}
        else:
            blk = {"attn_norm": full(dm, gain0),
                   "wqkv": linear(dm, cfg.qkv_out), "wo": linear(dm, dm),
                   "mlp_norm": full(dm, gain0)}
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
        elif cfg.n_experts and i >= cfg.moe_first_dense:
            d_ex = cfg.moe_d_ff or cfg.d_ff  # fine-grained expert width
            blk["router"] = linear(dm, cfg.n_experts)
            if cfg.moe_score_bias:
                blk["router_bias"] = full(cfg.n_experts, 0.0)
            blk["experts"] = [swiglu(d_ex) for _ in range(cfg.n_experts)]
            if cfg.n_shared_experts:  # one fused always-on SwiGLU
                blk["shared"] = swiglu(d_ex * cfg.n_shared_experts)
        else:
            blk.update(swiglu(cfg.d_ff))
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


class _DequantMm(torch.autograd.Function):
    """y @ dequant(w_q, scale) with an fp32 result for a frozen QLoRA base
    weight (models/lora.quantize_base): differentiable in y only.  It saves
    the QUANTIZED pair, not the dequantized weight, and dequantizes again
    in the backward, so a quantized base keeps no full-precision copy of
    itself alive for the backward.  The products are _plain_mm's: fp32
    with fp32 inputs, else y's dtype with an fp32 result (torch.mm's
    out_dtype on the card; fp32 on the CPU, exact for 16-bit inputs); the
    backward rounds the fp32 cotangent to y's dtype on the card, as
    _MmFp32Out does."""

    @staticmethod
    def forward(ctx, y, w_q, scale):
        from ..ops.quant import dequant_weight

        ctx.save_for_backward(w_q, scale)
        ctx.dtype = y.dtype
        w = dequant_weight(w_q, scale, y.dtype)
        if y.dtype == torch.float32:
            return y @ w
        if y.is_cuda:
            return torch.mm(y, w, out_dtype=torch.float32)
        return y.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        from ..ops.quant import dequant_weight

        w_q, scale = ctx.saved_tensors
        dtype = ctx.dtype
        w = dequant_weight(w_q, scale, dtype)
        if dtype == torch.float32:
            dy = g @ w.t()
        elif g.is_cuda:
            dy = torch.mm(g.to(dtype), w.t())
        else:
            dy = (g @ w.float().t()).to(dtype)
        return dy, None, None


def _plain_mm(y, w):
    """y @ w in y's dtype with an fp32 result, like the JAX package's
    jnp.dot(y, w.astype(y.dtype), preferred_element_type=float32): the
    product of a bf16 pair is NOT rounded to bf16 before the caller uses
    it (the MLP's gate/up reach silu in fp32).  On the card that is
    torch.mm's out_dtype=float32 (differentiable through _MmFp32Out); on
    the CPU, which lacks it, the bf16 inputs are widened to fp32, whose
    products of bf16 values are exact.  A quantized (intN, scale) pair (a
    QLoRA base) is dequantized to y's dtype first, as the JAX _plain_mm
    does (_DequantMm)."""
    if isinstance(w, tuple):
        y2 = y.reshape(-1, y.shape[-1])
        out = _DequantMm.apply(y2, w[0], w[1])
        return out.reshape(*y.shape[:-1], w[1].shape[-1])
    if y.dtype == torch.float32:
        return y @ w.to(y.dtype)
    if y.is_cuda:
        out = _MmFp32Out.apply(y.reshape(-1, y.shape[-1]), w)
        return out.reshape(*y.shape[:-1], w.shape[1])
    return y.float() @ w.to(y.dtype).float()


def _lora_delta(y, p, name):
    """The low-rank update of block p's matmul `name`: (y @ A) @ B * scale
    in fp32, or None where the block carries no adapter for it (the
    "lora" entry that models/lora.attach_lora adds)."""
    ad = p.get("lora", {}).get(name)
    if ad is None:
        return None
    t = (y.float() @ ad["A"].float()) @ ad["B"].float()
    return t * float(ad.get("scale", 1.0))


def _mm_with_lora(y, w, p, name, mm=None):
    """mm(y, w) (default _plain_mm) plus the adapter's delta where block p
    has one for `name`."""
    out = (mm or _plain_mm)(y, w)
    d = _lora_delta(y, p, name)
    return out if d is None else out + d


def mlp_hidden(y, p, cfg: TransformerConfig, mm=_plain_mm):
    """The dense MLP up to its down projection: the activation (B, S, d_ff)
    in y's dtype that w_down (or w_proj) takes."""
    if cfg.mlp_type == "gelu":
        h = mm(y, p["w_fc"])
        if "b_fc" in p:
            h = h + p["b_fc"].float()
        approx = "none" if cfg.gelu_exact else "tanh"
        return F.gelu(h, approximate=approx).to(y.dtype)
    gate = _mm_with_lora(y, p["w_gate"], p, "w_gate", mm)
    up = _mm_with_lora(y, p["w_up"], p, "w_up", mm)
    g = (F.gelu(gate, approximate="tanh") if cfg.mlp_type == "geglu"
         else F.silu(gate))
    return (g * up).to(y.dtype)


def mlp_out_weight(p):
    """The MLP's down projection: w_proj (GELU) or w_down."""
    return p["w_proj"] if "w_proj" in p else p["w_down"]


def is_moe(p, cfg: TransformerConfig) -> bool:
    """Whether block p's MLP is the routed mixture (the JAX test: a MoE
    config and an "experts" entry; the first moe_first_dense layers of a
    DeepSeek stack are dense)."""
    return bool(cfg.n_experts) and cfg.mlp_type != "gelu" and "experts" in p


def topk_lowest_first(x, k: int):
    """lax.top_k along the last axis: the k largest values and their
    indices, sorted, ties toward the lower index (a stable descending sort;
    torch.topk promises no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_routing(y, p, cfg: TransformerConfig):
    """The router of a MoE block over y (..., d): (topi (..., k) int64, the
    chosen experts, and topv (..., k) fp32, their mixing weights).

    fp32 logits y @ router; softmax over all experts or sigmoid scores;
    the selection scores add router_bias where the block has one; with
    moe_n_group > 1 only the moe_topk_group groups of largest top-2 sum stay
    selectable, the others' scores set to 0.0 (not -inf, as HF does: a
    negative bias can rank a masked expert above a kept one).  The mixing
    weights are the raw scores at the chosen experts, renormalized under
    moe_norm_topk (the sigmoid's denominator + 1e-20), times
    moe_routed_scale."""
    logits = y.float() @ p["router"].float()
    if cfg.moe_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    choice = scores + p["router_bias"].float() if "router_bias" in p \
        else scores
    if cfg.moe_n_group > 1:
        e_per_g = cfg.n_experts // cfg.moe_n_group
        gs = choice.reshape(*choice.shape[:-1], cfg.moe_n_group, e_per_g)
        group_scores = topk_lowest_first(gs, 2)[0].sum(dim=-1)
        _, gsel = topk_lowest_first(group_scores, cfg.moe_topk_group)
        gmask = torch.zeros_like(group_scores).scatter_(-1, gsel, 1.0)
        keep = gmask.repeat_interleave(e_per_g, dim=-1) > 0
        choice = torch.where(keep, choice, torch.zeros_like(choice))
    _, topi = topk_lowest_first(choice, cfg.moe_top_k)
    topv = scores.gather(-1, topi)
    if cfg.moe_norm_topk:
        denom = topv.sum(dim=-1, keepdim=True)
        if cfg.moe_score == "sigmoid":
            denom = denom + 1e-20  # HF V3 epsilon
        topv = topv / denom
    if cfg.moe_routed_scale != 1.0:
        topv = topv * cfg.moe_routed_scale
    return topi, topv


def moe_plan(topi, n_experts: int):
    """[(e, rows, slots)] for each expert that got a row, in expert order:
    the flat rows routed to expert e (ascending) and the top-k slot that
    chose it.  One host sync (the counts).  An expert without a row is
    left out: the loss does not reach its weights (nor router_bias, which
    only chooses), and the train steps give such leaves the zero gradient
    the JAX function gives them."""
    k = topi.shape[-1]
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts).tolist()
    plan, start = [], 0
    for e, c in enumerate(counts):
        if c:
            pos = order[start:start + c]
            plan.append((e, pos // k, pos % k))
        start += c
    return plan


def swiglu_hidden(y, pe, mm=_plain_mm):
    """silu(y @ w_gate) * (y @ w_up) in y's dtype: an expert's activation."""
    return (F.silu(mm(y, pe["w_gate"])) * mm(y, pe["w_up"])).to(y.dtype)


def moe_hidden(y, p, plan, mm=_plain_mm):
    """The activations of a MoE block's experts, each over its routed rows
    (plan's order), then the shared expert's over every row where the
    block has one: [(activation (rows, d_ex), its w_down)]."""
    flat = y.reshape(-1, y.shape[-1])
    acts = [(swiglu_hidden(flat[rows], p["experts"][e], mm),
             p["experts"][e]["w_down"]) for e, rows, _ in plan]
    if "shared" in p:
        acts.append((swiglu_hidden(flat, p["shared"], mm),
                     p["shared"]["w_down"]))
    return acts


def moe_combine(y, p, plan, topv, outs):
    """The MoE output (..., d) fp32 from the experts' down products `outs`
    (moe_hidden's order): each weighted by its mixing weight and added into
    its rows in expert order, the shared expert's last, unweighted."""
    n = math.prod(y.shape[:-1])
    out = torch.zeros((n, y.shape[-1]), dtype=torch.float32, device=y.device)
    w = topv.reshape(n, -1)
    for (_, rows, slots), o in zip(plan, outs):
        out.index_add_(0, rows, o.float() * w[rows, slots][:, None])
    if "shared" in p:
        out = out + outs[-1].float()
    return out.reshape(y.shape)


def moe_mlp(y, p, cfg: TransformerConfig, mm=_plain_mm):
    """The routed mixture of a MoE block (module docstring); returns fp32.
    `mm` reaches every expert's three products (and the shared expert's),
    not the router's."""
    topi, topv = moe_routing(y, p, cfg)
    plan = moe_plan(topi, cfg.n_experts)
    acts = moe_hidden(y, p, plan, mm)
    return moe_combine(y, p, plan, topv, [mm(a, w) for a, w in acts])


def mlp(y, p, cfg: TransformerConfig, mm=_plain_mm):
    """Dense MLP (swiglu, geglu or tanh/erf-GELU) or the routed mixture of
    a MoE block; returns fp32.  `mm` is the matmul, so that the paged
    decode step can pass one that takes quantized (intN, scale) weights
    (models/serve._mm).  A swiglu/geglu block's adapters on w_gate, w_up
    and w_down add their deltas (the GELU MLP takes none, as in the JAX
    function)."""
    if is_moe(p, cfg):
        return moe_mlp(y, p, cfg, mm)
    h = mlp_hidden(y, p, cfg, mm)
    if cfg.mlp_type == "gelu":
        out = mm(h, p["w_proj"])
    else:
        out = _mm_with_lora(h, p["w_down"], p, "w_down", mm)
    if "b_proj" in p:
        out = out + p["b_proj"].float()
    return out


def attention_heads(y, p, cfg: TransformerConfig):
    """Causal self-attention over the normed block input y (B, S, d) up to
    the output projection: fused QKV projection -> RoPE -> flash kernel.
    Returns (B, S, n_heads * head_dim) in y's dtype."""
    b, s, _ = y.shape
    qkv = _mm_with_lora(y, p["wqkv"], p, "wqkv")
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
    return attn.transpose(1, 2).reshape(b, s, -1)


def attention_mixer(y, p, cfg: TransformerConfig):
    """Causal self-attention over the normed block input y (B, S, d): fused
    QKV projection -> RoPE -> flash kernel -> output projection, or
    multi-head latent attention (cfg.attention == "mla", models/mla.py).
    Returns the post-wo output (B, S, d) fp32."""
    if cfg.attention == "mla":
        from .mla import mla_attention

        return mla_attention(y, p, cfg)
    o = _mm_with_lora(attention_heads(y, p, cfg), p["wo"], p, "wo")
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
    Gemma's sqrt(d_model) normalizer, cast to the activation dtype.  A
    config without the field (models/pipeline_lm.PipelineMoEConfig) scales
    nothing, as the JAX function's getattr allows."""
    x = params["embed"][tokens.long()].to(cfg.act_dtype)
    if getattr(cfg, "embed_scale", False):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype)
    return x


def hidden_states(params, tokens, cfg: TransformerConfig):
    """tokens: (B, S) integers -> final-norm trunk output (B, S, d_model).
    cfg.remat recomputes each block in the backward pass instead of saving
    its activations (torch.utils.checkpoint, non-reentrant).  With a
    ShardedParams the batch is split over dp (see rank_batches) and the
    result joined back (join_dp)."""
    if isinstance(params, ShardedParams):
        xs, _ = tp_trunk(params, rank_batches(params.mesh, tokens), cfg)
        return join_dp(params.mesh, xs)
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
    if isinstance(params, ShardedParams):
        xs, top = tp_trunk(params, rank_batches(params.mesh, tokens), cfg)
        return join_dp(params.mesh, tp_logits(params, top, xs))
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


# -- tensor and data parallelism over a mesh -----------------------------------


def rank_batches(mesh, batch) -> list:
    """Each held rank's stripe of a batch sharded over dp (batch_spec): under
    a LocalMesh `batch` is the global batch (split into dp stripes) or the
    list of dp stripes; under a GroupMesh it is this process's stripe."""
    if isinstance(mesh, LocalMesh):
        if isinstance(batch, (list, tuple)):
            stripes = list(batch)
        else:
            batch = torch.as_tensor(batch)
            if batch.shape[0] % mesh.dp:
                raise ValueError(f"batch {batch.shape[0]} does not split over "
                                 f"dp = {mesh.dp}")
            stripes = list(batch.chunk(mesh.dp))
        if len(stripes) != mesh.dp:
            raise ValueError(f"{len(stripes)} stripes for dp = {mesh.dp}")
        out = [stripes[mesh.index(r, "dp")] for r in mesh.ranks]
    else:
        out = list(batch) if isinstance(batch, (list, tuple)) else [batch]
    return [torch.as_tensor(b).to(mesh.device) for b in out]


def join_dp(mesh, xs):
    """The inverse of rank_batches for a replicated-over-tp result: the dp
    stripes (tp rank 0's) concatenated under a LocalMesh, this process's
    stripe under a GroupMesh."""
    if isinstance(mesh, LocalMesh):
        first = {}  # each dp stripe's first held rank (tp index 0)
        for i, r in enumerate(mesh.ranks):
            first.setdefault(mesh.index(r, "dp"), i)
        return torch.cat([xs[first[d]] for d in range(mesh.dp)])
    return xs[0]


def local_config(cfg: TransformerConfig, sp: ShardedParams):
    """The config of one rank's attention: its share of the heads where
    attention splits over tp, the whole config where it is replicated."""
    if not sp.attn_split:
        return cfg
    tp = sp.mesh.tp
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.kv_heads // tp,
        d_model=cfg.head_dim * cfg.n_heads // tp)


def gathered(sp: ShardedParams, trees, shards):
    """Per-rank trees with every fsdp leaf all-gathered over dp (the
    backward reduce-scatters its gradient): what tp alone would hold."""
    per_rank = [tree_leaves(t) for t in trees]
    cols = []
    for i, shard in enumerate(tree_leaves(shards)):
        xs = [leaves[i] for leaves in per_rank]
        if shard.dp_dim is not None:
            xs = cc.all_gather(xs, sp.mesh, "dp", shard.dp_dim)
        cols.append(xs)
    return [tree_unflatten(t, [c[j] for c in cols])
            for j, t in enumerate(trees)]


def _top_level(sp: ShardedParams):
    """Per-rank dicts of the leaves outside the blocks, fsdp-gathered."""
    keys = [k for k in sp.shards if k != "blocks"]
    trees = [{k: t[k] for k in keys} for t in sp.local]
    return gathered(sp, trees, {k: sp.shards[k] for k in keys})


def row_parallel(acts, weights, mesh, mm, split: bool):
    """sum over tp of acts[r] @ weights[r] (fp32), one all-reduce.
    Unsplit (replicated) weights take no collective.  A quantized pair's
    activation rows are scaled by their max over the WHOLE row (a max
    all-reduce over tp), as one device scales them; int8 pairs then add
    the ranks' exact integer sums and dequantize once
    (ops/quant.gemm_w8_integer), which is one device's product bit for
    bit; int4 pairs add their dequantized partial sums."""
    if not split:
        return [mm(a, w) for a, w in zip(acts, weights)]
    if not isinstance(weights[0], tuple):
        return cc.reduce([mm(a, w) for a, w in zip(acts, weights)], mesh)
    amax = cc.all_reduce([a.float().abs().amax(dim=-1) for a in acts],
                         mesh, "tp", "max")
    if weights[0][0].dtype != torch.int8:
        return cc.reduce([mm(a, w, row_absmax=m)
                          for a, w, m in zip(acts, weights, amax)], mesh)
    from ..ops.quant import gemm_w8_integer

    parts = [gemm_w8_integer(a.reshape(-1, a.shape[-1]).float(), w[0],
                             m.reshape(-1))
             for a, w, m in zip(acts, weights, amax)]
    accs = cc.reduce([acc for acc, _ in parts], mesh)
    return [((acc * s[:, None]) * w[1].float()[None, :]).reshape(
        *a.shape[:-1], -1) for acc, (_, s), w, a in zip(accs, parts, weights,
                                                       acts)]


def _bias(xs, ps, key):
    return [x + p[key].float() if key in p else x for x, p in zip(xs, ps)]


def tp_mlp(ys, ps, cfg: TransformerConfig, mesh, mm=_plain_mm):
    """The MLP over tp: column-parallel gate/up (or w_fc), row-parallel
    down (or w_proj), the row-parallel bias added once after the sum; a
    MoE block's experts as tp_moe splits them."""
    if is_moe(ps[0], cfg):
        return tp_moe(ys, ps, cfg, mesh, mm)
    ys = cc.copy(ys, mesh)
    acts = [mlp_hidden(y, p, cfg, mm) for y, p in zip(ys, ps)]
    outs = row_parallel(acts, [mlp_out_weight(p) for p in ps], mesh, mm, True)
    return _bias(outs, ps, "b_proj")


def tp_moe(ys, ps, cfg: TransformerConfig, mesh, mm=_plain_mm):
    """A MoE block's MLP over tp.  Each rank routes its copy of the
    replicated y with its replicated router (the same choices on every
    rank; the mixing weights enter the split region through
    collectives.copy, so the router's gradient is whole on every rank) and
    runs every expert's column slice of w_gate / w_up and row slice of
    w_down over the expert's routed rows (the shared expert likewise over
    every row).  The ranks' partial down products are summed over tp in
    ONE all-reduce a block: fp products weighted and added locally first;
    int8 ones as their exact integer sums, concatenated over the experts
    and dequantized after the sum, which gives one device's products bit
    for bit (row_parallel's rule); int4 ones dequantized first.  A
    quantized product scales each activation row by its max over the
    whole row: one max all-reduce of every expert's row maxima."""
    from ..ops.quant import gemm_w8_integer

    routes = [moe_routing(y, p, cfg) for y, p in zip(ys, ps)]
    topv = cc.copy([v for _, v in routes], mesh)
    ys = cc.copy(ys, mesh)
    # one plan a held rank: the same over tp, another for each dp stripe
    plans = [moe_plan(i, cfg.n_experts) for i, _ in routes]
    acts = [moe_hidden(y, p, plan, mm) for y, p, plan in zip(ys, ps, plans)]
    quant = next((w for _, w in acts[0] if isinstance(w, tuple)), None)
    if quant is None:
        amax = [[None] * len(r) for r in acts]
    else:
        amax = cc.all_reduce(
            [torch.cat([a.float().abs().amax(dim=-1) for a, _ in r])
             for r in acts], mesh, "tp", "max")
        amax = [m.split([a.shape[0] for a, _ in r])
                for r, m in zip(acts, amax)]
    if quant is None or quant[0].dtype != torch.int8:
        outs = [[mm(a, w) if m is None else mm(a, w, row_absmax=m)
                 for (a, w), m in zip(r, ms)] for r, ms in zip(acts, amax)]
        return cc.reduce([moe_combine(y, p, plan, v, o) for y, p, plan, v, o
                          in zip(ys, ps, plans, topv, outs)], mesh)
    parts = [[gemm_w8_integer(a.float(), w[0], m) if isinstance(w, tuple)
              else (mm(a, w), None) for (a, w), m in zip(r, ms)]
             for r, ms in zip(acts, amax)]
    sums = cc.reduce([torch.cat([acc for acc, _ in r]) for r in parts], mesh)
    outs = []
    for r, part, total in zip(acts, parts, sums):
        accs = total.split([a.shape[0] for a, _ in r])
        outs.append([acc if s is None else
                     (acc * s[:, None]) * w[1].float()[None, :]
                     for acc, (_, s), (_, w) in zip(accs, part, r)])
    return [moe_combine(y, p, plan, v, o) for y, p, plan, v, o in
            zip(ys, ps, plans, topv, outs)]


def tp_block(xs, ps, cfg: TransformerConfig, sp: ShardedParams, heads,
             mm=_plain_mm):
    """One block over the held ranks' replicated activations xs (fp32
    results cast back to their dtype).  heads(i, y, p) is held rank i's
    attention up to wo: its own heads where attention splits over tp,
    all of them where it is replicated.  For an MLA block y is the
    replicated latent (mla.mla_latent), computed before the split."""
    mesh, split = sp.mesh, sp.attn_split
    ys = [apply_norm(x, p, "attn_norm", cfg) for x, p in zip(xs, ps)]
    if cfg.attention == "mla":  # the heads read the latent every rank makes
        from .mla import mla_latent

        ys = [mla_latent(y, p, cfg) for y, p in zip(ys, ps)]
        if split:
            ys = list(zip(*(cc.copy(list(t), mesh) for t in zip(*ys))))
    elif split:
        ys = cc.copy(ys, mesh)
    attn = [heads(i, y, p) for i, (y, p) in enumerate(zip(ys, ps))]
    os = _bias(row_parallel(attn, [p["wo"] for p in ps], mesh, mm, split),
               ps, "bo")
    if cfg.parallel_residual:  # GPT-NeoX/GPT-J: branches share the input
        ys = [apply_norm(x, p, "mlp_norm", cfg) for x, p in zip(xs, ps)]
        ms = tp_mlp(ys, ps, cfg, mesh, mm)
        return [x + o.to(x.dtype) + m.to(x.dtype)
                for x, o, m in zip(xs, os, ms)]
    xs = [x + o.to(x.dtype) for x, o in zip(xs, os)]
    ys = [apply_norm(x, p, "mlp_norm", cfg) for x, p in zip(xs, ps)]
    return [x + m.to(x.dtype)
            for x, m in zip(xs, tp_mlp(ys, ps, cfg, mesh, mm))]


def tp_embed(sp: ShardedParams, top, tokens, cfg: TransformerConfig,
             positions=None):
    """Replicated (B, T, d_model) embeddings of each held rank's tokens: an
    embedding split over d_model is looked up in each piece and gathered.
    `positions` (T,) index the learned position table (default 0..T-1)."""
    xs = [p["embed"][t.long()].to(cfg.act_dtype) for p, t in zip(top, tokens)]
    if sp.shards["embed"].tp_dim is not None:
        xs = cc.gather(xs, sp.mesh, "tp", -1)
    if cfg.embed_scale:
        xs = [x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype)
              for x in xs]
    if cfg.pos == "learned":
        xs = [x + (p["pos_embed"][: t.shape[1]] if positions is None
                   else p["pos_embed"][positions]).to(cfg.act_dtype)
              for x, p, t in zip(xs, top, tokens)]
    return xs


def tp_trunk(sp: ShardedParams, tokens, cfg: TransformerConfig):
    """Each held rank's final-norm trunk output (replicated over tp) and
    its fsdp-gathered top-level params."""
    mesh = sp.mesh
    top = _top_level(sp)
    xs = tp_embed(sp, top, tokens, cfg)
    lcfg = local_config(cfg, sp)
    if cfg.attention == "mla":
        from .mla import mla_heads as heads_of
    else:
        heads_of = attention_heads

    def heads(i, y, p):
        return heads_of(y, p, lcfg)

    for li in range(len(sp.local[0]["blocks"])):
        def run(*xs, li=li):
            ps = gathered(sp, [t["blocks"][li] for t in sp.local],
                          sp.shards["blocks"][li])
            return tuple(tp_block(list(xs), ps, cfg, sp, heads))

        if cfg.remat and torch.is_grad_enabled():
            xs = list(checkpoint(run, *xs, use_reentrant=False))
        else:
            xs = list(run(*xs))
    return [apply_norm(x, p, "final_norm", cfg) for x, p in zip(xs, top)], top


def head_is_vocab_parallel(sp: ShardedParams) -> bool:
    """Whether the LM head splits the vocabulary over tp (an untied
    column-parallel lm_head)."""
    shard = sp.shards.get("lm_head")
    if isinstance(shard, tuple):  # a quantized (intN, scale) pair
        shard = shard[0]
    return shard is not None and shard.tp_dim == 1


def tp_logits(sp: ShardedParams, top, xs, mm=_plain_mm, gather=True):
    """Each held rank's fp32 logits.  A vocab-parallel head gives each rank
    its slice of the vocabulary (gathered over tp unless gather=False); a
    tied head over a d_model-split embedding is row-parallel (one
    all-reduce); a replicated head needs no collective."""
    mesh = sp.mesh
    if "lm_head" in top[0]:
        heads = [p["lm_head"] for p in top]
        if not head_is_vocab_parallel(sp):
            return [mm(x, h) for x, h in zip(xs, heads)]
        out = [mm(x, h) for x, h in zip(cc.copy(xs, mesh), heads)]
        return cc.gather(out, mesh, "tp", -1) if gather else out
    heads = [p["embed"].T for p in top]
    if sp.shards["embed"].tp_dim is None:
        return [mm(x, h) for x, h in zip(xs, heads)]
    return row_parallel(cc.scatter(xs, mesh, "tp", -1), heads, mesh, mm, True)


def tp_token_nll(sp: ShardedParams, tokens, targets, cfg: TransformerConfig,
                 loss_chunk: int | None = None):
    """Per-token NLL (N,) fp32 of each held rank's stripe, replicated over
    tp.  A vocab-parallel head takes the vocab-parallel cross-entropy
    (loss_chunk streams each rank's slice of the vocabulary); other heads
    the full logits.  Targets outside [0, vocab) give a finite value that
    the caller masks."""
    from .loss import vocab_parallel_nll

    xs, top = tp_trunk(sp, tokens, cfg)
    xs = [x.reshape(-1, x.shape[-1]) for x in xs]
    tg = [t.reshape(-1).long() for t in targets]
    if head_is_vocab_parallel(sp):
        return vocab_parallel_nll(cc.copy(xs, sp.mesh),
                                  [p["lm_head"] for p in top], tg, sp.mesh,
                                  loss_chunk)
    out = []
    for logits, t in zip(tp_logits(sp, top, xs), tg):
        logp = torch.log_softmax(logits.float(), dim=-1)
        out.append(-logp.gather(-1, t.clamp_min(0)[:, None])[:, 0])
    return out
