"""Mamba-2 (SSD) family: chunked state-space training, O(1) decode.

Counterpart of kfunca_tpu/models/mamba2.py.  The parameter layout and the
names are the JAX package's, so models/weights.mamba2_params_from_jax
carries a JAX pytree across leaf for leaf.

Mamba-2's state-space duality (Dao & Gu 2024) writes the selective scan as
chunked matmuls: within a chunk an attention-like (C B^T o decay) score
matrix applied to the values, across chunks a short recurrence over the
chunk-boundary states.  The JAX package leaves these products to XLA (no
Pallas kernel); the port leaves them to torch's einsums in fp32, with a
Python loop over the chunk boundaries.

The structure is HF Mamba2ForCausalLM's: multi-head with a scalar A and dt
per head, grouped B/C shared across the heads of a group, one fused
in_proj emitting [gate, x|B|C (conv'd together), dt], the gated RMSNorm
(y * silu(gate), then RMS) before out_proj, the D skip on the
undiscretized x, a tied head.

One departure: `_segsum_decay` masks the exponent above the diagonal
before the exponential.  The JAX function takes exp over the whole chunk x
chunk square and zeroes the upper triangle afterwards; there the exponent
is minus a sum of log-decays, which overflows to inf once it passes ~88
(chunk 256 at mamba2-2.7b's init decays), and the backward then makes
0 * inf = NaN.  Masked first, the forward is the same and the gradients
stay finite.

Decode is the O(1) recurrent step: per layer an (H, head_dim, N) fp32
state plus the (k - 1)-deep conv tail over the fused x|B|C channels;
`generate` runs it in a Python loop (the JAX package compiles prefill and
decode into one lax.scan program).

Precision: params fp32, activations cfg.dtype, SSD math fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..runtime.backend import resolve_device
from .hf import _Reader, is_checkpoint_path, read_hf_dir
from .mamba import _causal_conv, _linear, greedy_decode, token_nll
from .transformer import _DTYPES, _plain_mm, rms_norm

IGNORE = -100


@dataclass(frozen=True)
class Mamba2Config:
    """The JAX package's Mamba2Config, field for field."""

    vocab_size: int = 512
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 64
    d_state: int = 64  # HF state_size
    n_groups: int = 1  # B/C groups (heads share within a group)
    d_conv: int = 4
    expand: int = 2
    chunk_size: int = 64  # SSD chunk length
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def d_inner(self) -> int:
        di = self.expand * self.d_model
        if di != self.n_heads * self.head_dim:
            raise ValueError(f"d_inner {di} != n_heads {self.n_heads} x "
                             f"head_dim {self.head_dim}")
        return di

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def proj_out(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state \
            + self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def init_mamba2_params(seed: int, cfg: Mamba2Config, device=None,
                       dtype=torch.float32):
    """Random params with the JAX init_mamba2_params laws (embedding
    N(0, 0.02^2), matrices U(-1/sqrt(fan_in), 1/sqrt(fan_in)), conv
    N(0, 1/k), dt in [1e-3, 0.1] through the inverse softplus, A_log =
    log(1..H)), drawn from a torch.Generator seeded with `seed` on `device`
    (default: the CUDA device).  `dtype` is the storage dtype."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = cfg.n_heads

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": ones(cfg.d_model),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        u = torch.rand((h,), generator=gen, device=dev)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
        in_proj = _linear(gen, cfg.d_model, cfg.proj_out, dtype)
        conv_w = torch.randn((cfg.d_conv, cfg.conv_dim), generator=gen,
                             device=dev) * (1 / math.sqrt(cfg.d_conv))
        params["layers"].append({
            "norm": ones(cfg.d_model),
            "in_proj": in_proj,
            "conv_w": conv_w.to(dtype),
            "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=dev),
            "dt_bias": (dt0 + torch.log(-torch.expm1(-dt0))).to(dtype),
            "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                            device=dev)).to(dtype),
            "D": ones(h),
            "mixer_norm": ones(cfg.d_inner),
            "out_proj": _linear(gen, cfg.d_inner, cfg.d_model, dtype),
        })
    return params


# y @ w in y's dtype with an fp32 result (preferred_element_type=float32)
_mm = _plain_mm


def _gated_rms(y, gate, w, eps):
    """HF MambaRMSNormGated: y * silu(gate) first, THEN RMS-normalized
    (fp32 result)."""
    yf = y.float() * F.silu(gate.float())
    inv = torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)
    return yf * inv * w.float()


def _segsum_decay(a):
    """a (..., c) per-step log-decays -> L (..., c, c) with
    L[i, j] = exp(sum_{k=j+1..i} a_k) for i >= j else 0 (the SSD
    'attention mask').  The upper triangle's exponent is -inf before the
    exponential, so no inf enters the product and no 0 * inf its
    gradient."""
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    c = a.shape[-1]
    upper = torch.ones((c, c), dtype=torch.bool, device=a.device).triu(1)
    return torch.exp(s.masked_fill(upper, float("-inf")))


def ssd(x, dt_a, bm, c, chunk: int):
    """The chunked state-space duality operator.

    x (B, L, H, P) fp32 values already discretized (x * dt), dt_a (B, L, H)
    fp32 per-step log-decay (A * dt), bm / c (B, L, H, N) fp32 (groups
    expanded).  L % chunk == 0.  Returns y (B, L, H, P).

    Intra-chunk: Y_diag = (C B^T o decay) x, matmuls.  Inter-chunk: the
    boundary states walk L / chunk steps of (B, H, N, P) elementwise work,
    then Y_off = decay * C . h_start."""
    b, L, h, p = x.shape
    n = bm.shape[-1]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc = L // chunk

    def ck(t):  # (B, L, ...) -> (B, nc, chunk, ...)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, ac, bc, cc = ck(x), ck(dt_a), ck(bm), ck(c)
    a_cum = torch.cumsum(ac, dim=2)  # (B, nc, cs, H)

    # intra-chunk (the attention-like matmul block)
    decay = _segsum_decay(ac.permute(0, 1, 3, 2))  # (B, nc, H, cs, cs)
    scores = torch.einsum("bzihn,bzjhn->bzhij", cc, bc)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", scores * decay, xc)

    # per-chunk input states (B terms decayed to the chunk end)
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B, nc, cs, H)
    states = torch.einsum("bzjhn,bzjhp->bzhnp", bc * decay_states[..., None],
                          xc)

    # inter-chunk recurrence over the nc chunk boundaries: the state
    # ENTERING each chunk is the previous chunk's end state
    a_tot = torch.exp(a_cum[:, :, -1, :])  # (B, nc, H)
    hst = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    starts = []
    for z in range(nc):
        starts.append(hst)
        hst = a_tot[:, z, :, None, None] * hst + states[:, z]
    h_start = torch.stack(starts, dim=1)  # (B, nc, H, N, P)

    y_off = torch.einsum("bzihn,bzhnp->bzihp", cc, h_start) \
        * torch.exp(a_cum)[..., None]
    return (y_diag + y_off).reshape(b, L, h, p)


def _split_proj(proj, cfg: Mamba2Config):
    di = cfg.d_inner
    gate = proj[..., :di]
    xbc = proj[..., di:di + cfg.conv_dim]
    dt = proj[..., di + cfg.conv_dim:]
    return gate, xbc, dt


def _expand_groups(t, cfg: Mamba2Config):
    """(.., G, N) -> (.., H, N) by repeating each group H/G times."""
    return torch.repeat_interleave(t, cfg.n_heads // cfg.n_groups, dim=-2)


def _split_xbc(xbc, cfg: Mamba2Config):
    """fp32 (xs, B, C) of the conv'd x|B|C channels, B and C with the
    groups expanded to the heads: (.., d_inner), (.., H, N), (.., H, N)."""
    di, gn, n = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.d_state
    lead = tuple(xbc.shape[:-1])
    xs = xbc[..., :di].float()
    bm = xbc[..., di:di + gn].float().reshape(lead + (cfg.n_groups, n))
    c = xbc[..., di + gn:].float().reshape(lead + (cfg.n_groups, n))
    return xs, _expand_groups(bm, cfg), _expand_groups(c, cfg)


def mamba2_mixer(x, p, cfg: Mamba2Config):
    """One mixer over (B, L, d_model) -> (B, L, d_model) fp32, SSD parallel
    form."""
    b, L, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    proj = _mm(x, p["in_proj"]).to(x.dtype)
    gate, xbc, dt = _split_proj(proj, cfg)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"])).to(x.dtype)
    xs, bm, c = _split_xbc(xbc, cfg)

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, L, H)
    a = -torch.exp(p["A_log"].float())  # (H,)
    xh = xs.reshape(b, L, h, hd)
    # D skip on the UNdiscretized x; SSD consumes x * dt
    y = ssd(xh * dt[..., None], dt * a, bm, c, _pick_chunk(L, cfg))
    y = y + xh * p["D"].float()[:, None]
    y = y.reshape(b, L, cfg.d_inner)
    y = _gated_rms(y, gate, p["mixer_norm"], cfg.norm_eps)
    return _mm(y.to(x.dtype), p["out_proj"])


def _pick_chunk(L, cfg: Mamba2Config):
    if L % cfg.chunk_size == 0:
        return cfg.chunk_size
    for c in (64, 32, 16, 8, 4, 2, 1):
        if L % c == 0:
            return c
    return 1


def forward(params, tokens, cfg: Mamba2Config):
    """tokens (B, L) integers -> fp32 logits (B, L, vocab); tied head."""
    x = params["embed"][tokens.long()].to(cfg.act_dtype)
    for p in params["layers"]:
        y = rms_norm(x, p["norm"], cfg.norm_eps)
        x = x + mamba2_mixer(y, p, cfg).to(x.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _plain_mm(x, params["embed"].t())


def loss_fn(params, tokens, targets, cfg: Mamba2Config,
            ignore_index: int | None = IGNORE):
    return token_nll(forward(params, tokens, cfg), targets, ignore_index)


def make_mamba2_train_step(cfg: Mamba2Config, oc=None, device=None):
    """train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss) on `device` (default: the CUDA device); the update is in place
    (models/train.py)."""
    from .train import OptConfig, make_loss_train_step

    return make_loss_train_step(lambda p, t, y: loss_fn(p, t, y, cfg),
                                oc or OptConfig(lr=1e-3), device)


# -- recurrent decode (O(1) per token) ----------------------------------------


def init_mamba2_state(cfg: Mamba2Config, batch: int, device=None):
    """Per-layer recurrent state: the SSM state (B, H, head_dim, N) fp32 and
    the conv tail (B, k - 1, conv_dim) in the activation dtype."""
    dev = resolve_device(device)
    return [
        {"ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                            dtype=torch.float32, device=dev),
         "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                             dtype=cfg.act_dtype, device=dev)}
        for _ in range(cfg.n_layers)
    ]


def _mixer_step(x, p, state, cfg: Mamba2Config):
    """One token through one mixer: x (B, d_model) -> (out, new state)."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    proj = _mm(x, p["in_proj"]).to(x.dtype)
    gate, xbc, dt = _split_proj(proj, cfg)
    window = torch.cat([state["conv"], xbc[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xs, bm, c = _split_xbc(F.silu(conv), cfg)  # fp32, (B, di), (B, H, N)
    xs = xs.reshape(b, h, hd)

    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, H)
    a = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * a)  # (B, H)
    ssm = (dA[..., None, None] * state["ssm"]
           + (dt[..., None] * xs)[..., None] * bm[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm, c) + xs * p["D"].float()[:, None]
    y = _gated_rms(y.reshape(b, cfg.d_inner), gate, p["mixer_norm"],
                   cfg.norm_eps)
    out = _mm(y.to(x.dtype), p["out_proj"])
    return out, {"ssm": ssm, "conv": window[:, 1:]}


def _token_step(params, tok, states, cfg: Mamba2Config):
    """One token (B,) through the whole stack -> (logits (B, V), states)."""
    x = params["embed"][tok.long()].to(cfg.act_dtype)
    new_states = []
    for p, st in zip(params["layers"], states):
        y = rms_norm(x, p["norm"], cfg.norm_eps)
        out, st = _mixer_step(y, p, st, cfg)
        x = x + out.to(x.dtype)
        new_states.append(st)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _plain_mm(x, params["embed"].t()), new_states


def generate(params, prompt, cfg: Mamba2Config, max_new_tokens: int = 32,
             eos_id: int = -1):
    """Greedy generation: the prompt streams through the recurrent step
    (teacher-forced), then new tokens follow.  prompt (B, S) integers on the
    params' device -> (B, max_new_tokens) int32; slots after an EOS are 0
    (mamba.greedy_decode)."""
    return greedy_decode(
        lambda tok, st, _: _token_step(params, tok, st, cfg),
        init_mamba2_state(cfg, prompt.shape[0], prompt.device), prompt,
        max_new_tokens, eos_id)


# -- HuggingFace interop (Mamba2ForCausalLM) ----------------------------------


def config_from_hf_mamba2(hf_config, dtype: str = "bfloat16"
                          ) -> Mamba2Config:
    g = (lambda k, d=None: hf_config.get(k, d)) if isinstance(
        hf_config, dict) else (lambda k, d=None: getattr(hf_config, k, d))
    return Mamba2Config(
        vocab_size=g("vocab_size"),
        d_model=g("hidden_size"),
        n_layers=g("num_hidden_layers"),
        n_heads=g("num_heads"),
        head_dim=g("head_dim"),
        d_state=g("state_size", 128),
        n_groups=g("n_groups", 1),
        d_conv=g("conv_kernel", 4),
        expand=g("expand", 2),
        chunk_size=g("chunk_size", 256),
        norm_eps=g("layer_norm_epsilon", 1e-5),
        dtype=dtype,
    )


def params_from_hf_mamba2(state_dict, cfg: Mamba2Config, device=None):
    """Mamba2ForCausalLM state_dict -> the params (fp32) on `device`
    (default: the CUDA device), each tensor widened and transposed there.
    HF Linears are (out, in) -> transposed; conv1d.weight (conv_dim, 1, k)
    -> (k, conv_dim).  The head is tied to the embedding, as in the JAX
    package (an untied lm_head is not read)."""
    r = _Reader(state_dict, resolve_device(device))
    params = {"embed": r.A("backbone.embeddings.weight"),
              "final_norm": r.A("backbone.norm_f.weight"), "layers": []}
    for i in range(cfg.n_layers):
        m = f"backbone.layers.{i}.mixer"
        params["layers"].append({
            "norm": r.A(f"backbone.layers.{i}.norm.weight"),
            "in_proj": r.W(f"{m}.in_proj.weight"),
            "conv_w": r.A(f"{m}.conv1d.weight")[:, 0, :].t().contiguous(),
            "conv_b": r.A(f"{m}.conv1d.bias"),
            "dt_bias": r.A(f"{m}.dt_bias"),
            "A_log": r.A(f"{m}.A_log"),
            "D": r.A(f"{m}.D"),
            "mixer_norm": r.A(f"{m}.norm.weight"),
            "out_proj": r.W(f"{m}.out_proj.weight"),
        })
    return params


def from_hf_mamba2(model_or_path, dtype: str = "bfloat16", device=None):
    """(params, cfg) from a checkpoint directory (read without
    transformers) or a transformers model instance (anything with .config
    and .state_dict())."""
    if is_checkpoint_path(model_or_path):
        raw, sd = read_hf_dir(model_or_path)
        cfg = config_from_hf_mamba2(raw, dtype=dtype)
    else:
        cfg = config_from_hf_mamba2(model_or_path.config, dtype=dtype)
        sd = model_or_path.state_dict()
    return params_from_hf_mamba2(sd, cfg, device), cfg
