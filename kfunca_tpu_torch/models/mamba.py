"""Mamba-family selective state-space LM: parallel-scan training, O(1) decode.

Counterpart of kfunca_tpu/models/mamba.py.  The parameter layout and the
names are the JAX package's, so models/weights.mamba_params_from_jax
carries a JAX pytree across leaf for leaf.

Block structure (HF MambaForCausalLM's): RMSNorm -> mixer (in_proj ->
causal depthwise conv -> silu -> selective SSM with input-dependent dt, B,
C, A = -exp(A_log), softplus dt -> * silu(gate) -> out_proj), residual,
tied head.  Params fp32, activations cfg.dtype, the scan itself fp32.

The scan engine follows the JAX package's `_ssm_engine`, read on every
call: KFUNCA_SSM_ENGINE=pallas or xla when set; otherwise the selective-scan
kernels (K11, ops/pallas_kernels/ssm_scan.py) for CUDA tensors, of any
shape (the port's kernels mask ragged edges), and the chunked scan for CPU
tensors.  On CPU tensors "pallas" runs the kernels' plain version.  There
is no KFUNCA_FORCE_XLA: the tensors' device picks the route.

Tensor parallelism (`mamba_param_specs`, `shard_mamba_params`, the
ShardedParams forms of `forward` and `make_sharded_mamba_train_step`) is
channel-parallel over d_inner: in_proj (each of its [hidden | gate]
halves), the conv, dt_proj, dt_bias, A_log and D split their d_inner axis
over tp, x_proj and out_proj are row-parallel, the embedding splits
d_model.  Each rank's scan runs on its d_inner / tp channels: on the card
the K11 kernels per rank.  (The JAX package's docstring has GSPMD users set
KFUNCA_SSM_ENGINE=xla, since a pallas_call does not partition; the port
computes each rank's part itself and keeps the kernels.)

Decode is the O(1) recurrent step over a (B, d_inner, d_state) fp32 state
and a (k - 1)-deep conv tail; `generate` runs it in a Python loop (the JAX
package compiles prefill and decode into one lax.scan program).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.pallas_kernels.ssm_scan import LB, _ks_scan, chunked_scan, ssm_scan
from ..parallel import collectives as cc
from ..parallel.mesh import Halves, P, ShardedParams, shard_tree
from ..runtime.backend import resolve_device
from .hf import is_checkpoint_path, read_hf_dir
from .transformer import (_DTYPES, _masked_mean, _plain_mm, join_dp,
                          rank_batches, rms_norm, row_parallel)

IGNORE = -100


@dataclass(frozen=True)
class MambaConfig:
    """The JAX package's MambaConfig, field for field."""

    vocab_size: int = 512
    d_model: int = 256
    n_layers: int = 4
    d_state: int = 16  # SSM state width per channel (HF state_size)
    d_conv: int = 4  # depthwise causal conv kernel (HF conv_kernel)
    expand: int = 2  # d_inner = expand * d_model
    dt_rank: int | None = None  # None = ceil(d_model / 16) (HF "auto")
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # the XLA engine's chunk: sequences longer than this (and divisible by
    # it) scan chunk by chunk, each chunk a log-depth scan
    scan_chunk: int | None = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else math.ceil(
            self.d_model / 16)

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _linear(gen, fan_in, fan_out, dtype):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the JAX _init_linear's law."""
    s = 1.0 / math.sqrt(fan_in)
    u = torch.rand((fan_in, fan_out), generator=gen, device=gen.device)
    return (u * (2 * s) - s).to(dtype)


def init_mamba_mixer(gen, cfg: MambaConfig, dtype=torch.float32):
    """One mixer's params (no norm), drawn from the torch.Generator `gen` on
    its device with the JAX init's laws: shared by the pure-Mamba stack and
    the hybrid stack (models/hybrid.py)."""
    dev = gen.device
    di, ds, r = cfg.d_inner, cfg.d_state, cfg.rank
    # dt_proj bias so that softplus(bias) lands in [1e-3, 1e-1]
    u = torch.rand((di,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    in_proj = _linear(gen, cfg.d_model, 2 * di, dtype)
    conv_w = torch.randn((cfg.d_conv, di), generator=gen, device=dev) * (
        1 / math.sqrt(cfg.d_conv))
    x_proj = _linear(gen, di, r + 2 * ds, dtype)
    dt_proj = _linear(gen, r, di, dtype)
    out_proj = _linear(gen, di, cfg.d_model, dtype)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias.to(dtype),
        # S4D-real initialization: A_n = n + 1 per state column
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                        device=dev)).expand(di, ds)
        .contiguous().to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": out_proj,
    }


def init_mamba_params(seed: int, cfg: MambaConfig, device=None,
                      dtype=torch.float32):
    """Random params with the JAX init_mamba_params laws, drawn from a
    torch.Generator seeded with `seed` on `device` (default: the CUDA
    device).  `dtype` is the storage dtype."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            **init_mamba_mixer(gen, cfg, dtype),
        })
    return params


# y @ w in y's dtype with an fp32 result (the JAX package's
# preferred_element_type=float32)
_mm = _plain_mm


def _causal_conv(x, w, b):
    """Depthwise causal conv over the sequence axis: x (B, L, C), w (k, C),
    b (C), from k shifted adds in x's dtype."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    L = x.shape[1]
    out = None
    for j in range(k):
        term = pad[:, j:j + L] * w[j].to(x.dtype)
        out = term if out is None else out + term
    return out + b.to(x.dtype)


def selective_scan(dA, dBu):
    """h_t = dA_t * h_{t-1} + dBu_t over axis 1 (the sequence), h_0 = 0, as
    one log-depth scan; materializes (B, L, di, N)."""
    return _ks_scan(dA, dBu, 1)[1]


def ssm_apply(hidden, dt, Bm, C, A, D, chunk: int | None = None,
              engine: str = "xla"):
    """The selective-SSM readout y = C . h + D * hidden with u = dt * hidden.

    engine="pallas": the K11 kernels (ops/pallas_kernels/ssm_scan.ssm_scan;
    their plain version on CPU tensors).  engine="xla": the JAX package's
    XLA form, chunked when `chunk` < L (a sequential walk over chunks, each
    a log-depth scan under torch.utils.checkpoint, memory O(B * chunk * di
    * N)), else one scan over the whole sequence."""
    b, L, di = hidden.shape
    u = dt * hidden.float()
    if engine == "pallas":
        lb, _ = _pallas_ssm_blocks(L, di)
        y = ssm_scan(dt, u, Bm, C, A.t().contiguous(), lb)
        return y + hidden.float() * D.float()
    if engine != "xla":
        raise ValueError(f"unknown SSM engine {engine!r}; pallas or xla")
    if chunk is None or chunk >= L:
        dA = torch.exp(dt[..., None] * A)
        h = selective_scan(dA, u[..., None] * Bm[:, :, None, :])
        y = torch.einsum("blin,bln->bli", h, C)
        return y + hidden.float() * D.float()
    if L % chunk:
        raise ValueError(f"sequence length {L} not divisible by scan chunk "
                         f"{chunk}")
    y, _ = chunked_scan(dt, u, Bm, C, A, chunk)
    return y + hidden.float() * D.float()


def _pallas_ssm_blocks(L, di):
    """(lb, channels a block) of the K11 kernels: every shape tiles, since
    the kernels mask the ragged L-block and the channels past di."""
    return LB, 32


def _ssm_engine(cfg, L, di, device=None):
    """Dispatch-time engine choice (the environment is read on every call):
    KFUNCA_SSM_ENGINE when set, else the kernels for CUDA tensors and the
    chunked scan for CPU tensors."""
    eng = os.environ.get("KFUNCA_SSM_ENGINE")
    if eng:
        return eng
    if device is not None and torch.device(device).type == "cuda":
        return "pallas"
    return "xla"


def _conv_hidden(x, p):
    """in_proj, then the causal conv and silu of the hidden half: (hidden,
    gate), each (B, L, channels) in x's dtype."""
    proj = _mm(x, p["in_proj"]).to(x.dtype)
    hidden, gate = proj.chunk(2, dim=-1)
    return (F.silu(_causal_conv(hidden, p["conv_w"], p["conv_b"]))
            .to(x.dtype), gate)


def _scan_out(hidden, gate, sp, p, cfg: MambaConfig):
    """From x_proj's output sp (fp32): the scan over hidden's channels,
    gated, through out_proj (fp32, (B, L, d_model); a partial sum where
    the channels are one rank's)."""
    r, ds = cfg.rank, cfg.d_state
    dt = F.softplus(sp[..., :r] @ p["dt_proj"].float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    L = hidden.shape[1]
    chunk = cfg.scan_chunk if (cfg.scan_chunk and L > cfg.scan_chunk
                               and L % cfg.scan_chunk == 0) else None
    y = ssm_apply(hidden, dt, sp[..., r:r + ds], sp[..., r + ds:], a, p["D"],
                  chunk, engine=_ssm_engine(cfg, L, hidden.shape[-1],
                                            hidden.device))
    y = y * F.silu(gate.float())
    return _mm(y.to(hidden.dtype), p["out_proj"])


def mamba_mixer(x, p, cfg: MambaConfig):
    """One mixer over (B, L, d_model) -> (B, L, d_model) fp32, parallel
    form."""
    hidden, gate = _conv_hidden(x, p)
    return _scan_out(hidden, gate, _mm(hidden, p["x_proj"]), p, cfg)


def forward(params, tokens, cfg: MambaConfig):
    """tokens (B, L) integers -> fp32 logits (B, L, vocab); tied head.
    With a ShardedParams (shard_mamba_params) the batch is split over dp
    and the result joined back, as transformer.forward's."""
    if isinstance(params, ShardedParams):
        sp = params
        xs = tp_hidden(sp, rank_batches(sp.mesh, tokens), cfg)
        return join_dp(sp.mesh, tp_logits(sp, xs))
    x = params["embed"][tokens.long()].to(cfg.act_dtype)
    for p in params["layers"]:
        y = rms_norm(x, p["norm"], cfg.norm_eps)
        x = x + mamba_mixer(y, p, cfg).to(x.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _plain_mm(x, params["embed"].t())


def token_nll(logits, targets, ignore_index):
    """Mean next-token NLL of fp32 logits; targets == ignore_index count
    nothing (the JAX loss_fn's take_along_axis on max(targets, 0))."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = targets.long()
    safe = targets if ignore_index is None else targets.clamp_min(0)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return _masked_mean(nll, targets, ignore_index)


def loss_fn(params, tokens, targets, cfg: MambaConfig,
            ignore_index: int | None = IGNORE):
    return token_nll(forward(params, tokens, cfg), targets, ignore_index)


def make_mamba_train_step(cfg: MambaConfig, oc=None, device=None):
    """train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss) on `device` (default: the CUDA device); the update is in place
    (models/train.py)."""
    from .train import OptConfig, make_loss_train_step

    oc = oc or OptConfig(lr=1e-3)
    return make_loss_train_step(
        lambda p, t, y: loss_fn(p, t, y, cfg), oc, device)


# -- tensor parallelism over d_inner ------------------------------------------


def mamba_param_specs(params) -> dict:
    """Channel-parallel TP over d_inner (the JAX function's specs):
    in_proj / conv / dt_proj / dt_bias / A_log / D split d_inner over tp
    (in_proj each of its [hidden | gate] halves: a Halves spec), x_proj
    and out_proj row-parallel, the embedding over d_model."""
    layers = [{
        "norm": P(),
        "in_proj": Halves(None, "tp"),
        "conv_w": P(None, "tp"),
        "conv_b": P("tp"),
        "x_proj": P("tp", None),  # row-parallel: dt / B / C summed
        "dt_proj": P(None, "tp"),
        "dt_bias": P("tp"),
        "A_log": P("tp", None),
        "D": P("tp"),
        "out_proj": P("tp", None),  # row-parallel: the block output summed
    } for _ in params["layers"]]
    return {"embed": P(None, "tp"), "final_norm": P(), "layers": layers}


def shard_mamba_params(params, mesh) -> ShardedParams:
    """What each held rank of a (dp, tp) mesh holds under
    mamba_param_specs."""
    return shard_tree(params, mamba_param_specs(params), mesh)


def tp_mixer(ys, ps, cfg: MambaConfig, mesh):
    """mamba_mixer over tp, lists over the held ranks: each rank's
    channels through in_proj, the conv and the scan, x_proj's partial sums
    added (then entered again through copy, since every rank's channels
    read all of dt's rank inputs, B and C), out_proj's added."""
    ys = cc.copy(ys, mesh)
    halves = [_conv_hidden(y, p) for y, p in zip(ys, ps)]
    sps = cc.copy(cc.reduce([_mm(h, p["x_proj"]) for (h, _), p in
                             zip(halves, ps)], mesh), mesh)
    return cc.reduce([_scan_out(h, g, sp, p, cfg) for (h, g), sp, p in
                      zip(halves, sps, ps)], mesh)


def tp_hidden(sp: ShardedParams, tokens, cfg: MambaConfig) -> list:
    """Each held rank's final-norm output (replicated over tp) of its
    stripe of tokens."""
    mesh = sp.mesh
    xs = [t["embed"][tok.long()].to(cfg.act_dtype)
          for t, tok in zip(sp.local, tokens)]
    if sp.shards["embed"].tp_dim is not None:
        xs = cc.gather(xs, mesh, "tp", -1)
    for li in range(len(sp.local[0]["layers"])):
        ps = [t["layers"][li] for t in sp.local]
        ys = [rms_norm(x, p["norm"], cfg.norm_eps) for x, p in zip(xs, ps)]
        xs = [x + o.to(x.dtype)
              for x, o in zip(xs, tp_mixer(ys, ps, cfg, mesh))]
    return [rms_norm(x, t["final_norm"], cfg.norm_eps)
            for x, t in zip(xs, sp.local)]


def tp_logits(sp: ShardedParams, xs) -> list:
    """Each held rank's fp32 logits of the tied head: row-parallel over a
    d_model-split embedding (one sum over tp)."""
    heads = [t["embed"].t() for t in sp.local]
    if sp.shards["embed"].tp_dim is None:
        return [_plain_mm(x, h) for x, h in zip(xs, heads)]
    return row_parallel(cc.scatter(xs, sp.mesh, "tp", -1), heads, sp.mesh,
                        _plain_mm, True)


def tp_token_nll(sp: ShardedParams, tokens, targets, cfg: MambaConfig):
    """Per-token NLL (N,) of each held rank's stripe, replicated over tp;
    a target outside [0, vocab) gives a finite value the caller masks."""
    out = []
    for logits, t in zip(tp_logits(sp, tp_hidden(sp, tokens, cfg)),
                         targets):
        logp = torch.log_softmax(logits.float(), dim=-1)
        t = t.long()
        out.append(-logp.gather(-1, t.clamp_min(0)[..., None])[..., 0]
                   .reshape(-1))
    return out


def make_sharded_mamba_train_step(cfg: MambaConfig, mesh, oc=None,
                                  grad_accum: int = 1,
                                  ignore_index: int | None = IGNORE,
                                  with_metrics: bool = False, device=None):
    """make_mamba_train_step over a (dp, tp) mesh, in
    train.make_sharded_train_step's form: step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss), params from
    shard_mamba_params, opt_state from train.init_opt_state(params, oc),
    updated in place.  The loss is loss_fn's (the masked token mean over
    the global batch)."""
    from .train import OptConfig, make_sharded_loss_step

    return make_sharded_loss_step(
        lambda sp, toks, tgts: tp_token_nll(sp, toks, tgts, cfg), mesh,
        oc or OptConfig(lr=1e-3), grad_accum, ignore_index, with_metrics,
        device)


# -- recurrent decode (O(1) per token) ----------------------------------------


def init_mamba_state(cfg: MambaConfig, batch: int, device=None):
    """Per-layer recurrent state: the SSM hidden (B, d_inner, N) fp32 and
    the conv tail (B, k - 1, d_inner) in the activation dtype."""
    dev = resolve_device(device)
    return [
        {"ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                            dtype=torch.float32, device=dev),
         "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                             dtype=cfg.act_dtype, device=dev)}
        for _ in range(cfg.n_layers)
    ]


def _mixer_step(x, p, state, cfg: MambaConfig):
    """One token through one mixer: x (B, d_model) -> (out, new state)."""
    proj = _mm(x, p["in_proj"]).to(x.dtype)
    hidden, gate = proj.chunk(2, dim=-1)  # (B, di)
    window = torch.cat([state["conv"], hidden[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    hidden = F.silu(conv).to(x.dtype)

    r, ds = cfg.rank, cfg.d_state
    sp = _mm(hidden, p["x_proj"])
    dt = F.softplus(sp[..., :r] @ p["dt_proj"].float() + p["dt_bias"].float())
    bm, c = sp[..., r:r + ds], sp[..., r + ds:]
    a = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[..., None] * a)  # (B, di, N)
    dBu = (dt * hidden.float())[..., None] * bm[:, None, :]
    ssm = dA * state["ssm"] + dBu
    y = torch.einsum("bin,bn->bi", ssm, c)
    y = y + hidden.float() * p["D"].float()
    y = y * F.silu(gate.float())
    out = _mm(y.to(x.dtype), p["out_proj"])
    return out, {"ssm": ssm, "conv": window[:, 1:]}


def _token_step(params, tok, states, cfg: MambaConfig):
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


@torch.no_grad()
def greedy_decode(token_step, states, prompt, max_new_tokens: int,
                  eos_id: int):
    """The recurrent families' greedy loop: the prompt (B, S) streams
    through token_step(tok, states, position) -> (logits (B, V), states)
    teacher-forced, then max_new_tokens new tokens follow.  Returns (B,
    max_new_tokens) int32; slots after an EOS are 0 (the JAX generate's
    scan)."""
    b, s = prompt.shape
    logits = None
    for i in range(s):
        logits, states = token_step(prompt[:, i], states, i)
    tok = torch.argmax(logits, dim=-1).int()
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    zero = torch.zeros_like(tok)
    out = []
    for pos in range(s, s + max_new_tokens):
        logits, states = token_step(tok, states, pos)
        nxt = torch.where(done, zero, torch.argmax(logits, dim=-1).int())
        out.append(torch.where(done, zero, tok))
        done = done | (tok == eos_id)
        tok = nxt
    return torch.stack(out, dim=1)


def generate(params, prompt, cfg: MambaConfig, max_new_tokens: int = 32,
             eos_id: int = -1):
    """Greedy generation: the prompt streams through the recurrent step
    (teacher-forced), then new tokens follow.  prompt (B, S) integers on the
    params' device -> (B, max_new_tokens) int32; slots after an EOS are 0."""
    return greedy_decode(
        lambda tok, st, _: _token_step(params, tok, st, cfg),
        init_mamba_state(cfg, prompt.shape[0], prompt.device), prompt,
        max_new_tokens, eos_id)


# -- HuggingFace interop (MambaForCausalLM) -----------------------------------


def _np(t) -> np.ndarray:
    """torch tensor (any dtype incl. bf16) or array-like -> fp32 numpy
    (the JAX package's models/hf._np)."""
    if hasattr(t, "detach"):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def config_from_hf_mamba(hf_config, dtype: str = "bfloat16") -> MambaConfig:
    g = (lambda k, d=None: hf_config.get(k, d)) if isinstance(
        hf_config, dict) else (lambda k, d=None: getattr(hf_config, k, d))
    rank = g("time_step_rank", "auto")
    return MambaConfig(
        vocab_size=g("vocab_size"),
        d_model=g("hidden_size"),
        n_layers=g("num_hidden_layers"),
        d_state=g("state_size", 16),
        d_conv=g("conv_kernel", 4),
        expand=g("expand", 2),
        dt_rank=None if rank == "auto" else int(rank),
        norm_eps=g("layer_norm_epsilon", 1e-5),
        dtype=dtype,
    )


def params_from_hf_mamba(state_dict, cfg: MambaConfig, device=None):
    """MambaForCausalLM state_dict -> the params (fp32) on `device`
    (default: the CUDA device).  HF Linears are (out, in) -> transposed;
    conv1d.weight (d_inner, 1, k) -> (k, d_inner).  Assumes the default
    use_bias=False / use_conv_bias=True layout."""
    dev = resolve_device(device)
    sd = state_dict

    def t(name, transpose=False):
        arr = _np(sd[name])
        return torch.from_numpy(np.ascontiguousarray(
            arr.T if transpose else arr)).to(dev)

    params = {"embed": t("backbone.embeddings.weight"),
              "final_norm": t("backbone.norm_f.weight"), "layers": []}
    for i in range(cfg.n_layers):
        m = f"backbone.layers.{i}.mixer"
        conv = _np(sd[f"{m}.conv1d.weight"])[:, 0, :].T
        params["layers"].append({
            "norm": t(f"backbone.layers.{i}.norm.weight"),
            "in_proj": t(f"{m}.in_proj.weight", True),
            "conv_w": torch.from_numpy(np.ascontiguousarray(conv)).to(dev),
            "conv_b": t(f"{m}.conv1d.bias"),
            "x_proj": t(f"{m}.x_proj.weight", True),
            "dt_proj": t(f"{m}.dt_proj.weight", True),
            "dt_bias": t(f"{m}.dt_proj.bias"),
            "A_log": t(f"{m}.A_log"),
            "D": t(f"{m}.D"),
            "out_proj": t(f"{m}.out_proj.weight", True),
        })
    return params


def from_hf_mamba(model_or_path, dtype: str = "bfloat16", device=None):
    """(params, cfg) from a checkpoint directory (config.json and the
    weights, read by models/hf.py's readers: no transformers) or a
    transformers Mamba model instance."""
    if is_checkpoint_path(model_or_path):
        raw, sd = read_hf_dir(model_or_path)
        cfg = config_from_hf_mamba(raw, dtype=dtype)
    else:
        cfg = config_from_hf_mamba(model_or_path.config, dtype=dtype)
        sd = model_or_path.state_dict()
    return params_from_hf_mamba(sd, cfg, device), cfg


def to_hf_mamba(params, cfg: MambaConfig) -> dict:
    """The params -> a MambaForCausalLM state_dict (numpy fp32)."""
    sd = {"backbone.embeddings.weight": _np(params["embed"]),
          "backbone.norm_f.weight": _np(params["final_norm"])}
    sd["lm_head.weight"] = sd["backbone.embeddings.weight"]
    for i, p in enumerate(params["layers"]):
        m = f"backbone.layers.{i}.mixer"
        sd[f"backbone.layers.{i}.norm.weight"] = _np(p["norm"])
        sd[f"{m}.in_proj.weight"] = _np(p["in_proj"]).T
        sd[f"{m}.conv1d.weight"] = _np(p["conv_w"]).T[:, None, :]
        sd[f"{m}.conv1d.bias"] = _np(p["conv_b"])
        sd[f"{m}.x_proj.weight"] = _np(p["x_proj"]).T
        sd[f"{m}.dt_proj.weight"] = _np(p["dt_proj"]).T
        sd[f"{m}.dt_proj.bias"] = _np(p["dt_bias"])
        sd[f"{m}.A_log"] = _np(p["A_log"])
        sd[f"{m}.D"] = _np(p["D"])
        sd[f"{m}.out_proj.weight"] = _np(p["out_proj"]).T
    return sd
