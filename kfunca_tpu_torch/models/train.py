"""Training step: loss -> grad -> optimizer update on one device.

Counterpart of kfunca_tpu/models/train.py.  The optimizers are written out
over the params tree: adamw (default), sgd with nesterov, lion, adafactor
(factored second moments) and muon (Newton-Schulz orthogonalized momentum
for matrices, adamw for 1-D leaves), with fp32 master params and moments,
linear-warmup + cosine-decay schedule, global-norm clipping, the no-decay
mask for 1-D params, a params EMA, and in-step gradient accumulation.

Scalars of the update (step, lr, bias corrections, the clip scale) are
0-dim fp32 tensors on the params' device, computed in fp32 as the JAX
package computes them, and never read back to the host inside the step.

The JAX step is a pure function whose buffers the caller donates; here the
update runs under torch.no_grad() and WRITES params and moments in place,
returning the same tensors in new containers: a caller who needs the old
values clones them first.

make_sharded_train_step runs the same step over a (dp, tp) mesh
(parallel/mesh.py): params a ShardedParams, the optimizer state a list of
per-rank states shaped like each rank's params, gradients all-reduced over
dp (fsdp leaves reduce-scattered by the backward of their all-gather).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import collectives as cc
from ..parallel.mesh import Shard, ShardedParams, gather_leaf
from ..runtime.backend import resolve_device
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .transformer import (
    TransformerConfig, loss_fn, loss_fn_chunked, rank_batches, tp_token_nll,
)

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    """The JAX package's OptConfig, field for field."""

    # "adamw", "sgd" (momentum/nesterov), "lion" (sign-momentum),
    # "adafactor" (factored second moments) or "muon"
    algo: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    # linear warmup over warmup_steps, then cosine decay to lr * min_lr_frac
    # at total_steps (None: constant lr)
    warmup_steps: int = 0
    total_steps: int | None = None
    min_lr_frac: float = 0.1
    clip_norm: float | None = None  # global-norm clipping (None: off)
    decay_mask_1d: bool = True  # no weight decay on 1-D params
    ema_decay: float | None = None  # fp32 "ema" tree in opt_state
    muon_beta: float = 0.95
    # moment STORAGE dtype, "float32" or "bfloat16"; moments compute in fp32
    # every step (cast in, cast out); master params and the EMA stay fp32
    state_dtype: str = "float32"


def _f32(x) -> float:
    """x rounded to fp32, as a Python float (exact in fp32 arithmetic)."""
    return float(np.float32(x))


def schedule_lr(oc: OptConfig, step):
    """lr at `step` (1-based; a 0-dim tensor or a number) as a 0-dim fp32
    tensor: warmup -> cosine -> floor."""
    t = step.float() if isinstance(step, torch.Tensor) else torch.tensor(
        float(step), dtype=torch.float32)
    lr = torch.full_like(t, oc.lr)
    if oc.warmup_steps > 0:
        lr = lr * torch.clamp(t / _f32(oc.warmup_steps), max=1.0)
    if oc.total_steps is not None:
        frac = (t - oc.warmup_steps) / _f32(
            max(1, oc.total_steps - oc.warmup_steps))
        frac = torch.clamp(frac, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        floor = _f32(oc.min_lr_frac)
        lr = lr * (floor + _f32(np.float32(1.0) - np.float32(floor)) * cos)
    return lr


def global_norm(grads):
    leaves = tree_leaves(grads)
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))


def check_params_device(params, device):
    """`device`, after checking that every params leaf lives on it."""
    devices = {p.device for p in tree_leaves(params)}
    if devices != {device}:
        raise ValueError(f"params are on {sorted(map(str, devices))}, this "
                         f"call runs on {device}")
    return device


def init_opt_state(params, oc: OptConfig | None = None, device=None):
    """Optimizer state for oc.algo (default adamw) on `device` (default: the
    CUDA device; params must already be there).

    adamw: m + v per param.  sgd / lion: m only.  adafactor: for ndim >= 2
    leaves, row means `vr` (shape[:-1]) and column means `vc`
    (shape[:-2] + (n,)) replace the full v; ndim < 2 leaves keep a full
    `v1`.  Unused slots hold 0-dim zeros so every field stays a
    params-shaped tree.

    With a ShardedParams: the list of each held rank's state, from its
    own params on the mesh's device (the state shards like its params;
    adafactor's factored moments like the param less the dropped axis)."""
    if isinstance(params, ShardedParams):
        return [init_opt_state(t, oc, params.mesh.device)
                for t in params.local]
    dev = check_params_device(params, resolve_device(device))
    algo = oc.algo if oc is not None else "adamw"
    sd = _STATE_DTYPES[oc.state_dtype] if oc is not None else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=sd, device=dev)

    def dummy():
        return torch.zeros((), dtype=torch.float32, device=dev)

    def small(p):
        return zeros(p) if p.ndim < 2 else dummy()

    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    if algo in ("adamw", "sgd", "lion", "muon"):
        state["m"] = tree_map(zeros, params)
    if algo == "adamw":
        state["v"] = tree_map(zeros, params)
    if algo == "muon":  # second moment only for the 1-D adamw leaves
        state["v1"] = tree_map(small, params)
    if oc is not None and oc.ema_decay is not None:
        state["ema"] = tree_map(lambda p: p.detach().float().clone(), params)
    if algo == "adafactor":
        f32 = dict(dtype=torch.float32, device=dev)
        state["vr"] = tree_map(
            lambda p: torch.zeros(p.shape[:-1], **f32) if p.ndim >= 2
            else dummy(), params)
        state["vc"] = tree_map(
            lambda p: torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
            if p.ndim >= 2 else dummy(), params)
        state["v1"] = tree_map(small, params)
    return state


def _clip_and_lr(grads, opt_state, oc: OptConfig):
    step = opt_state["step"] + 1
    gscale = 1.0
    if oc.clip_norm is not None:
        gn = global_norm(grads)
        gscale = torch.clamp(_f32(oc.clip_norm) / (gn + 1e-12), max=1.0)
    return step, schedule_lr(oc, step), gscale


def _wd(p, oc: OptConfig) -> float:
    return oc.weight_decay if (p.ndim >= 2 or not oc.decay_mask_1d) else 0.0


def _leafwise(upd, params, grads, *states):
    """upd(p, g, *state leaves) on every leaf; it writes p and its state
    leaves in place."""
    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      *(tree_leaves(s) for s in states)):
        upd(*leaves)


def _adamw_rule(oc: OptConfig, step, lr, gscale):
    t = step.float()
    bc1 = 1.0 - oc.beta1 ** t
    bc2 = 1.0 - oc.beta2 ** t

    def upd(p, g, m, v):
        g = g.float() * gscale
        m32 = oc.beta1 * m.float() + (1 - oc.beta1) * g
        v32 = oc.beta2 * v.float() + (1 - oc.beta2) * g * g
        p.sub_(lr * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps)
                     + _wd(p, oc) * p))
        m.copy_(m32)  # rounds to the storage dtype
        v.copy_(v32)

    return upd


def _sgd_rule(oc: OptConfig, step, lr, gscale):
    """SGD with momentum (optionally Nesterov) + decoupled weight decay."""
    mu = _f32(oc.momentum)

    def upd(p, g, m):
        g = g.float() * gscale
        m32 = mu * m.float() + g
        u = g + mu * m32 if oc.nesterov else m32
        p.sub_(lr * (u + _wd(p, oc) * p))
        m.copy_(m32)

    return upd


def _lion_rule(oc: OptConfig, step, lr, gscale):
    """Lion: sign of a beta1-interpolated momentum; one moment, update
    magnitude == lr exactly."""

    def upd(p, g, m):
        g = g.float() * gscale
        m32 = m.float()
        u = torch.sign(oc.beta1 * m32 + (1 - oc.beta1) * g)
        p.sub_(lr * (u + _wd(p, oc) * p))
        m.copy_(oc.beta2 * m32 + (1 - oc.beta2) * g)

    return upd


def _adafactor_rule(oc: OptConfig, step, lr, gscale):
    """Adafactor, momentum-free: factored second moments for matrices
    (row/col mean-square EMAs), full v for 1-D leaves; decay 1 - t^-0.8;
    update RMS-clipped at 1.0."""
    b2 = 1.0 - step.float() ** -0.8
    eps = 1e-30

    def upd(p, g, vr, vc, v1):
        g = g.float() * gscale
        g2 = g * g + eps
        if p.ndim >= 2:
            vr.copy_(b2 * vr + (1 - b2) * g2.mean(dim=-1))
            vc.copy_(b2 * vc + (1 - b2) * g2.mean(dim=-2))
            # rank-1 reconstruction, normalized by the shared total mean
            denom = vr.mean(dim=-1, keepdim=True)
            vhat = vr[..., :, None] * vc[..., None, :] / denom[..., None]
        else:
            vhat = b2 * v1.float() + (1 - b2) * g2
            v1.copy_(vhat)
        u = g / torch.sqrt(vhat)
        # clip the update's RMS to 1.0
        rms_u = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms_u, min=1.0)
        p.sub_(lr * (u + _wd(p, oc) * p))

    return upd


def _newton_schulz5(g, steps: int = 5):
    """Approximate orthogonalization of a (..., r, c) matrix: 5 iterations
    of the quintic Newton-Schulz polynomial (Muon's coefficients) on the
    Frobenius-normalized input, in fp32; a tall matrix is iterated on its
    wide orientation, where x @ x.T is smallest."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g / (torch.linalg.matrix_norm(g, keepdim=True) + 1e-7)
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.transpose(-2, -1)
    for _ in range(steps):
        A = x @ x.transpose(-2, -1)
        B = b * A + c * (A @ A)
        x = a * x + B @ x
    return x.transpose(-2, -1) if transposed else x


def _muon_rule(oc: OptConfig, step, lr, gscale):
    """Muon: nesterov momentum orthogonalized by Newton-Schulz for every
    >= 2-D param, scaled by sqrt(max(1, r/c)); ndim < 2 leaves run the
    adamw rule."""
    mu = _f32(oc.muon_beta)
    t = step.float()
    bc1 = 1.0 - oc.beta1 ** t
    bc2 = 1.0 - oc.beta2 ** t

    def upd(p, g, m, v1):
        g = g.float() * gscale
        if p.ndim >= 2:
            m32 = mu * m.float() + g
            o = _newton_schulz5(g + mu * m32)  # nesterov-style lookahead
            scale = _f32(math.sqrt(max(1.0, p.shape[-2] / p.shape[-1])))
            p.sub_(lr * (scale * o + _wd(p, oc) * p))
            m.copy_(m32)
            return
        m32 = oc.beta1 * m.float() + (1 - oc.beta1) * g
        v32 = oc.beta2 * v1.float() + (1 - oc.beta2) * g * g
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps)
        p.sub_(lr * (u + _wd(p, oc) * p))
        m.copy_(m32)
        v1.copy_(v32)

    return upd


# algo -> (the per-leaf rule's factory, the state fields it updates)
_RULES = {
    "adamw": (_adamw_rule, ("m", "v")),
    "sgd": (_sgd_rule, ("m",)),
    "lion": (_lion_rule, ("m",)),
    "adafactor": (_adafactor_rule, ("vr", "vc", "v1")),
    "muon": (_muon_rule, ("m", "v1")),
}


def _update(algo, params, grads, opt_state, oc: OptConfig):
    step, lr, gscale = _clip_and_lr(grads, opt_state, oc)
    rule, keys = _RULES[algo]
    _leafwise(rule(oc, step, lr, gscale), params, grads,
              *(opt_state[k] for k in keys))
    return params, {"step": step, **{k: opt_state[k] for k in keys}}


def adamw_update(params, grads, opt_state, oc: OptConfig):
    return _update("adamw", params, grads, opt_state, oc)


def sgd_update(params, grads, opt_state, oc: OptConfig):
    return _update("sgd", params, grads, opt_state, oc)


def lion_update(params, grads, opt_state, oc: OptConfig):
    return _update("lion", params, grads, opt_state, oc)


def adafactor_update(params, grads, opt_state, oc: OptConfig):
    return _update("adafactor", params, grads, opt_state, oc)


def muon_update(params, grads, opt_state, oc: OptConfig):
    return _update("muon", params, grads, opt_state, oc)


def _check_algo(oc: OptConfig) -> None:
    if oc.algo not in _RULES:
        raise ValueError(f"unknown optimizer algo {oc.algo!r}; one of "
                         f"{sorted(_RULES)}")


def _update_ema(ema, params, oc: OptConfig) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    d = np.float32(oc.ema_decay)
    keep, take = float(d), float(np.float32(1.0) - d)
    for e, p in zip(tree_leaves(ema), tree_leaves(params)):
        e.copy_(keep * e + take * p.float())


@torch.no_grad()
def apply_update(params, grads, opt_state, oc: OptConfig):
    """Dispatch to oc.algo's update rule (state from init_opt_state(p, oc));
    maintains the params EMA afterwards when oc.ema_decay is set.  Params
    and state leaves are updated in place."""
    _check_algo(oc)
    new_params, new_state = _update(oc.algo, params, grads, opt_state, oc)
    if oc.ema_decay is not None:
        _update_ema(opt_state["ema"], new_params, oc)
        new_state["ema"] = opt_state["ema"]
    return new_params, new_state


def ema_params(opt_state, dtype=None):
    """The EMA params tree (requires OptConfig(ema_decay=...)); cast to
    `dtype` if given: the smoothed weights for eval/serving."""
    ema = opt_state["ema"]
    if dtype is not None:
        ema = tree_map(lambda e: e.to(dtype), ema)
    return ema


def _value_and_grad(loss, params, tokens, targets):
    """(loss, grads) of loss(params, tokens, targets) by autograd over the
    param leaves; a leaf the loss does not reach (a MoE expert no token
    chose, the router bias that only chooses) gets zeros, as under
    jax.grad."""
    loss_v, _, grads = value_and_grad_aux(
        lambda p: (loss(p, tokens, targets), None), params)
    return loss_v, grads


def value_and_grad_aux(fn, params):
    """(loss, aux, grads) of `(loss, aux) = fn(params)` by autograd over
    the param leaves (zeros for a leaf the loss does not reach):
    jax.value_and_grad(fn, has_aux=True).  The train steps of models/dpo.py,
    rlhf.py and distill.py take it."""
    # views that share the masters' storage and carry the gradient
    views = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss_v, aux = fn(tree_unflatten(params, views))
    grads = torch.autograd.grad(loss_v, views, allow_unused=True,
                                materialize_grads=True)
    return loss_v.detach(), aux, tree_unflatten(params, grads)


def make_train_step(cfg: TransformerConfig, oc: OptConfig = OptConfig(),
                    grad_accum: int = 1, loss_chunk: int | None = None,
                    ignore_index: int | None = None,
                    with_metrics: bool = False, device=None):
    """Returns train_step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss) on `device` (default: the CUDA device; raises without
    one).  params and opt_state must be on that device; tokens and targets
    (numpy arrays or tensors) are moved there.

    Gradients come from torch.autograd.grad over the param leaves; the
    params are fp32 masters and every use casts them to cfg.act_dtype.
    The update writes params and moments in place (see the module
    docstring), so the returned trees hold the tensors that came in.

    grad_accum > 1 splits the batch into that many microbatches and sums
    their fp32 gradients before ONE update: activations live for one
    microbatch at a time.  loss_chunk streams the LM head in vocab chunks
    of that width (transformer.loss_fn_chunked).  ignore_index masks loss
    positions whose target equals it.  with_metrics=True returns
    {"loss", "grad_norm" (pre-clip), "lr", "step"} in place of the loss."""
    dev = resolve_device(device)

    def loss(params, tokens, targets):
        if loss_chunk is None:
            return loss_fn(params, tokens, targets, cfg,
                           ignore_index=ignore_index)
        return loss_fn_chunked(params, tokens, targets, cfg, loss_chunk,
                               ignore_index=ignore_index)

    def stats(loss_v, grads, opt_state):
        if not with_metrics:
            return loss_v
        step = opt_state["step"] + 1
        return {"loss": loss_v, "grad_norm": global_norm(grads),
                "lr": schedule_lr(oc, step), "step": step}

    def on_device(x):
        return torch.as_tensor(x).to(dev, non_blocking=True)

    def train_step(params, opt_state, tokens, targets):
        check_params_device(params, dev)
        tokens, targets = on_device(tokens), on_device(targets)
        if grad_accum <= 1:
            loss_v, grads = _value_and_grad(loss, params, tokens, targets)
        else:
            b = tokens.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum={grad_accum}")
            mb = b // grad_accum
            g_sum, l_sum = None, 0.0
            for i in range(grad_accum):
                loss_i, g = _value_and_grad(loss, params,
                                            tokens[i * mb:(i + 1) * mb],
                                            targets[i * mb:(i + 1) * mb])
                g = tree_map(lambda x: x.float(), g)
                g_sum = g if g_sum is None else tree_map(
                    lambda a, x: a.add_(x), g_sum, g)
                l_sum = l_sum + loss_i
            inv = _f32(1.0 / grad_accum)
            grads = tree_map(lambda x: x.mul_(inv), g_sum)
            loss_v = l_sum * inv
        with torch.no_grad():
            out = stats(loss_v, grads, opt_state)
            params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, out

    return train_step


def _to_device(x, dev):
    """x (an array or a tuple / list of them) as tensors on dev."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(t, dev) for t in x)
    return torch.as_tensor(x).to(dev, non_blocking=True)


def make_loss_train_step(loss, oc: OptConfig, device=None):
    """train_step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss) for any model's loss(params, tokens, targets): autograd over the
    param leaves, then apply_update in place, as make_train_step does.  The
    step of the Mamba, Mamba-2 and hybrid families (their JAX steps are
    value_and_grad + apply_update); `tokens` may be a tuple of inputs (the
    multimodal LM's (images, tokens)), each moved to the device."""
    dev = resolve_device(device)

    def train_step(params, opt_state, tokens, targets):
        check_params_device(params, dev)
        tokens = _to_device(tokens, dev)
        targets = _to_device(targets, dev)
        loss_v, grads = _value_and_grad(loss, params, tokens, targets)
        params, opt_state = apply_update(params, grads, opt_state, oc)
        return params, opt_state, loss_v

    return train_step


# -- the step over a (dp, tp) mesh ----------------------------------------------


def _state_shard(key: str, shard: Shard) -> Shard:
    """How an optimizer-state leaf lies, from its param's Shard: m, v and
    ema as the param; adafactor's vr drops the last axis, vc the one
    before it, for matrices; 0-dim placeholders are replicated."""
    nd = len(shard.shape)
    if key in ("vr", "vc") and nd >= 2:
        drop = nd - 1 if key == "vr" else nd - 2

        def keep(d):
            return None if d is None or d == drop else d - (d > drop)

        tp_dim = keep(shard.tp_dim)
        return Shard(shard.shape[:drop] + shard.shape[drop + 1:],
                     keep(shard.dp_dim), tp_dim,
                     shard.qkv if tp_dim is not None else None,
                     shard.halves and tp_dim is not None,
                     tuple((a, keep(d)) for a, d in shard.more
                           if keep(d) is not None))
    if (key in ("vr", "vc") or (key == "v1" and nd >= 2)):
        return Shard(())
    return shard


def sharded_opt_state(sp: ShardedParams, states) -> ShardedParams:
    """The per-rank optimizer states of a step over sp's mesh as one
    ShardedParams (for gather_params, save_sharded and load_sharded): each
    field lies as _state_shard says, the step counter replicated."""
    shards = {k: Shard(()) if k == "step" else
              tree_map(lambda s, k=k: _state_shard(k, s), sp.shards)
              for k in states[0]}
    return ShardedParams(sp.mesh, list(states), shards, None, sp.cfg,
                         sp.fsdp)


def sharded_global_norm(sp: ShardedParams, grads) -> list:
    """Each held rank's global gradient norm: every shard of a split leaf
    counted once, a replicated leaf once (not once a rank)."""
    mesh = sp.mesh
    parts = {}
    for shard, gs in zip(tree_leaves(sp.shards),
                         zip(*(tree_leaves(g) for g in grads))):
        acc = parts.setdefault(shard.axes, [0.0] * len(gs))
        for i, g in enumerate(gs):
            acc[i] = acc[i] + torch.sum(g.float() ** 2)
    total = [torch.zeros((), device=mesh.device) for _ in mesh.ranks]
    for axes, acc in sorted(parts.items()):
        acc = [torch.as_tensor(a, device=mesh.device) for a in acc]
        for axis in axes:
            acc = cc.all_reduce(acc, mesh, axis)
        total = [t + a for t, a in zip(total, acc)]
    return [torch.sqrt(t) for t in total]


@torch.no_grad()
def sharded_apply_update(sp: ShardedParams, grads, states, oc: OptConfig,
                         norms=None):
    """apply_update over a mesh, in place on each held rank's leaves.  The
    elementwise rules (adamw, sgd, lion, muon's 1-D leaves) run on each
    rank's piece; adafactor's means and muon's Newton-Schulz need the
    whole matrix, so a split leaf is gathered, updated whole and each
    rank takes its piece back.  `norms` is sharded_global_norm's result
    when the caller has it.  Returns the list of new states."""
    _check_algo(oc)
    mesh = sp.mesh
    rule_of, keys = _RULES[oc.algo]
    steps = [st["step"] + 1 for st in states]
    lrs = [schedule_lr(oc, s) for s in steps]
    gscales = [1.0] * len(states)
    if oc.clip_norm is not None:
        norms = norms if norms is not None else sharded_global_norm(sp, grads)
        gscales = [torch.clamp(_f32(oc.clip_norm) / (n + 1e-12), max=1.0)
                   for n in norms]
    rules = [rule_of(oc, s, lr, g) for s, lr, g in zip(steps, lrs, gscales)]
    per_rank = [
        [tree_leaves(t), tree_leaves(g), *(tree_leaves(st[k]) for k in keys)]
        for t, g, st in zip(sp.local, grads, states)]
    for i, shard in enumerate(tree_leaves(sp.shards)):
        items = [[col[i] for col in leaves] for leaves in per_rank]
        whole = oc.algo == "adafactor" or (oc.algo == "muon"
                                           and len(shard.shape) >= 2)
        if not (whole and shard.axes):
            for rule, args in zip(rules, items):
                rule(*args)
            continue
        shards = [shard, shard] + [_state_shard(k, shard) for k in keys]
        fulls = [gather_leaf(mesh, sh, [it[j] for it in items])[0]
                 for j, sh in enumerate(shards)]
        rules[0](*fulls)  # every held rank's copy is the same: update once
        for r, it in zip(mesh.ranks, items):
            for j in (0, *range(2, len(shards))):
                it[j].copy_(shards[j].local(fulls[j], mesh, r))
    new_states = [{"step": s, **{k: st[k] for k in keys}}
                  for s, st in zip(steps, states)]
    if oc.ema_decay is not None:
        for t, st, new in zip(sp.local, states, new_states):
            _update_ema(st["ema"], t, oc)
            new["ema"] = st["ema"]
    return new_states


def make_sharded_train_step(cfg: TransformerConfig, mesh,
                            oc: OptConfig = OptConfig(), fsdp: bool = False,
                            grad_accum: int = 1, loss_chunk: int | None = None,
                            ignore_index: int | None = None,
                            with_metrics: bool = False, device=None):
    """make_train_step over a (dp, tp) mesh (a LocalMesh or a DeviceMesh
    with axes ("dp", "tp")).  Returns step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss or metrics): params from
    shard_params(params, mesh, fsdp, cfg=cfg), opt_state from
    init_opt_state(params, oc), the batch as rank_batches takes it (the
    global batch or its dp stripes under a LocalMesh, this process's stripe
    under a DeviceMesh).  The loss is replicated; params and states are
    updated in place, as make_train_step's.  (The JAX function returns a
    function of the params that jits the step; this one is the step.)

    The loss is the JAX step's: the token mean over the global batch, or
    with grad_accum the mean over the global microbatches (rows
    [a B/A, (a+1) B/A)) of their masked means.  Each rank weights its
    tokens by 1 / (A * count of its global microbatch) (the counts are
    all-reduced over dp), back-propagates its share in microbatches of its
    own stripe, and the gradients are summed over dp: all-reduced, or for
    fsdp leaves reduce-scattered by the backward of the layer's all-gather.
    `device` must be the mesh's device when given."""
    return make_sharded_loss_step(
        lambda sp, toks, tgts: tp_token_nll(sp, toks, tgts, cfg, loss_chunk),
        mesh, oc, grad_accum, ignore_index, with_metrics, device)


def make_sharded_loss_step(token_nll, mesh, oc: OptConfig = OptConfig(),
                           grad_accum: int = 1,
                           ignore_index: int | None = None,
                           with_metrics: bool = False, device=None):
    """The sharded step of any model whose token_nll(sharded_params,
    tokens, targets) gives each held rank's per-token NLL (N,) of its
    stripe, replicated over tp (make_sharded_train_step's,
    mamba.make_sharded_mamba_train_step's)."""
    from ..parallel.mesh import as_mesh

    mesh = as_mesh(mesh)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"the mesh is on {mesh.device}, not {device}")
    _check_algo(oc)

    def weights(tgts):
        """Each held rank's per-token loss weights (rows of its stripe)."""
        bl = tgts[0].shape[0]
        b = bl * mesh.dp
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"grad_accum={grad_accum}")
        mb = b // grad_accum
        masks, groups, counts = [], [], []
        for r, t in zip(mesh.ranks, tgts):
            mask = (torch.ones(t.shape, device=t.device)
                    if ignore_index is None else (t != ignore_index).float())
            rows = (mesh.index(r, "dp") * bl
                    + torch.arange(bl, device=t.device))
            group = rows // mb
            counts.append(torch.zeros(grad_accum, device=t.device)
                          .index_add_(0, group, mask.sum(dim=1)))
            masks.append(mask)
            groups.append(group)
        counts = cc.all_reduce(counts, mesh, "dp")
        return [m / (grad_accum * c.clamp_min(1.0))[g][:, None]
                for m, c, g in zip(masks, counts, groups)]

    def step(params: ShardedParams, opt_state, tokens, targets):
        if params.mesh is not mesh and params.mesh.shape != mesh.shape:
            raise ValueError("params were sharded over another mesh")
        for t in params.local:
            check_params_device(t, mesh.device)
        toks, tgts = rank_batches(mesh, tokens), rank_batches(mesh, targets)
        ws = weights(tgts)
        bl = toks[0].shape[0]
        n_local = math.gcd(grad_accum, bl)
        rows = bl // n_local
        views = [tree_map(lambda p: p.detach().requires_grad_(True), t)
                 for t in params.local]
        vp = ShardedParams(mesh, views, params.shards, params.specs,
                           params.cfg, params.fsdp)
        flat = [v for t in views for v in tree_leaves(t)]
        grads, losses = None, [0.0] * len(toks)
        for i in range(n_local):
            sl = slice(i * rows, (i + 1) * rows)
            with torch.enable_grad():
                nll = token_nll(vp, [t[sl] for t in toks],
                                [t[sl] for t in tgts])
                shares = [(n * w[sl].reshape(-1)).sum()
                          for n, w in zip(nll, ws)]
            g = torch.autograd.grad(sum(shares), flat, allow_unused=True,
                                    materialize_grads=True)
            if n_local > 1:
                g = [x.float() for x in g]
            grads = g if grads is None else [a.add_(x)
                                              for a, x in zip(grads, g)]
            losses = [l + s.detach() for l, s in zip(losses, shares)]
        n = len(flat) // len(views)
        grads = [tree_unflatten(t, grads[j * n:(j + 1) * n])
                 for j, t in enumerate(params.local)]
        with torch.no_grad():
            per_leaf = [list(gs) for gs in zip(*(tree_leaves(g)
                                                  for g in grads))]
            for shard, gs in zip(tree_leaves(params.shards), per_leaf):
                if shard.dp_dim is None:  # fsdp leaves came reduce-scattered
                    gs[:] = cc.all_reduce(gs, mesh, "dp")
            grads = [tree_unflatten(t, [gs[j] for gs in per_leaf])
                     for j, t in enumerate(params.local)]
            loss = cc.all_reduce(losses, mesh, "dp")[0]
            norms = None
            if with_metrics or oc.clip_norm is not None:
                norms = sharded_global_norm(params, grads)
            if with_metrics:
                st = opt_state[0]["step"] + 1
                out = {"loss": loss, "grad_norm": norms[0],
                       "lr": schedule_lr(oc, st), "step": st}
            else:
                out = loss
            new_states = sharded_apply_update(params, grads, opt_state, oc,
                                              norms)
        return params, new_states, out

    return step
