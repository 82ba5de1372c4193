"""Mixture-of-Experts FFN: top-1 (switch) and top-2 routing with capacity.

Counterpart of kfunca_tpu/models/moe.py, name for name.  Routing keeps the
JAX package's static shapes: a fixed capacity per expert, overflow tokens
dropped (Switch semantics), queues filled in choice-rank order (every
token's first choice is seated before any second choice competes, GShard),
gates renormalized over a token's kept experts, and optional rescue ranks
whose seated counts carry over.  Dispatch and combine are one-hot einsums,
as in the JAX package, which computes them (and the expert products)
outside any Pallas kernel: here they are torch.einsum.

Expert parallelism (`make_moe_ffn_ep`) runs over a mesh axis "ep"
(parallel/mesh.py): tokens split over the axis, w_in / w_out split
E-over-ep, the router replicated, and the dispatch and combine as explicit
tiled all_to_alls (parallel/collectives.all_to_all), whose backwards are
the reverse all_to_alls.  Routing and capacity are computed per sender, so
the result equals each rank's `moe_ffn` over its own tokens with all the
experts, drops included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..parallel import collectives as cc
from ..parallel.mesh import P, ShardedParams, as_mesh, shard_tree
from ..runtime.backend import resolve_device


@dataclass(frozen=True)
class MoEConfig:
    """The JAX package's MoEConfig, field for field."""

    n_experts: int = 8
    capacity_factor: float = 1.25
    d_model: int = 512
    d_ff: int = 1024
    top_k: int = 1  # 1 = switch routing; 2 = GShard-style top-2
    # overflow rescue: tokens whose every top-k choice overflowed compete
    # for the remaining capacity of their next choices, one rank a round
    rescue_ranks: int = 0


def _uniform(gen, shape, s):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (2 * s) - s


def init_moe_params(seed: int, cfg: MoEConfig, device=None):
    """Random params with the JAX init_moe_params laws (U(-1/sqrt(fan_in),
    1/sqrt(fan_in))), drawn from a torch.Generator seeded with `seed` on
    `device` (default: the CUDA device)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    s_in, s_out = 1.0 / math.sqrt(cfg.d_model), 1.0 / math.sqrt(cfg.d_ff)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": _uniform(gen, (d, e), s_in),
            "w_in": _uniform(gen, (e, d, f), s_in),
            "w_out": _uniform(gen, (e, f, d), s_out)}


def _topk_dispatch(probs, e: int, cap: int, top_k: int, rescue_ranks: int = 0):
    """Static-shape top-k routing of probs (T, E): (dispatch (T, E, cap)
    one-hot weights, combine (T, E, cap) gate-weighted, the first-choice
    one-hot (T, E) for the aux loss).  A position past cap seats nothing
    (jax.nn.one_hot's zero row)."""
    return _dispatch_lists([probs], e, cap, top_k, rescue_ranks)[0]


def _dispatch_lists(probs_list, e, cap, top_k, rescue_ranks=0, prefix=None):
    """_topk_dispatch of several ranks' tokens in lockstep.  `prefix`, when
    given, makes them one sequence of tokens in rank order: it maps the
    ranks' per-expert counts of a choice rank to [(the counts of the ranks
    before, the total)], so that a rank's seats follow the earlier ranks'
    (the queues fill as one device's cumsum over all the tokens would)."""
    n_ranks = top_k + rescue_ranks
    dev = probs_list[0].device
    slots = torch.arange(cap, device=dev, dtype=torch.float32)
    states = []
    for probs in probs_list:
        top_probs, top_idx = torch.topk(probs, n_ranks, dim=-1)
        states.append({
            "top": top_probs,
            "onehots": [F.one_hot(top_idx[:, r], e).float()
                        for r in range(n_ranks)],
            "base": torch.zeros((e,), device=dev),
            "seated": torch.zeros((probs.shape[0],), dtype=torch.bool,
                                  device=dev),
            "dispatches": [], "gates": []})
    for r in range(n_ranks):
        ohs = []
        for st in states:
            oh = st["onehots"][r]
            if r >= top_k:  # rescue: only tokens with no seat yet
                oh = oh * (~st["seated"])[:, None].float()
            ohs.append(oh)
        counts = [oh.sum(dim=0) for oh in ohs]
        shares = (prefix(counts) if prefix is not None
                  else [(torch.zeros_like(c), c) for c in counts])
        for st, oh, (before, total) in zip(states, ohs, shares):
            position = ((torch.cumsum(oh, dim=0) - 1.0) * oh
                        + (st["base"] + before)[None, :] * oh)
            pos_in_expert = position.sum(dim=-1)
            keep = (pos_in_expert < cap) & (oh.sum(dim=-1) > 0)
            slot = (pos_in_expert.floor()[:, None] == slots[None, :]).float()
            st["dispatches"].append(oh[:, :, None] * slot[:, None, :]
                                    * keep[:, None, None].float())
            st["gates"].append(st["top"][:, r] * keep.float())
            st["seated"] = st["seated"] | keep
            st["base"] = st["base"] + total
    out = []
    for st in states:
        denom = sum(st["gates"])
        denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
        combine = sum(dsp * (g / denom)[:, None, None]
                      for dsp, g in zip(st["dispatches"], st["gates"]))
        out.append((sum(st["dispatches"]), combine, st["onehots"][0]))
    return out


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    return max(1, int(cfg.capacity_factor * cfg.top_k * n_tokens
                      / cfg.n_experts))


def _route(xt, router, cfg: MoEConfig):
    """(probs, dispatch, combine, first-choice one-hot) of tokens xt (T, D)
    fp32."""
    probs = torch.softmax(xt @ router.float(), dim=-1)
    return (probs, *_topk_dispatch(probs, cfg.n_experts,
                                   _capacity(cfg, xt.shape[0]), cfg.top_k,
                                   cfg.rescue_ranks))


def _experts(expert_in, w_in, w_out):
    """The experts' GELU FFN over their queues (E, cap, D), fp32."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_in.float()),
               approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_out.float())


def _aux(onehot1, probs, e: int):
    """Switch load-balancing loss over first choices."""
    return e * torch.sum(onehot1.mean(dim=0) * probs.mean(dim=0))


def moe_ffn(x, params, cfg: MoEConfig):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, the aux loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d).float()
    probs, dispatch, combine, onehot1 = _route(xt, params["router"], cfg)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    expert_out = _experts(expert_in, params["w_in"], params["w_out"])
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.to(x.dtype).reshape(b, s, d), _aux(onehot1, probs,
                                                  cfg.n_experts)


def moe_ffn_experts(xs, routers, w_ins, w_outs, firsts, cfg: MoEConfig,
                    mesh=None, axis: str = "dp") -> list:
    """moe_ffn's output (fp32, (B, S, D)) through experts [first, first +
    E_local) only (w_in / w_out their slice), routing over all experts:
    the part each rank adds when the experts are split over tensor-parallel
    ranks and every rank holds all tokens (models/pipeline_lm.py).  The
    parts' sum over those ranks is moe_ffn's output.  Lists over ranks.

    With `mesh`, the ranks along `axis` hold one batch between them, in
    rank order: routing seats the tokens in that global order with the
    capacity of the whole batch (one all-gather of expert counts a choice
    rank), so the result is moe_ffn's over the batch."""
    xts = [x.reshape(-1, x.shape[-1]).float() for x in xs]
    n = mesh.size(axis) if mesh is not None else 1
    cap = _capacity(cfg, xts[0].shape[0] * n)
    probs = [torch.softmax(xt @ r.float(), dim=-1)
             for xt, r in zip(xts, routers)]
    prefix = None
    if n > 1:
        def prefix(counts):
            every = mesh.collective("gather", [c[None] for c in counts],
                                    axis, 0)
            return [(a[:mesh.index(r, axis)].sum(dim=0), a.sum(dim=0))
                    for r, a in zip(mesh.ranks, every)]
    routes = _dispatch_lists(probs, cfg.n_experts, cap, cfg.top_k,
                             cfg.rescue_ranks, prefix)
    out = []
    for x, xt, (dispatch, combine, _), w_in, w_out, first in zip(
            xs, xts, routes, w_ins, w_outs, firsts):
        sl = slice(first, first + w_in.shape[0])
        expert_in = torch.einsum("tec,td->ecd", dispatch[:, sl], xt)
        out.append(torch.einsum("tec,ecd->td", combine[:, sl],
                                _experts(expert_in, w_in, w_out))
                   .reshape(x.shape))
    return out


# -- expert parallelism: explicit all_to_all over an "ep" axis ----------------


def ep_specs(ep_axis: str = "ep") -> dict:
    """The expert-parallel layout: router replicated, experts split over
    the axis (the JAX make_moe_ffn_ep's in_specs)."""
    return {"router": P(), "w_in": P(ep_axis), "w_out": P(ep_axis)}


def shard_moe_params(params, mesh, ep_axis: str = "ep") -> ShardedParams:
    """What each held rank of the mesh holds of the MoE params."""
    return shard_tree(params, ep_specs(ep_axis), mesh)


def moe_ffn_ep_spmd(xs, params, cfg: MoEConfig, mesh, *, axis: str = "ep"):
    """The held ranks' (outs, auxes): xs their token shards (B_local, S,
    D), params their trees (router replicated, their E / n experts).

    Each rank routes its own tokens over all E experts into (E, cap, D)
    queues; the dispatch all_to_all splits E into the ranks' groups and
    concatenates the senders along the capacity dimension, (E_local,
    n * cap, D); the local experts run; the combine all_to_all returns
    each sender's slots, (E, cap, D).  The router goes through
    collectives.copy: its gradient, a sum over every rank's tokens, is then
    whole on every rank."""
    n = mesh.size(axis)
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{axis} = {n}")
    routers = cc.copy([p["router"] for p in params], mesh, axis)
    ins, routes = [], []
    for x, router in zip(xs, routers):
        b, s, d = x.shape
        xt = x.reshape(b * s, d).float()
        probs, dispatch, combine, onehot1 = _route(xt, router, cfg)
        ins.append(torch.einsum("tec,td->ecd", dispatch, xt))
        routes.append((probs, combine, onehot1))
    ins = cc.all_to_all(ins, mesh, axis, split_dim=0, concat_dim=1)
    outs = [_experts(e_in, p["w_in"], p["w_out"])
            for e_in, p in zip(ins, params)]
    outs = cc.all_to_all(outs, mesh, axis, split_dim=1, concat_dim=0)
    res, auxes = [], []
    for x, e_out, (probs, combine, onehot1) in zip(xs, outs, routes):
        out = torch.einsum("tec,ecd->td", combine, e_out)
        res.append(out.to(x.dtype).reshape(x.shape))
        auxes.append(_aux(onehot1, probs, cfg.n_experts))
    return res, auxes


def make_moe_ffn_ep(mesh, cfg: MoEConfig, *, ep_axis: str = "ep"):
    """fn(x, params) -> (the held ranks' outputs, their aux losses): x the
    global (B, S, D) tokens, split over the axis by batch under a
    LocalMesh, or the list of the held ranks' shards; params a
    ShardedParams of shard_moe_params (or the held ranks' trees)."""
    mesh = as_mesh(mesh)

    def fn(x, params):
        trees = params.local if isinstance(params, ShardedParams) else list(
            params)
        if isinstance(x, (list, tuple)):
            xs = [t.to(mesh.device) for t in x]
        else:
            n = mesh.size(ep_axis)
            if x.shape[0] % n:
                raise ValueError(f"batch {x.shape[0]} does not split over "
                                 f"{ep_axis} = {n}")
            parts = x.to(mesh.device).chunk(n)
            xs = [parts[mesh.index(r, ep_axis)] for r in mesh.ranks]
        return moe_ffn_ep_spmd(xs, trees, cfg, mesh, axis=ep_axis)

    return fn


# -- expert-choice routing: experts pick tokens -------------------------------


def expert_choice_ffn(x, params, cfg: MoEConfig):
    """Expert-choice MoE (Zhou et al. 2022): each expert takes its top
    `capacity` tokens by router affinity; a token may be taken by several
    experts (their outputs add, gate-weighted) or by none.  Returns (out,
    aux) with aux = 0 (moe_ffn's interface)."""
    b, s, d = x.shape
    n_tokens = b * s
    cap = min(_capacity(cfg, n_tokens), n_tokens)
    xt = x.reshape(n_tokens, d).float()
    probs = torch.softmax(xt @ params["router"].float(), dim=-1)
    gates, idx = torch.topk(probs.t(), cap, dim=-1)  # (E, cap)
    expert_out = _experts(xt[idx], params["w_in"], params["w_out"])
    weighted = expert_out * gates[:, :, None]
    out = torch.zeros((n_tokens, d), device=x.device).index_add(
        0, idx.reshape(-1), weighted.reshape(-1, d))
    return out.to(x.dtype).reshape(b, s, d), torch.zeros((), device=x.device)
