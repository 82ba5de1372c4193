"""Pipelined Mixture-of-Experts transformer LM over a (dp, pp, tp) mesh.

Counterpart of kfunca_tpu/models/pipeline_lm.py, name for name.  One
training step composes every axis:

  dp  the batch split over dp, gradients summed over it;
  pp  GPipe microbatch pipelining of the stage-stacked blocks
      (parallel/pipeline.py);
  tp  Megatron tensor parallelism inside a stage: whole heads of the fused
      [q | k | v] projection a rank, wo row-parallel (one sum over tp);
  ep  the experts split over tp: every tp rank routes all of the stage's
      tokens and runs its own experts, and the ranks' parts are summed over
      tp (models/moe.moe_ffn_experts).

The JAX package leaves dp and tp to GSPMD inside a shard_map over pp; the
port writes each rank's part over a LocalMesh(axes={"dp": .., "pp": ..,
"tp": ..}) or a DeviceMesh with those axes (parallel/mesh.py), with the
collectives Megatron pairs (parallel/collectives.py), so both compute the
same function.  Blocks are attention + MoE FFN; the embedding and the tied
head live outside the pipeline on every rank.  The attention runs through
ops.attention.causal_attention_fn, so bf16 stages launch the flash kernels
K1 and K2 (once a layer, a microbatch and a tp rank each).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.attention import causal_attention_fn
from ..parallel import collectives as cc
from ..parallel.mesh import LocalMesh, P, ShardedParams, as_mesh, shard_tree
from ..parallel.pipeline import pipeline_spmd, stack_stages
from ..runtime.backend import resolve_device
from ..utils.tree import tree_leaves, tree_map
from .moe import MoEConfig, init_moe_params, moe_ffn_experts
from .transformer import _DTYPES, _plain_mm, _rope, embed_tokens, rms_norm


@dataclass(frozen=True)
class PipelineMoEConfig:
    """The JAX package's PipelineMoEConfig, field for field."""

    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 2
    n_layers: int = 4
    n_experts: int = 4
    d_ff: int = 256
    n_stages: int = 2
    n_microbatches: int = 2
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        """Full multi-head attention (mesh.attention_split reads it)."""
        return self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, d_model=self.d_model,
                         d_ff=self.d_ff)


def init_params(seed: int, cfg: PipelineMoEConfig, device=None):
    """Random params with the JAX init_params laws, from a torch.Generator
    seeded with `seed` on `device` (default: the CUDA device); the blocks
    stage-stacked, leaves (n_stages, layers a stage, ...)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def linear(fan_in, fan_out):
        s = 1.0 / math.sqrt(fan_in)
        u = torch.rand((fan_in, fan_out), generator=gen, device=dev)
        return u * (2 * s) - s

    blocks = []
    for i in range(cfg.n_layers):
        blocks.append({
            "attn_norm": torch.ones((d,), device=dev),
            "wqkv": linear(d, 3 * d),
            "wo": linear(d, d),
            "mlp_norm": torch.ones((d,), device=dev),
            "moe": init_moe_params(seed * 1000 + i + 1, cfg.moe, dev),
        })
    return {"embed": torch.randn((cfg.vocab_size, d), generator=gen,
                                 device=dev) * 0.02,
            "final_norm": torch.ones((d,), device=dev),
            "stages": stack_stages(blocks, cfg.n_stages)}


def _attention(cfg: PipelineMoEConfig, y, p, heads: int):
    """Causal self-attention of `heads` heads up to wo: fused projection,
    RoPE, flash attention (K1 / K2 on the card)."""
    b, s, _ = y.shape
    hd = cfg.head_dim
    qkv = _plain_mm(y, p["wqkv"]).to(y.dtype).reshape(b, s, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    q, k = _rope(q, 10000.0), _rope(k, 10000.0)
    return causal_attention_fn(q, k, v).transpose(1, 2).reshape(b, s, -1)


def block_fn(cfg: PipelineMoEConfig, layer_params, x):
    """One attention + MoE-FFN layer on one device; x (mb, S, D): the
    layer of tp_block_fn over a mesh of one rank."""
    one = LocalMesh(axes={}, device=x.device)
    return tp_block_fn(cfg, True, one, [layer_params], [x])[0]


def tp_block_fn(cfg: PipelineMoEConfig, split: bool, sub, ps, xs):
    """block_fn over one stage's ranks (lists over them) and their mesh
    `sub` of the other axes: heads and experts split over tp (attention
    replicated where `split` is False)."""
    tp = sub.size("tp")
    heads = cfg.n_heads // tp if split else cfg.n_heads
    ys = [rms_norm(x, p["attn_norm"]) for x, p in zip(xs, ps)]
    if split:
        ys = cc.copy(ys, sub, "tp")
    os = [_plain_mm(_attention(cfg, y, p, heads), p["wo"])
          for y, p in zip(ys, ps)]
    if split:
        os = cc.reduce(os, sub, "tp")
    xs = [x + o.to(x.dtype) for x, o in zip(xs, os)]
    ys = cc.copy([rms_norm(x, p["mlp_norm"]) for x, p in zip(xs, ps)], sub,
                 "tp")
    # the router is replicated over tp and each rank's gradient of it
    # covers its own experts only: copy sums them
    routers = cc.copy([p["moe"]["router"] for p in ps], sub, "tp")
    el = ps[0]["moe"]["w_in"].shape[0]
    parts = moe_ffn_experts(ys, routers, [p["moe"]["w_in"] for p in ps],
                            [p["moe"]["w_out"] for p in ps],
                            [sub.index(r, "tp") * el for r in sub.ranks],
                            cfg.moe, sub, "dp")
    return [x + f.to(x.dtype) for x, f in zip(xs, cc.reduce(parts, sub, "tp"))]


def param_specs(cfg: PipelineMoEConfig) -> dict:
    """pp on the stage axis; tp on head / ffn dims; experts over tp (=ep):
    the JAX function's specs."""
    return {
        "embed": P(None, "tp"),
        "final_norm": P(),
        "stages": {
            "attn_norm": P("pp"),
            "wqkv": P("pp", None, None, "tp"),
            "wo": P("pp", None, "tp", None),
            "mlp_norm": P("pp"),
            "moe": {
                "router": P("pp", None, None, None),
                "w_in": P("pp", None, "tp", None, None),
                "w_out": P("pp", None, "tp", None, None),
            },
        },
    }


def shard_params(params, mesh, cfg: PipelineMoEConfig) -> ShardedParams:
    """What each held rank of a (dp, pp, tp) mesh holds under param_specs:
    its stage, whole heads of wqkv (q, k and v columns of its heads, as
    mesh.shard_params orders them), its rows of wo, its experts."""
    return shard_tree(params, param_specs(cfg), mesh, cfg)


def dp_rows(mesh, batch, n_micro: int) -> list:
    """Each held rank's rows of the batch: its dp share of every
    microbatch, microbatch after microbatch.  The JAX step splits the
    global batch (B, S) into M microbatches of B / M rows and GSPMD keeps
    each one whole in the arithmetic (the MoE queues of a microbatch fill
    over all its tokens), so a dp rank takes rows [d B / (M dp), (d + 1)
    B / (M dp)) of each.  Under a LocalMesh `batch` is the global batch;
    under a DeviceMesh it is the process's rows in that layout."""
    batch = torch.as_tensor(batch)
    if not isinstance(mesh, LocalMesh):
        return [batch.to(mesh.device)]
    b = batch.shape[0]
    if b % (n_micro * mesh.dp):
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches over dp = {mesh.dp}")
    parts = batch.reshape(n_micro, mesh.dp, b // (n_micro * mesh.dp),
                          *batch.shape[1:])
    return [parts[:, mesh.index(r, "dp")].reshape(-1, *batch.shape[1:])
            .to(mesh.device) for r in mesh.ranks]


def _nll(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def make_loss_fn(cfg: PipelineMoEConfig, mesh):
    """loss_fn(sharded_params, tokens, targets) -> each held rank's share of
    the global mean NLL (the mean over its rows (dp_rows) / dp; their sum
    over dp is the JAX loss_fn's value)."""
    mesh = as_mesh(mesh)

    def stage_fn(split):
        return lambda sub, ps, xs: tp_block_fn(cfg, split, sub, ps, xs)

    def loss_fn(sp: ShardedParams, tokens, targets):
        m = cfg.n_microbatches
        toks = dp_rows(mesh, tokens, m)
        tgts = dp_rows(mesh, targets, m)
        b, s = toks[0].shape
        xs = [embed_tokens(p, t, cfg) for p, t in zip(sp.local, toks)]
        if sp.shards["embed"].tp_dim is not None:
            xs = cc.gather(xs, mesh, "tp", -1)
        x_mb = [x.reshape(m, b // m, s, cfg.d_model) for x in xs]
        ys = pipeline_spmd(stage_fn(sp.attn_split),
                           [t["stages"] for t in sp.local], x_mb, mesh,
                           axis="pp", over_group=True)
        ys = [rms_norm(y.reshape(b, s, cfg.d_model), p["final_norm"])
              for y, p in zip(ys, sp.local)]
        heads = [p["embed"].t() for p in sp.local]
        if sp.shards["embed"].tp_dim is None:
            logits = [_plain_mm(y, h) for y, h in zip(ys, heads)]
        else:  # a d_model-split tied head is row-parallel
            logits = cc.reduce([_plain_mm(y, h) for y, h in zip(
                cc.scatter(ys, mesh, "tp", -1), heads)], mesh, "tp")
        return [_nll(lg, t) / mesh.dp for lg, t in zip(logits, tgts)]

    return loss_fn


def sequential_loss_fn(params, tokens, targets, cfg: PipelineMoEConfig):
    """The same model unpipelined on one device: the global params' layers
    applied in order to each microbatch in turn (a microbatch is the MoE
    routing's batch, as in the pipeline).  The yardstick of the pipelined
    step."""
    dev = params["embed"].device
    x = embed_tokens(params, torch.as_tensor(tokens).to(dev), cfg)
    stages = params["stages"]
    n_stages, per = tree_leaves(stages)[0].shape[:2]
    outs = []
    for h in x.chunk(cfg.n_microbatches):
        for st in range(n_stages):
            for j in range(per):
                h = block_fn(cfg, tree_map(lambda a: a[st, j], stages), h)
        outs.append(h)
    y = rms_norm(torch.cat(outs), params["final_norm"])
    return _nll(_plain_mm(y, params["embed"].t()),
                torch.as_tensor(targets).to(dev))


def make_train_step(cfg: PipelineMoEConfig, mesh, lr: float = 1e-3,
                    device=None):
    """SGD step over a (dp, pp, tp) mesh: step(params, tokens, targets) ->
    (params, loss), params a ShardedParams of shard_params (updated in
    place and returned), the batch as make_loss_fn takes it, the loss the
    global mean NLL before the update (the JAX step's)."""
    mesh = as_mesh(mesh)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"the mesh is on {mesh.device}, not {device}")
    loss_fn = make_loss_fn(cfg, mesh)

    def step(params: ShardedParams, tokens, targets):
        views = [tree_map(lambda p: p.detach().requires_grad_(True), t)
                 for t in params.local]
        vp = ShardedParams(mesh, views, params.shards, params.specs,
                           params.cfg)
        flat = [v for t in views for v in tree_leaves(t)]
        with torch.enable_grad():
            shares = loss_fn(vp, tokens, targets)
        grads = torch.autograd.grad(sum(shares), flat)
        n = len(flat) // len(views)
        with torch.no_grad():
            loss = cc.all_reduce([s.detach() for s in shares], mesh,
                                 "dp")[0]
            for leaf in range(n):
                gs = cc.all_reduce([grads[j * n + leaf]
                                    for j in range(len(views))], mesh, "dp")
                for t, g in zip(params.local, gs):
                    p = tree_leaves(t)[leaf]
                    p.copy_((p.float() - lr * g.float()).to(p.dtype))
        return params, loss

    return step

