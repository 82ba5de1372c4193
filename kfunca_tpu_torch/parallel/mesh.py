"""Device meshes over (dp, tp): the two forms, the spec tables, sharding.

Counterpart of kfunca_tpu/parallel/mesh.py.  The JAX package names a
jax.sharding.Mesh, annotates params and batch with PartitionSpecs and lets
GSPMD insert the collectives.  The port computes each rank's part itself,
so a mesh here is an object that names the ranks this process holds and
carries out the collectives between them.  Two forms, one interface:

- `LocalMesh(dp, tp, device)` holds all dp x tp ranks in this process on
  one device and steps them in lockstep; its collectives are operations on
  lists of per-rank tensors.  It is how one card runs every sharded path
  (NCCL refuses two ranks on one card, and a thread a rank would deadlock
  on autograd's one device thread, as `ring_attention.LocalRing` says).
- A `torch.distributed.device_mesh.DeviceMesh` with axes ("dp", "tp")
  (`init_device_mesh`) holds one rank a process: gloo on the CPU, NCCL one
  card a rank.  `as_mesh` wraps it in `GroupMesh`, whose collectives are
  torch.distributed calls over the axis's group.

Rank r of a LocalMesh sits at (dp index, tp index) = divmod(r, tp).  Every
per-rank argument of the port's sharded functions is a list over
`mesh.ranks`, the ranks held: all of them under a LocalMesh, one under a
GroupMesh.  The differentiable forms of the collectives (Megatron's f and g,
the fsdp all-gather / reduce-scatter pair) are in parallel/collectives.py.

Layouts.  `param_specs` gives the JAX package's global layout, spec for
spec (tuples of axis names); checkpoints and `gather_params` keep it.
`shard_params` gives what each rank holds, with one change of order: the
fused wqkv (and bqkv) is [q | k | v] along its columns, and a contiguous
split would not hand a rank whole heads, so a rank's shard is the
columns of its q heads, then of their kv heads, then of their v heads.
Where tp does not divide the kv heads, attention (wqkv, bqkv, wo) is
replicated over tp and only the MLP and the vocabulary are split.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..runtime.backend import resolve_device
from ..utils.tree import tree_leaves, tree_map, tree_unflatten

AXES = ("dp", "tp")


class P(tuple):
    """A partition spec: one entry a dimension, an axis name or None (the
    JAX PartitionSpec's contents; it compares equal to the plain tuple)."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def factor_mesh(n: int) -> tuple[int, int]:
    """Split n devices into (dp, tp), preferring square-ish with tp a power
    of two (the JAX function, :26-39)."""
    best = (n, 1)
    tp = 1
    while tp * 2 <= n:
        tp *= 2
        if n % tp == 0:
            dp = n // tp
            if abs(math.log2(max(dp, 1)) - math.log2(tp)) <= abs(
                    math.log2(max(best[0], 1)) - math.log2(max(best[1], 1))):
                best = (dp, tp)
    return best


# -- the two forms -------------------------------------------------------------


class LocalMesh:
    """All dp x tp ranks of a mesh, held by this process on one device."""

    def __init__(self, dp: int, tp: int, device=None):
        if dp < 1 or tp < 1:
            raise ValueError(f"a mesh needs dp, tp >= 1, got ({dp}, {tp})")
        self.dp, self.tp = int(dp), int(tp)
        self.device = resolve_device(device)
        self.ranks = tuple(range(self.dp * self.tp))

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def coord(self, rank: int) -> tuple[int, int]:
        """(dp index, tp index) of a held rank."""
        return divmod(rank, self.tp)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def _groups(self, axis: str):
        """Positions in `ranks` of each group along `axis`, in axis order."""
        if axis == "tp":
            return [[d * self.tp + t for t in range(self.tp)]
                    for d in range(self.dp)]
        return [[d * self.tp + t for d in range(self.dp)]
                for t in range(self.tp)]

    def collective(self, kind: str, xs, axis: str, dim: int = 0) -> list:
        """`kind` over `axis` of the per-rank tensors xs (one a held rank):
        "sum" / "max" all-reduce, "gather" (concatenation along dim in axis
        order), "split" (each rank's chunk along dim), "reduce_scatter"
        (sum, then the chunk), "identity".  Every result is a tensor of its
        own."""
        n = self.size(axis)
        out = [None] * len(xs)
        for group in self._groups(axis):
            items = [xs[i] for i in group]
            if kind in ("sum", "reduce_scatter"):
                total = items[0].clone()
                for x in items[1:]:
                    total = total + x
                res = [total.clone() for _ in group]
            elif kind == "max":
                total = items[0]
                for x in items[1:]:
                    total = torch.maximum(total, x)
                res = [total.clone() for _ in group]
            elif kind == "gather":
                full = torch.cat(items, dim=dim)
                res = [full.clone() for _ in group]
            elif kind == "split":
                res = items
            elif kind == "identity":
                res = [x.clone() for x in items]
            else:
                raise ValueError(f"unknown collective {kind!r}")
            if kind in ("split", "reduce_scatter"):
                res = [r.chunk(n, dim=dim)[j].clone()
                       for j, r in enumerate(res)]
            for i, r in zip(group, res):
                out[i] = r
        return out


class GroupMesh:
    """One rank of a (dp, tp) torch.distributed DeviceMesh, this process's."""

    def __init__(self, device_mesh):
        names = tuple(device_mesh.mesh_dim_names or ())
        if names != AXES:
            raise ValueError(f"expected a DeviceMesh with axes {AXES}, got "
                             f"{names}")
        self.device_mesh = device_mesh
        self.dp, self.tp = (int(s) for s in device_mesh.mesh.shape)
        self._coord = tuple(int(c) for c in device_mesh.get_coordinate())
        self.ranks = (dist.get_rank(),)
        self._groups = {a: device_mesh.get_group(a) for a in AXES}
        if device_mesh.device_type == "cuda":
            self.device = resolve_device(
                torch.device("cuda", torch.cuda.current_device()))
        else:
            self.device = resolve_device(device_mesh.device_type)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def coord(self, rank: int) -> tuple[int, int]:
        return self._coord

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def collective(self, kind: str, xs, axis: str, dim: int = 0) -> list:
        (x,) = xs
        n, group = self.size(axis), self._groups[axis]
        me = self._coord[AXES.index(axis)]
        if kind == "identity" or n == 1:
            return [x.clone()]
        if kind in ("sum", "max", "reduce_scatter"):
            t = x.detach().clone().contiguous()
            op = dist.ReduceOp.MAX if kind == "max" else dist.ReduceOp.SUM
            dist.all_reduce(t, op=op, group=group)
            if kind == "reduce_scatter":
                t = t.chunk(n, dim=dim)[me].clone()
            return [t]
        if kind == "gather":
            parts = [torch.empty_like(x.contiguous()) for _ in range(n)]
            dist.all_gather(parts, x.detach().contiguous(), group=group)
            return [torch.cat(parts, dim=dim)]
        if kind == "split":
            return [x.chunk(n, dim=dim)[me].clone()]
        raise ValueError(f"unknown collective {kind!r}")


def as_mesh(mesh):
    """A LocalMesh or GroupMesh as it is; a DeviceMesh wrapped."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, (LocalMesh, GroupMesh)):
        return mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a LocalMesh or a DeviceMesh with axes "
                        f"{AXES}, got {type(mesh).__name__}")
    return GroupMesh(mesh)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, *, device=None):
    """A (dp, tp) mesh: a DeviceMesh over the process group when one is up
    (one rank a process, n_devices its world size), else a LocalMesh of
    n_devices ranks (default 1) on `device` (default: the CUDA device)."""
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        n = n_devices or dist.get_world_size()
        if dp is None or tp is None:
            dp, tp = factor_mesh(n)
        if dp * tp != n or n != dist.get_world_size():
            raise ValueError(f"mesh ({dp}, {tp}) over {n} devices in a group "
                             f"of {dist.get_world_size()}")
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(kind, (dp, tp), mesh_dim_names=AXES)
    n = n_devices or ((dp or 1) * (tp or 1))
    if dp is None or tp is None:
        dp, tp = factor_mesh(n)
    if dp * tp != n:
        raise ValueError(f"mesh ({dp}, {tp}) does not hold {n} devices")
    return LocalMesh(dp, tp, device)


# -- sharding rules for the transformer param tree -----------------------------


def param_specs(params, fsdp: bool = False) -> dict:
    """Megatron-style TP specs (the JAX function, :53-146): qkv/gate/up
    column-parallel, wo/down row-parallel, embeddings over d_model, norms
    replicated; fsdp=True also shards every matrix's tp-free axis over dp
    (ZeRO-3)."""

    def _with_dp(spec: P) -> P:
        s = list(spec)
        for i, ax in enumerate(s):
            if ax is None:
                s[i] = "dp"
                return P(*s)
        return spec

    maybe_dp = _with_dp if fsdp else (lambda s: s)

    def block_spec(blk):
        s = {"attn_norm": P(), "wo": maybe_dp(P("tp", None)),
             "mlp_norm": P()}
        if "w_dkv" in blk:  # MLA
            s["w_dkv"] = maybe_dp(P(None, None))
            s["kv_norm"] = P()
            s["w_uk"] = maybe_dp(P(None, "tp"))
            s["w_uv"] = maybe_dp(P(None, "tp"))
            if "w_q" in blk:
                s["w_q"] = maybe_dp(P(None, "tp"))
            else:
                s["w_dq"] = maybe_dp(P(None, None))
                s["q_norm"] = P()
                s["w_uq"] = maybe_dp(P(None, "tp"))
        else:
            s["wqkv"] = maybe_dp(P(None, "tp"))
            if "q_norm" in blk:  # Qwen3 per-head q/k norms, shared by heads
                s["q_norm"] = P()
                s["k_norm"] = P()
        if "experts" in blk:  # MoE: each expert shards like a dense MLP
            s["router"] = P()
            if "router_bias" in blk:
                s["router_bias"] = P()
            s["experts"] = [
                {"w_gate": maybe_dp(P(None, "tp")),
                 "w_up": maybe_dp(P(None, "tp")),
                 "w_down": maybe_dp(P("tp", None))}
                for _ in blk["experts"]]
            if "shared" in blk:
                s["shared"] = {"w_gate": maybe_dp(P(None, "tp")),
                               "w_up": maybe_dp(P(None, "tp")),
                               "w_down": maybe_dp(P("tp", None))}
        elif "w_fc" in blk:  # GPT-2-family GELU MLP
            s["w_fc"] = maybe_dp(P(None, "tp"))
            s["w_proj"] = maybe_dp(P("tp", None))
        else:
            s["w_gate"] = maybe_dp(P(None, "tp"))
            s["w_up"] = maybe_dp(P(None, "tp"))
            s["w_down"] = maybe_dp(P("tp", None))
        if "bqkv" in blk:
            s["bqkv"] = P("tp")
        if "b_fc" in blk:
            s["b_fc"] = P("tp")  # column-parallel bias
        for name in ("bo", "b_proj", "attn_norm_b", "mlp_norm_b"):
            if name in blk:  # row-parallel biases / norm biases
                s[name] = P()
        return s

    out = {"embed": maybe_dp(P(None, "tp")), "final_norm": P(),
           "blocks": [block_spec(b) for b in params["blocks"]]}
    if "lm_head" in params:
        out["lm_head"] = maybe_dp(P(None, "tp"))
    if "pos_embed" in params:
        out["pos_embed"] = P()
    if "final_norm_b" in params:
        out["final_norm_b"] = P()
    return out


def batch_spec() -> P:
    return P("dp", None)


def activation_spec() -> P:
    """(B, S, D) activations between blocks: batch over dp, sequence over tp
    (sequence parallelism)."""
    return P("dp", "tp", None)


_ATTN_KEYS = ("wqkv", "bqkv", "wo")
_QKV_KEYS = ("wqkv", "bqkv")


@dataclass(frozen=True)
class Shard:
    """How one leaf of the global tree lies over the mesh: its global shape,
    the dimension split over dp (None: replicated over dp) and over tp, and
    for the fused qkv width the head counts of its head-aligned split."""

    shape: tuple
    dp_dim: int | None = None
    tp_dim: int | None = None
    qkv: tuple | None = None  # (n_heads, kv_heads, head_dim)

    @property
    def axes(self) -> tuple:
        """The mesh axes over which ranks hold different pieces."""
        return tuple(a for a, d in (("dp", self.dp_dim), ("tp", self.tp_dim))
                     if d is not None)

    def _tp_index(self, t: int, tp: int, device):
        """Global indices along tp_dim of tp rank t's piece, in local order."""
        n = self.shape[self.tp_dim]
        if self.qkv is None:
            w = n // tp
            return torch.arange(t * w, (t + 1) * w, device=device)
        h, hkv, hd = self.qkv
        per = n // (h + 2 * hkv)  # columns a head (hd, or a scale's 1 ...)
        q, kv = h // tp * per, hkv // tp * per
        base_k, base_v = h * per, (h + hkv) * per
        return torch.cat([torch.arange(t * q, (t + 1) * q),
                          torch.arange(base_k + t * kv, base_k + (t + 1) * kv),
                          torch.arange(base_v + t * kv, base_v + (t + 1) * kv)]
                         ).to(device)

    def local(self, full, d: int, t: int, dp: int, tp: int):
        """Rank (d, t)'s piece of the global tensor: a contiguous tensor of
        its own (never a view of `full`)."""
        x = full
        if self.tp_dim is not None:
            x = x.index_select(self.tp_dim,
                               self._tp_index(t, tp, full.device))
        if self.dp_dim is not None:
            x = x.chunk(dp, dim=self.dp_dim)[d]
        return x.clone(memory_format=torch.contiguous_format)

    def unpermute(self, x, tp: int):
        """The tp-gathered tensor (pieces in rank order) in global order."""
        if self.qkv is None or self.tp_dim is None:
            return x
        order = torch.cat([self._tp_index(t, tp, x.device)
                           for t in range(tp)])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=x.device)
        return x.index_select(self.tp_dim, inv)

    def slices(self, d: int, t: int, dp: int, tp: int) -> list:
        """[(global [start, stop) a dimension, local [start, stop) along
        tp_dim)] of rank (d, t)'s piece: one region, or three for a
        head-aligned qkv split (its q, k and v columns)."""
        box = [[0, n] for n in self.shape]
        if self.dp_dim is not None:
            w = self.shape[self.dp_dim] // dp
            box[self.dp_dim] = [d * w, (d + 1) * w]
        if self.tp_dim is None:
            return [(box, None)]
        idx = self._tp_index(t, tp, "cpu").tolist()
        runs, start = [], 0
        for i in range(1, len(idx) + 1):
            if i == len(idx) or idx[i] != idx[i - 1] + 1:
                runs.append((idx[start], idx[i - 1] + 1, start, i))
                start = i
        out = []
        for g0, g1, l0, l1 in runs:
            b = [list(r) for r in box]
            b[self.tp_dim] = [g0, g1]
            out.append((b, (l0, l1)))
        return out


def _leaf_shard(x, spec, key, cfg, mesh) -> Shard:
    shape = tuple(x.shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    dp_dim = spec.index("dp") if "dp" in spec else None
    tp_dim = spec.index("tp") if "tp" in spec else None
    qkv = None
    if key in _ATTN_KEYS and tp_dim is not None:
        if not attention_split(cfg, mesh.tp):
            tp_dim = None
        elif key in _QKV_KEYS:
            qkv = (cfg.n_heads, cfg.kv_heads, cfg.head_dim)
    for dim, n in ((dp_dim, mesh.dp), (tp_dim, mesh.tp)):
        if dim is not None and shape[dim] % n:
            raise ValueError(f"{key}: dimension {dim} of {shape} does not "
                             f"split into {n} equal pieces")
    return Shard(shape, dp_dim, tp_dim, qkv)


def attention_split(cfg, tp: int) -> bool:
    """Whether attention splits by heads over tp: a config whose kv heads
    tp divides.  Otherwise it is replicated (no config: replicated)."""
    return cfg is not None and cfg.kv_heads % tp == 0


def _shards(params, specs, cfg, mesh):
    """The tree of Shard records for params under specs."""

    def walk(x, s, key):
        if isinstance(x, dict):
            return {k: walk(x[k], s[k], k) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, ss, key) for v, ss in zip(x, s))
        return _leaf_shard(x, s, key, cfg, mesh)

    return walk(params, specs, None)


class ShardedParams:
    """What each held rank of a mesh holds of a param tree.

    `local` is a list over `mesh.ranks` of trees shaped like the global
    tree; `shards` is the tree of Shard records (how each leaf lies);
    `specs` the global spec tree it was made from; `cfg` the config whose
    heads split attention (None: attention replicated)."""

    def __init__(self, mesh, local, shards, specs, cfg=None, fsdp=False):
        self.mesh, self.local, self.shards = mesh, local, shards
        self.specs, self.cfg, self.fsdp = specs, cfg, fsdp

    @property
    def attn_split(self) -> bool:
        return attention_split(self.cfg, self.mesh.tp)

    def leaves(self):
        """(Shard, [per-rank leaf]) in flatten order."""
        per_rank = [tree_leaves(t) for t in self.local]
        return list(zip(tree_leaves(self.shards), zip(*per_rank)))


def shard_tree(params, specs, mesh, cfg=None, fsdp=False) -> ShardedParams:
    """ShardedParams of a global tree under `specs` (any spec tree, e.g.
    param_specs or serve.decode_param_specs)."""
    mesh = as_mesh(mesh)
    shards = _shards(params, specs, cfg, mesh)
    local = []
    for r in mesh.ranks:
        d, t = mesh.coord(r)
        local.append(tree_map(
            lambda x, s: s.local(x.to(mesh.device), d, t, mesh.dp, mesh.tp),
            params, shards))
    return ShardedParams(mesh, local, shards, specs, cfg, fsdp)


def shard_params(params, mesh, fsdp: bool = False, *, cfg=None):
    """What each rank of `mesh` holds of the global params under
    param_specs(params, fsdp).  `cfg` gives the heads that split attention
    by whole heads; without it attention is replicated over tp."""
    return shard_tree(params, param_specs(params, fsdp=fsdp), mesh, cfg,
                      fsdp)


def gather_leaf(mesh, shard: Shard, xs) -> list:
    """The global tensor, one a held rank, from the held ranks' pieces (not
    differentiable; the pieces of other processes come by all-gather).
    Each is a tensor of its own, never one of the pieces."""
    if not shard.axes:
        return [x.detach().clone() for x in xs]
    if shard.dp_dim is not None:
        xs = mesh.collective("gather", xs, "dp", shard.dp_dim)
    if shard.tp_dim is not None:
        xs = mesh.collective("gather", xs, "tp", shard.tp_dim)
        xs = [shard.unpermute(x, mesh.tp) for x in xs]
    return list(xs)


def gather_params(sharded: ShardedParams, mesh=None):
    """The global tree, bit for bit what went into shard_params (the first
    held rank's copy)."""
    mesh = as_mesh(mesh) if mesh is not None else sharded.mesh
    full = [gather_leaf(mesh, s, list(xs))[0] for s, xs in sharded.leaves()]
    return tree_unflatten(sharded.shards, full)


def constrain_seq_parallel(xs, mesh, partial: bool = False):
    """(B, S, D) activations to the activation_spec layout: each tp rank's
    chunk of the sequence.  Replicated inputs are split; `partial` inputs
    (row-parallel outputs before their sum) are reduce-scattered along S.
    Differentiable (the backward all-gathers along S)."""
    from .collectives import reduce_scatter, scatter

    mesh = as_mesh(mesh)
    return (reduce_scatter if partial else scatter)(xs, mesh, "tp", 1)


def gather_seq_parallel(xs, mesh):
    """The inverse of constrain_seq_parallel: the whole sequence on every tp
    rank (all-gather along S; the backward takes each rank's chunk)."""
    from .collectives import gather

    return gather(xs, as_mesh(mesh), "tp", 1)
