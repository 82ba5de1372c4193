"""Device meshes over named axes: the two forms, the spec tables, sharding.

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
- A `torch.distributed.device_mesh.DeviceMesh` with named axes
  (`init_device_mesh`) holds one rank a process: gloo on the CPU, NCCL one
  card a rank.  `as_mesh` wraps it in `GroupMesh`, whose collectives are
  torch.distributed calls over the axis's group.

The axes are ("dp", "tp") unless named otherwise: ("pp",) and ("ep",) for
the pipeline and expert-parallel paths, ("dp", "pp", "tp") for
models/pipeline_lm.py.  Ranks are numbered row-major over the axes, as
jax.sharding.Mesh(devices.reshape(sizes), names) numbers them, so rank r of
LocalMesh(dp, tp) sits at (dp index, tp index) = divmod(r, tp).  Every
per-rank argument of the port's sharded functions is a list over
`mesh.ranks`, the ranks held: all of them under a LocalMesh, one under a
GroupMesh.  The differentiable forms of the collectives (Megatron's f and g,
the fsdp all-gather / reduce-scatter pair, shift and all_to_all) are in
parallel/collectives.py.

Layouts.  `param_specs` gives the JAX package's global layout, spec for
spec (tuples of axis names); checkpoints and `gather_params` keep it.
`shard_params` gives what each rank holds, with one change of order: the
fused wqkv (and bqkv) is [q | k | v] along its columns, and a contiguous
split would not hand a rank whole heads, so a rank's shard is the
columns of its q heads, then of their kv heads, then of their v heads.
Where tp does not divide the kv heads, attention (wqkv, bqkv, wo; an MLA
block's w_q or w_uq, w_uk, w_uv and wo) is replicated over tp and only the
MLP and the vocabulary are split.  An MLA block's head-wise matrices split
by whole heads as they are (a head's columns lie together).  A leaf
whose spec is a `Halves` (its tp dimension two halves, as Mamba's in_proj
is [hidden | gate]) gives a rank its columns of each half.  Any other axis
(pp, ep) takes contiguous pieces.
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
        return f"{type(self).__name__}{tuple(self)!r}"


class Halves(P):
    """A spec whose tp dimension is two halves laid side by side, each split
    over tp: a rank holds its share of each half.  It compares equal to
    the P (and the JAX spec) of the same names, which is the global
    layout."""


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


class _Axes:
    """What both forms share: named axes with sizes, ranks numbered
    row-major over them (Mesh(devices.reshape(sizes), names)'s order)."""

    axis_names: tuple = AXES
    _sizes: tuple = (1, 1)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def dp(self) -> int:
        return self.size("dp")

    @property
    def tp(self) -> int:
        return self.size("tp")

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, rank: int, axis: str) -> int:
        """A held rank's coordinate along `axis` (0 where the mesh lacks
        it)."""
        if axis not in self.axis_names:
            return 0
        return self.coord(rank)[self.axis_names.index(axis)]


class LocalMesh(_Axes):
    """All ranks of a mesh, held by this process on one device.

    LocalMesh(dp, tp, device) is the (dp, tp) mesh; `axes` names any other
    ordered axes with their sizes in its place, e.g. axes={"pp": 4} or
    {"dp": 1, "pp": 2, "tp": 2}."""

    def __init__(self, dp: int = 1, tp: int = 1, device=None, *, axes=None):
        if axes is None:
            axes = {"dp": dp, "tp": tp}
        elif (dp, tp) != (1, 1):
            raise ValueError("give the mesh's sizes as dp, tp or as axes, "
                             "not both")
        if any(int(n) < 1 for n in axes.values()):
            raise ValueError(f"a mesh needs axes of size >= 1, got {axes}")
        self.axis_names = tuple(axes)
        self._sizes = tuple(int(n) for n in axes.values())
        self.device = resolve_device(device)
        self.ranks = tuple(range(math.prod(self._sizes)))

    def coord(self, rank: int) -> tuple:
        """The held rank's coordinates, one an axis ((dp, tp) index on the
        (dp, tp) mesh)."""
        out = []
        for n in reversed(self._sizes):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    def _groups(self, axis: str):
        """Positions in `ranks` of each group along `axis`, in axis order."""
        if axis not in self.axis_names:
            return [[r] for r in self.ranks]
        k = self.axis_names.index(axis)
        n, stride = self._sizes[k], math.prod(self._sizes[k + 1:])
        return [[r + j * stride for j in range(n)] for r in self.ranks
                if (r // stride) % n == 0]

    def sub_meshes(self, axis: str) -> list:
        """[(index along `axis`, positions in `ranks` of the held ranks at
        that index, the mesh of the other axes over them)]: how a stage of
        a pipeline reaches its own ranks' collectives."""
        others = {a: n for a, n in self.shape.items() if a != axis}
        sub = LocalMesh(axes=others, device=self.device)
        groups = self._groups(axis)
        return [(i, [g[i] for g in groups], sub)
                for i in range(self.size(axis))]

    def collective(self, kind: str, xs, axis: str, dim: int = 0, *,
                   split_dim: int = 0, offset: int = 1,
                   cyclic: bool = True) -> list:
        """`kind` over `axis` of the per-rank tensors xs (one a held rank):
        "sum" / "max" all-reduce, "gather" (concatenation along dim in axis
        order), "split" (each rank's chunk along dim), "reduce_scatter"
        (sum, then the chunk), "identity", "shift" (JAX's ppermute: rank
        i takes rank i - offset's tensor; without `cyclic` the ranks with
        no sender take zeros) and "all_to_all" (the tiled lax.all_to_all:
        each rank splits its tensor along split_dim into one chunk a rank
        and concatenates the chunks it receives along dim, in axis order).
        Every result is a tensor of its own."""
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
            elif kind == "shift":
                res = [items[(j - offset) % n].clone()
                       if cyclic or 0 <= j - offset < n
                       else torch.zeros_like(items[j]) for j in range(n)]
            elif kind == "all_to_all":
                chunks = [x.chunk(n, dim=split_dim) for x in items]
                res = [torch.cat([c[j] for c in chunks], dim=dim)
                       for j in range(n)]
            else:
                raise ValueError(f"unknown collective {kind!r}")
            if kind in ("split", "reduce_scatter"):
                res = [r.chunk(n, dim=dim)[j].clone()
                       for j, r in enumerate(res)]
            for i, r in zip(group, res):
                out[i] = r
        return out


class GroupMesh(_Axes):
    """One rank of a torch.distributed DeviceMesh with named axes (dp, tp
    or any others), this process's."""

    def __init__(self, device_mesh):
        names = tuple(device_mesh.mesh_dim_names or ())
        if not names:
            raise ValueError("expected a DeviceMesh with named axes "
                             "(mesh_dim_names)")
        self.device_mesh = device_mesh
        self.axis_names = names
        self._sizes = tuple(int(s) for s in device_mesh.mesh.shape)
        self._coord = tuple(int(c) for c in device_mesh.get_coordinate())
        self.ranks = (dist.get_rank(),)
        self._groups = {a: device_mesh.get_group(a) for a in names}
        if device_mesh.device_type == "cuda":
            self.device = resolve_device(
                torch.device("cuda", torch.cuda.current_device()))
        else:
            self.device = resolve_device(device_mesh.device_type)

    def coord(self, rank: int) -> tuple:
        return self._coord

    def sub_meshes(self, axis: str) -> list:
        """This process's index along `axis` and itself: its collectives
        over the other axes already stay within that index."""
        return [(self.index(self.ranks[0], axis), [0], self)]

    def _peer(self, axis: str, i: int) -> int:
        return dist.get_global_rank(self._groups[axis], i)

    def collective(self, kind: str, xs, axis: str, dim: int = 0, *,
                   split_dim: int = 0, offset: int = 1,
                   cyclic: bool = True) -> list:
        (x,) = xs
        n = self.size(axis)
        if kind == "identity" or n == 1:
            return [x.clone()]
        group = self._groups[axis]
        me = self.index(self.ranks[0], axis)
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
        if kind == "shift":
            # one batch of point-to-point calls, as ProcessGroupRing's
            send = me + offset if cyclic or 0 <= me + offset < n else None
            recv = me - offset if cyclic or 0 <= me - offset < n else None
            out = torch.zeros_like(x.detach()).contiguous()
            ops = []
            if send is not None:
                ops.append(dist.P2POp(dist.isend, x.detach().contiguous(),
                                      self._peer(axis, send % n), group))
            if recv is not None:
                ops.append(dist.P2POp(dist.irecv, out,
                                      self._peer(axis, recv % n), group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return [out]
        if kind == "all_to_all":
            ins = [c.contiguous() for c in x.detach().chunk(n, dim=split_dim)]
            outs = [torch.empty_like(c) for c in ins]
            dist.all_to_all(outs, ins, group=group)
            return [torch.cat(outs, dim=dim)]
        raise ValueError(f"unknown collective {kind!r}")


def as_mesh(mesh):
    """A LocalMesh or GroupMesh as it is; a DeviceMesh wrapped."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, (LocalMesh, GroupMesh)):
        return mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a LocalMesh or a DeviceMesh with named "
                        f"axes, got {type(mesh).__name__}")
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


_ATTN_KEYS = ("wqkv", "bqkv", "wo", "w_q", "w_uq", "w_uk", "w_uv")
_QKV_KEYS = ("wqkv", "bqkv")


@dataclass(frozen=True)
class Shard:
    """How one leaf of the global tree lies over the mesh: its global shape,
    the dimension split over dp (None: replicated over dp) and over tp, for
    the fused qkv width the head counts of its head-aligned split, `halves`
    where the tp dimension is two halves each split over tp, and `more`,
    the (axis, dimension) pairs of any other axis (pp, ep), each split in
    contiguous pieces."""

    shape: tuple
    dp_dim: int | None = None
    tp_dim: int | None = None
    qkv: tuple | None = None  # (n_heads, kv_heads, head_dim)
    halves: bool = False
    more: tuple = ()

    @property
    def axes(self) -> tuple:
        """The mesh axes over which ranks hold different pieces."""
        return tuple(a for a, d in (("dp", self.dp_dim), ("tp", self.tp_dim),
                                    *self.more) if d is not None)

    def _contiguous(self):
        """(axis, dimension) of every contiguous split (all but tp's)."""
        return ((("dp", self.dp_dim),) if self.dp_dim is not None else ()
                ) + tuple(self.more)

    def _tp_index(self, t: int, tp: int, device):
        """Global indices along tp_dim of tp rank t's piece, in local order:
        the rank's share of each block of the dimension ([q | k | v] by
        heads, the two halves, or the whole), block after block."""
        n = self.shape[self.tp_dim]
        if self.qkv is not None:
            h, hkv, _ = self.qkv
            blocks = (h, hkv, hkv)
        else:
            blocks = (1, 1) if self.halves else (1,)
        unit, base, idx = n // sum(blocks), 0, []
        for b in blocks:
            w = b * unit // tp
            idx.append(torch.arange(base + t * w, base + (t + 1) * w))
            base += b * unit
        return torch.cat(idx).to(device)

    def local(self, full, mesh, rank: int):
        """Held rank `rank`'s piece of the global tensor: a contiguous
        tensor of its own (never a view of `full`)."""
        x = full
        if self.tp_dim is not None:
            x = x.index_select(self.tp_dim, self._tp_index(
                mesh.index(rank, "tp"), mesh.size("tp"), full.device))
        for axis, dim in self._contiguous():
            x = x.chunk(mesh.size(axis), dim=dim)[mesh.index(rank, axis)]
        return x.clone(memory_format=torch.contiguous_format)

    def unpermute(self, x, tp: int):
        """The tp-gathered tensor (pieces in rank order) in global order."""
        if (self.qkv is None and not self.halves) or self.tp_dim is None:
            return x
        order = torch.cat([self._tp_index(t, tp, x.device)
                           for t in range(tp)])
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=x.device)
        return x.index_select(self.tp_dim, inv)

    def slices(self, mesh, rank: int) -> list:
        """[(global [start, stop) a dimension, local [start, stop) along
        tp_dim)] of held rank `rank`'s piece: one region, or one a block
        for a blocked tp split (qkv's q, k and v columns, the halves)."""
        box = [[0, n] for n in self.shape]
        for axis, dim in self._contiguous():
            w = self.shape[dim] // mesh.size(axis)
            i = mesh.index(rank, axis)
            box[dim] = [i * w, (i + 1) * w]
        if self.tp_dim is None:
            return [(box, None)]
        idx = self._tp_index(mesh.index(rank, "tp"), mesh.size("tp"),
                             "cpu").tolist()
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
    halves = isinstance(spec, Halves)
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    dims = {a: i for i, a in enumerate(spec) if a is not None}
    dp_dim, tp_dim = dims.pop("dp", None), dims.pop("tp", None)
    qkv = None
    if key in _ATTN_KEYS and tp_dim is not None:
        if not attention_split(cfg, mesh.tp):
            tp_dim = None
        elif key in _QKV_KEYS:
            qkv = (cfg.n_heads, cfg.kv_heads, cfg.head_dim)
    halves = halves and tp_dim is not None
    for axis, dim in (("dp", dp_dim), ("tp", tp_dim), *dims.items()):
        n = mesh.size(axis) * (2 if halves and axis == "tp" else 1)
        if dim is not None and shape[dim] % n:
            raise ValueError(f"{key}: dimension {dim} of {shape} does not "
                             f"split into {n} equal pieces")
    return Shard(shape, dp_dim, tp_dim, qkv, halves, tuple(dims.items()))


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
    local = [tree_map(lambda x, s, r=r: s.local(x.to(mesh.device), mesh, r),
                      params, shards) for r in mesh.ranks]
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
    for axis, dim in shard._contiguous():
        xs = mesh.collective("gather", xs, axis, dim)
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
