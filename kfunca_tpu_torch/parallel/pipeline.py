"""Pipeline parallelism: GPipe microbatch pipelining over a mesh's pp axis.

Counterpart of kfunca_tpu/parallel/pipeline.py.  The JAX package writes the
pipeline as one SPMD program under shard_map over "pp": a lax.scan over
M + S - 1 ticks whose body ppermutes the activations one stage on, stage 0
feeding microbatch t, and the backward is the AD transpose of that scan.
The port runs the same ticks as a Python loop over the mesh's per-rank
lists (parallel/mesh.py): each tick shifts the activations one stage on
(collectives.shift) and applies each stage to what it received, and the
backward is autograd through the ticks.

The port skips the stage applications whose outputs the schedule throws
away: stage d at ticks t < d (they work on the zero initial state) and at
ticks t >= M + d (they work on what stage 0 took in past the last
microbatch, or on the cyclic edge from stage S - 1).  Neither reaches a
kept output before the last tick, so the kept outputs and every gradient
are the JAX program's, and a stage runs exactly once a microbatch, which
makes kernel launch counts exact.  With the skips the GPipe shift need not
be cyclic (stage 0 never takes what the last stage sends), so it is not;
the interleaved pipeline's ring edge S - 1 -> 0 carries stream c into
chunk c + 1 and stays.

A stage's function is one rank's: block_fn(layer_params, x), applied over
the rank's layers in order (the JAX scan).  A stage whose ranks work
together over the mesh's other axes (tensor parallelism inside a stage,
models/pipeline_lm.py) passes over_group=True and a block_fn(sub_mesh,
layer_params_list, xs) over the lists of one stage's ranks, sub_mesh the
mesh of those axes (mesh.sub_meshes).

The outputs of the last stage go to every pp rank through a sum whose
backward is the identity (collectives.reduce): as everywhere in the port,
every held rank back-propagates its own copy of a replicated loss (on a
LocalMesh, the sum of the ranks' losses).  A list of the ranks' own copies
of the input goes in through collectives.copy, so that each copy's
gradient is the same on every rank; one tensor given to a LocalMesh is
the ranks' one shared input and gets its gradient once.
"""

from __future__ import annotations

import torch

from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import collectives as cc
from .mesh import LocalMesh, P, ShardedParams, as_mesh, shard_tree


def _stack(block_params: list):
    return tree_map(lambda *xs: torch.stack(xs), block_params[0],
                    *block_params[1:])


def stack_stages(block_params: list, n_stages: int):
    """A list of L per-layer trees -> one tree whose leaves carry a leading
    (n_stages, layers_per_stage) axis; axis 0 is split over pp."""
    n_layers = len(block_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         f"stages")
    per = n_layers // n_stages
    return tree_map(lambda x: x.reshape((n_stages, per) + x.shape[1:]),
                    _stack(block_params))


def stack_stages_interleaved(block_params: list, n_stages: int, v: int):
    """Layers stacked for the interleaved schedule: virtual stage j (of
    V = v * n_stages) holds layers [j * per, (j + 1) * per) and lives on
    device j % n_stages as its chunk j // n_stages.  Leaves get a leading
    (n_stages, v, per) axis; axis 0 is split over pp."""
    n_layers, V = len(block_params), v * n_stages
    if n_layers % V:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         f"stages of {v} chunks")
    per = n_layers // V
    return tree_map(
        lambda x: x.reshape((v, n_stages, per) + x.shape[1:]).transpose(0, 1)
        .contiguous(), _stack(block_params))


def stage_shards(stacked, mesh, pp_axis: str = "pp") -> ShardedParams:
    """What each held rank holds of a stage-stacked tree: its stage's slice
    of axis 0 (a leading axis of 1, as the JAX local shard)."""
    specs = tree_map(lambda _: P(pp_axis), stacked)
    return shard_tree(stacked, specs, mesh)


def rank_trees(stacked) -> list:
    """The per-rank trees of a ShardedParams, or the list as it is."""
    return stacked.local if isinstance(stacked, ShardedParams) else list(
        stacked)


def rank_inputs(mesh, x) -> list:
    """Each held rank's copy of a replicated input: a tensor (every held
    rank's) or the list over the held ranks."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh.ranks):
            raise ValueError(f"{len(x)} inputs for {len(mesh.ranks)} held "
                             f"ranks")
        return [t.to(mesh.device) for t in x]
    return [x.to(mesh.device) for _ in mesh.ranks]


def _index(tree, *idx):
    return tree_map(lambda x: x[idx], tree)


def _group_fn(block_fn, over_group: bool):
    if over_group:
        return block_fn
    return lambda sub, ps, xs: [block_fn(p, x) for p, x in zip(ps, xs)]


def _shared(mesh, x_mb) -> bool:
    return isinstance(mesh, LocalMesh) and not isinstance(x_mb, (list, tuple))


def _or_zero(x, like):
    return x if x is not None else torch.zeros_like(like)


class _Plan:
    """A pipeline's static part: the mesh and axis, the chunks a device,
    the stage function, the held ranks' param structures."""

    def __init__(self, mesh, axis, v, interleaved, fn, trees, remat):
        self.mesh, self.axis, self.v = mesh, axis, v
        self.interleaved, self.fn, self.remat = interleaved, fn, remat
        self.trees = trees
        self.k = len(tree_leaves(trees[0]))
        self.n = mesh.size(axis)
        self.stages = mesh.sub_meshes(axis)
        self.pp = [mesh.index(r, axis) for r in mesh.ranks]

    def chunk(self, c):
        """The index of chunk c in a held rank's leaves."""
        return (0, c) if self.interleaved else (0,)

    def active(self, t, m):
        """[(d, c, positions, sub)] of the stage chunks that run at tick t:
        virtual stage j = c n + d runs microbatch t - j (module docstring:
        the others are skipped)."""
        return [(d, c, pos, sub) for d, pos, sub in self.stages
                for c in range(self.v) if 0 <= t - (c * self.n + d) < m]

    def run(self, sub, pos, views, ins):
        """One stage chunk over its ranks: views their param leaves."""
        params = [tree_unflatten(self.trees[i], vs)
                  for i, vs in zip(pos, views)]
        xs = list(ins)
        for j in range(tree_leaves(params[0])[0].shape[0]):
            xs = self.fn(sub, [_index(p, j) for p in params], xs)
        return xs


class _Pipeline(torch.autograd.Function):
    """The ticks as one autograd node a held rank, so that every rank of a
    process group runs the same collectives in the backward.  The forward
    runs the stage chunks tick by tick, keeping each one's graph (or with
    remat its input only); the backward walks the ticks in reverse, gives
    each chunk the gradient its consumer sent one stage back (an explicit
    shift) and back-propagates the chunk into its input and into one set
    of param views a (rank, chunk), whose .grad sums the microbatches leaf
    by leaf (no chunk's gradients are held all at once)."""

    @staticmethod
    def forward(ctx, plan, *flat):
        mesh, n, v = plan.mesh, plan.n, plan.v
        R, V = len(mesh.ranks), plan.v * plan.n
        xs = flat[:R]
        leaves = [flat[R + i * plan.k:R + (i + 1) * plan.k]
                  for i in range(R)]
        m = xs[0].shape[0]
        views = {(i, c): [p.detach()[plan.chunk(c)].requires_grad_(True)
                          for p in leaves[i]]
                 for i in range(R) for c in range(v)}
        state = [[None] * v for _ in range(R)]
        kept = [[] for _ in range(R)]
        apps = []
        for t in range(m + V - 1):
            if t > 0 and (n > 1 or v > 1):  # every stream one stage on
                sent = [torch.stack([_or_zero(y, x[0]) for y in st])
                        for st, x in zip(state, xs)]
                recv = mesh.collective("shift", sent, plan.axis, offset=1,
                                       cyclic=v > 1)
            state = [[None] * v for _ in range(R)]
            for d, c, pos, sub in plan.active(t, m):
                # device 0's chunk c takes stream c - 1 off the ring edge
                ins = [xs[i][t] if c == 0 and d == 0
                       else recv[i][c - 1 if d == 0 else c] for i in pos]
                ins = [x.detach().requires_grad_(not plan.remat)
                       for x in ins]
                with torch.set_grad_enabled(not plan.remat):
                    outs = plan.run(sub, pos, [views[i, c] for i in pos],
                                    ins)
                apps.append((t, d, c, pos, sub, ins,
                             None if plan.remat else outs))
                for i, o in zip(pos, outs):
                    state[i][c] = o.detach()
                    if c * n + d == V - 1:
                        kept[i].append(o.detach())
        like = torch.zeros((m,) + tuple(xs[0].shape[1:]), dtype=xs[0].dtype,
                           device=xs[0].device)
        outs = [torch.stack(k) if k else like.clone() for k in kept]
        ctx.plan, ctx.apps, ctx.m, ctx.views = plan, apps, m, views
        ctx.x_meta = [(x.shape, x.dtype) for x in xs]
        ctx.leaf_meta = [[(p.shape, p.dtype) for p in lv] for lv in leaves]
        if n == 1:
            return tuple(outs)
        # the last stage's outputs to every pp rank (the others add zeros)
        return tuple(mesh.collective("sum", outs, plan.axis))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *g_outs):
        plan, m, views = ctx.plan, ctx.m, ctx.views
        mesh, n, v = plan.mesh, plan.n, plan.v
        R, V = len(mesh.ranks), v * n
        gx = [torch.zeros(shape, dtype=dt, device=mesh.device)
              for shape, dt in ctx.x_meta]
        by_tick = {}
        for app in ctx.apps:
            by_tick.setdefault(app[0], []).append(app)
        like = g_outs[0][0]
        dx = [[None] * v for _ in range(R)]  # each chunk's input gradient
        for t in reversed(range(m + V - 1)):
            if t < m + V - 2 and (n > 1 or v > 1):
                # every stream one stage back; device 0's chunk c + 1 took
                # the last device's stream c
                sent = [torch.stack([
                    _or_zero(dx[i][c + 1] if c + 1 < v else None, like)
                    if plan.pp[i] == 0 else _or_zero(dx[i][c], like)
                    for c in range(v)]) for i in range(R)]
                recv = mesh.collective("shift", sent, plan.axis, offset=-1,
                                       cyclic=v > 1)
            dx = [[None] * v for _ in range(R)]
            for _, d, c, pos, sub, ins, outs in by_tick.get(t, ()):
                dys = [g_outs[i][t - (V - 1)] if c * n + d == V - 1
                       else recv[i][c] for i in pos]
                if outs is None:  # remat: run the chunk again, with a graph
                    ins = [x.detach().requires_grad_(True) for x in ins]
                    with torch.enable_grad():
                        outs = plan.run(sub, pos, [views[i, c] for i in pos],
                                        ins)
                torch.autograd.backward(
                    outs, dys, inputs=list(ins) + [p for i in pos
                                                   for p in views[i, c]])
                for i, x in zip(pos, ins):
                    if x.grad is None:
                        continue
                    if c == 0 and d == 0:
                        gx[i][t] += x.grad
                    else:
                        dx[i][c] = x.grad
        gp = []
        for i in range(R):
            for j, (shape, dt) in enumerate(ctx.leaf_meta[i]):
                parts = [views[i, c][j].grad for c in range(v)]
                parts = [g if g is not None else torch.zeros(
                    views[i, c][j].shape, dtype=dt, device=mesh.device)
                    for c, g in enumerate(parts)]
                gp.append(torch.stack(parts)[None] if plan.interleaved
                          else parts[0][None])
        return (None, *gx, *gp)


def _pipeline(block_fn, stacked, x_mb, mesh, axis, v, interleaved, remat,
              over_group) -> list:
    xs = rank_inputs(mesh, x_mb)
    if not _shared(mesh, x_mb):
        xs = cc.copy(xs, mesh, axis)
    trees = rank_trees(stacked)
    plan = _Plan(mesh, axis, v, interleaved, _group_fn(block_fn, over_group),
                 trees, remat)
    flat = [p for t in trees for p in tree_leaves(t)]
    return list(_Pipeline.apply(plan, *xs, *flat))


def pipeline_spmd(stage_block_fn, stacked, x_mb, mesh, *, axis: str = "pp",
                  remat: bool = False, over_group: bool = False) -> list:
    """GPipe over `axis` of the mesh: stacked holds each held rank's stage
    tree (leaves with a leading (1, per) axis; a ShardedParams of
    stage_shards or the list of the trees), x_mb the (M, mb, ...)
    microbatches, one tensor every rank sees or the list of the held
    ranks' copies (stage 0's are consumed; module docstring).  Returns
    each held rank's (M, mb, ...) final-stage outputs.

    remat=True keeps only each stage application's input and runs it
    again in the backward."""
    return _pipeline(stage_block_fn, stacked, x_mb, mesh, axis, 1, False,
                     remat, over_group)


def make_pipelined_forward(block_fn, mesh, *, pp_axis: str = "pp",
                           remat: bool = False, over_group: bool = False):
    """fn(stacked, x_microbatches) -> pipeline_spmd over `mesh`."""
    mesh = as_mesh(mesh)

    def fn(stacked, x_mb):
        return pipeline_spmd(block_fn, stacked, x_mb, mesh, axis=pp_axis,
                             remat=remat, over_group=over_group)

    return fn


def pipeline_interleaved_spmd(stage_block_fn, stacked, x_mb, mesh, *,
                              axis: str = "pp", v: int = 2,
                              remat: bool = False,
                              over_group: bool = False) -> list:
    """The interleaved pipeline: each device holds v chunks (leaves with a
    leading (1, v, per) axis), virtual stage j = c * n + d on device d as
    chunk c, and the ring edge n - 1 -> 0 hands stream c to chunk c + 1
    (on an axis of one device, its own chunk c to chunk c + 1).
    M + v * n - 1 ticks; the same skips and arguments as pipeline_spmd's."""
    return _pipeline(stage_block_fn, stacked, x_mb, mesh, axis, v, True,
                     remat, over_group)


def make_interleaved_pipeline(block_fn, mesh, *, pp_axis: str = "pp",
                              v: int = 2, remat: bool = False,
                              over_group: bool = False):
    """make_pipelined_forward for params stacked with
    stack_stages_interleaved(..., v): v virtual stage chunks a device."""
    mesh = as_mesh(mesh)

    def fn(stacked, x_mb):
        return pipeline_interleaved_spmd(
            block_fn, stacked, x_mb, mesh, axis=pp_axis, v=v, remat=remat,
            over_group=over_group)

    return fn
