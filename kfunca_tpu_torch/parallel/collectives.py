"""Differentiable collectives over a mesh's axis, for both mesh forms.

Each function takes the per-rank tensors of the ranks the mesh holds (a
list over `mesh.ranks`) and returns their results, with a backward that is
the collective Megatron-LM pairs with it, so that code written over lists
computes the same gradients whether the ranks are steps of one process
(LocalMesh) or processes of a group (GroupMesh):

  copy            f: identity forward, sum of the ranks' gradients backward
                  (the entry of a column-parallel region)
  reduce          g: sum forward, identity backward (the exit of a
                  row-parallel region)
  gather          all-gather forward, each rank's chunk backward (a
                  replicated consumer, e.g. the embedding over d_model)
  scatter         each rank's chunk forward, all-gather backward
  all_gather      all-gather forward, reduce-scatter backward (fsdp weights:
                  each dp rank's gradient is a partial sum)
  reduce_scatter  reduce-scatter forward, all-gather backward
  shift           JAX's ppermute to the next (or previous) rank of the
                  axis, cyclic or not; backward the shift the other way
  all_to_all      the tiled lax.all_to_all; backward the all_to_all with
                  the split and concatenation dimensions swapped

Under Megatron's convention every rank back-propagates its own copy of a
replicated loss, and the gradient of a replicated activation is the same
on every rank.  A LocalMesh therefore seeds each held rank's loss, as a
process would.
"""

from __future__ import annotations

import torch


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, fwd, bwd, *xs):
        ctx.args = (mesh, axis, bwd)
        kind, kw = fwd
        return tuple(mesh.collective(kind, list(xs), axis, **kw))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        mesh, axis, (kind, kw) = ctx.args
        return (None,) * 4 + tuple(
            mesh.collective(kind, [g.contiguous() for g in gs], axis, **kw))


def _apply(xs, mesh, axis, dim, fwd, bwd) -> list:
    if mesh.size(axis) == 1:
        return list(xs)
    return list(_Collective.apply(mesh, axis, (fwd, {"dim": dim}),
                                  (bwd, {"dim": dim}), *xs))


def copy(xs, mesh, axis="tp"):
    return _apply(xs, mesh, axis, 0, "identity", "sum")


def reduce(xs, mesh, axis="tp"):
    return _apply(xs, mesh, axis, 0, "sum", "identity")


def gather(xs, mesh, axis="tp", dim=-1):
    return _apply(xs, mesh, axis, dim, "gather", "split")


def scatter(xs, mesh, axis="tp", dim=-1):
    return _apply(xs, mesh, axis, dim, "split", "gather")


def all_gather(xs, mesh, axis="dp", dim=0):
    return _apply(xs, mesh, axis, dim, "gather", "reduce_scatter")


def reduce_scatter(xs, mesh, axis="dp", dim=0):
    return _apply(xs, mesh, axis, dim, "reduce_scatter", "gather")


def all_reduce(xs, mesh, axis="tp", op="sum") -> list:
    """The plain all-reduce, outside autograd (statistics, gradients)."""
    if mesh.size(axis) == 1:
        return list(xs)
    with torch.no_grad():
        return mesh.collective(op, [x.detach() for x in xs], axis)


def shift(xs, mesh, axis="pp", offset=1, cyclic=True):
    """Rank i of the axis takes rank i - offset's tensor (offset 1: from
    the previous rank, -1: from the next); without `cyclic` the ranks with
    no sender take zeros.  The backward shifts the gradients back."""
    if mesh.size(axis) == 1:
        return list(xs) if cyclic else [torch.zeros_like(x) for x in xs]
    fwd = ("shift", {"cyclic": cyclic, "offset": offset})
    bwd = ("shift", {"cyclic": cyclic, "offset": -offset})
    return list(_Collective.apply(mesh, axis, fwd, bwd, *xs))


def all_to_all(xs, mesh, axis="ep", split_dim=0, concat_dim=1):
    """The tiled all_to_all: each rank splits its tensor along split_dim
    into one chunk a rank of the axis and concatenates what it receives
    along concat_dim, in axis order.  The backward is the all_to_all with
    the two dimensions swapped."""
    if mesh.size(axis) == 1:
        return list(xs)
    fwd = ("all_to_all", {"split_dim": split_dim, "dim": concat_dim})
    bwd = ("all_to_all", {"split_dim": concat_dim, "dim": split_dim})
    return list(_Collective.apply(mesh, axis, fwd, bwd, *xs))
