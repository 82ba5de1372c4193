"""Strided-view reads and writes over a flat storage tensor.

Counterpart of kfunca_tpu/core/materialize.py.  The JAX package lowers a
view to slices, transposes and gathers, because a jax.Array has no strides.
A torch tensor has them, so a view with non-negative strides is
`torch.as_strided` over the storage: reading it copies nothing and writing
through it updates the storage in place.  Negative strides (legal for
as_strided views inside a storage, not for torch.as_strided) go through a
flat gather or scatter of the addresses the view names.  Those addresses
are built over the view's loop nest as `plan_view` reorders and coalesces
it (the native core's kf_plan_loop_nest, or its Python form), so a view
whose dims merge in memory indexes fewer dims.

Writes refuse a self-overlapping target (reference memory_overlap.h; on the
card such a write is a data race), and a value that shares memory with the
target is copied before it is written, so a write reads what the target
held before it (the JAX package's semantics: its buffers are immutable).
"""

from __future__ import annotations

import math
from functools import cmp_to_key, lru_cache

import torch

from ..runtime import _native
from ..utils.errors import check
from .dtype import cast
from .overlap import may_self_overlap


def contiguous_strides(shape) -> tuple:
    return _contiguous_strides(tuple(int(s) for s in shape))


@lru_cache(maxsize=4096)
def _contiguous_strides(shape: tuple) -> tuple:
    strides = [1] * len(shape)
    acc = 1
    for d in range(len(shape) - 1, -1, -1):
        strides[d] = acc
        acc *= int(shape[d])
    return tuple(strides)


def is_contiguous(shape, strides) -> bool:
    # dims of extent 1 have don't-care strides (reference tensor_impl.cpp
    # computes contiguity the same way via the stride product test)
    acc = 1
    for d in range(len(shape) - 1, -1, -1):
        if shape[d] != 1 and strides[d] != acc:
            return False
        acc *= int(shape[d])
    return True


def numel_of(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _plan_view_py(shape, strides):
    """Python form of kf_plan_loop_nest for one operand: stable-sort dims
    by descending stride (ties: larger extent first), then merge adjacent
    dims that are contiguous in memory."""
    ndim = len(shape)

    def cmp(a, b):
        sa, sb = strides[a], strides[b]
        if sa != 0 and sb != 0:
            if sa != sb:
                return -1 if sa > sb else 1
            if shape[a] != shape[b]:
                return -1 if shape[a] > shape[b] else 1
        return 0

    perm = sorted(range(ndim), key=cmp_to_key(cmp))
    nshp = [shape[p] for p in perm]
    nstr = [strides[p] for p in perm]
    cshape, cstr = [nshp[0]], [nstr[0]]
    for d in range(1, ndim):
        if cshape[-1] == 1:
            cshape[-1], cstr[-1] = nshp[d], nstr[d]
        elif nshp[d] == 1:
            pass
        elif cstr[-1] == nstr[d] * nshp[d]:
            cshape[-1] *= nshp[d]
            cstr[-1] = nstr[d]
        else:
            cshape.append(nshp[d])
            cstr.append(nstr[d])
    return tuple(perm), tuple(nshp), tuple(cshape), tuple(cstr)


def plan_view(shape: tuple, strides: tuple):
    """(perm, permuted shape, coalesced shape, coalesced strides) of one
    view's loop nest, through the native core when it is loaded; None for
    a 0-d view.  A gather over the coalesced nest, reshaped to the
    permuted shape and permuted back, is the view."""
    if not shape:
        return None
    lib = _native.get_lib()
    if lib is None:
        return _plan_view_py(shape, strides)
    return _plan_view_native(lib, tuple(shape), tuple(strides))


@lru_cache(maxsize=4096)
def _plan_view_native(lib, shape: tuple, strides: tuple):
    ndim = len(shape)
    out_shape, out_strides, out_perm = (_native.i64_array([0] * ndim)
                                        for _ in range(3))
    rank = lib.kf_plan_loop_nest(1, ndim, _native.i64_array(shape),
                                 _native.i64_array(strides), out_shape,
                                 out_strides, out_perm, None)
    check(rank > 0, "loop-nest planner failed for", shape, strides)
    perm = tuple(out_perm[i] for i in range(ndim))
    return (perm, tuple(shape[p] for p in perm),
            tuple(out_shape[i] for i in range(rank)),
            tuple(out_strides[i] for i in range(rank)))


def _nest_indices(shape, strides, offset: int, device) -> torch.Tensor:
    idx = torch.full(tuple(shape), int(offset), dtype=torch.int64, device=device)
    for d, (n, s) in enumerate(zip(shape, strides)):
        if n > 1 and s != 0:
            view = [1] * len(shape)
            view[d] = n
            idx = idx + torch.arange(n, device=device).reshape(view) * int(s)
    return idx


def flat_indices(shape, strides, offset: int, device) -> torch.Tensor:
    """int64 storage address of every element of the view, in its shape,
    built over the view's coalesced loop nest (`plan_view`)."""
    plan = plan_view(tuple(shape), tuple(strides))
    if plan is None:
        return torch.full((), int(offset), dtype=torch.int64, device=device)
    perm, nshp, cshape, cstrides = plan
    inv = sorted(range(len(perm)), key=perm.__getitem__)
    return (_nest_indices(cshape, cstrides, offset, device)
            .reshape(nshp).permute(inv))


def read_view(data: torch.Tensor, shape, strides, offset: int) -> torch.Tensor:
    """The view as a tensor of `shape`: a torch view of `data` (no copy)
    for non-negative strides, a gathered copy otherwise."""
    shape = tuple(int(x) for x in shape)
    strides = tuple(int(x) for x in strides)
    if all(s >= 0 for s in strides):
        return torch.as_strided(data, shape, strides, int(offset))
    return data[flat_indices(shape, strides, offset, data.device)]


def shares_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.numel() > 0 and b.numel() > 0
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


def write_view(data: torch.Tensor, shape, strides, offset: int, value) -> None:
    """Write `value` (broadcast to `shape`, converted to data's dtype)
    through the view, in place."""
    shape = tuple(int(x) for x in shape)
    strides = tuple(int(x) for x in strides)
    offset = int(offset)
    whole = (is_contiguous(shape, strides) and offset == 0
             and numel_of(shape) == data.numel())
    if not whole:
        check(
            not may_self_overlap(shape, strides),
            "write through a self-overlapping view is rejected",
        )
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=data.dtype, device=data.device)
    if value.device != data.device:
        value = value.to(data.device)
    value = cast(value, data.dtype)
    if shares_memory(value, data):
        value = value.clone()
    if numel_of(shape) == 0:
        return
    if whole:
        data.view(shape).copy_(value)
    elif all(s >= 0 for s in strides):
        torch.as_strided(data, shape, strides, offset).copy_(value)
    else:
        idx = flat_indices(shape, strides, offset, data.device)
        data[idx.reshape(-1)] = value.expand(shape).reshape(-1)
