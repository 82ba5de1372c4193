"""Op planning: broadcast, type promotion, device checks, reduction shapes.

Counterpart of kfunca_tpu/core/iterator.py (the reference TensorIterator
build pipeline, tensor_iterator.cpp:486-528).  The plan records the
broadcast output shape and the common dtype; execution runs on dense views
(core/materialize.py).  As in the JAX package, broadcasting and promotion
run in the native core (csrc/core.cpp: kf_broadcast_shapes, kf_promote)
when it is loaded and in Python otherwise (KFUNCA_NO_NATIVE=1);
tests/test_torch_native_core.py holds the two together.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

from ..runtime import _native
from ..utils.errors import check
from .dtype import ScalarType, accumulate_type, promote

MAX_TENSOR_DIMS = 12


def maybe_wrap_dim(dim: int, ndim: int) -> int:
    if dim < 0:
        dim += ndim
    check(0 <= dim < max(ndim, 1), "dim", dim, "out of range for ndim", ndim)
    return dim


def broadcast_shapes(*shapes) -> tuple:
    """Size-1 stretch broadcasting (reference tensor_iterator.cpp:110-147).
    Outputs may not broadcast; that is enforced by the caller."""
    ndim = max(len(s) for s in shapes)
    out = []
    for i in range(ndim):
        dim = 1
        for s in shapes:
            j = i - (ndim - len(s))
            if j < 0:
                continue
            v = int(s[j])
            if v != 1:
                check(dim in (1, v), "broadcast shape mismatch:", shapes)
                dim = v
        out.append(dim)
    return tuple(out)


@dataclass
class LoopPlan:
    out_shape: tuple
    common_dtype: ScalarType
    device: object


def _native_plan(lib, inputs):
    """Broadcast shape and common dtype through the native core."""
    shapes = [t.sizes() for t in inputs]
    ndims = _native.i64_array([len(s) for s in shapes])
    flat = _native.i64_array([d for s in shapes for d in s])
    out_ndim = ctypes.c_int64()
    out_shape = (ctypes.c_int64 * MAX_TENSOR_DIMS)()
    check(max(len(s) for s in shapes) <= MAX_TENSOR_DIMS, "too many dims")
    rc = lib.kf_broadcast_shapes(len(shapes), ndims, flat,
                                 ctypes.byref(out_ndim), out_shape)
    check(rc == 0, "broadcast shape mismatch:", shapes)
    common = ScalarType.Undefined
    for t in inputs:
        common = ScalarType(lib.kf_promote(common, t.dtype()))
    return tuple(out_shape[i] for i in range(out_ndim.value)), common


def plan_loops(inputs, out=None) -> LoopPlan:
    """Plan an elementwise op over `inputs` (Tensors): common-device check
    -> dtype promotion -> broadcast shape -> output-shape validation
    (outputs never broadcast)."""
    check(len(inputs) >= 1, "need at least one input")
    device = inputs[0].device()
    for t in inputs:
        check(t.device() == device, "all operands must live on one device")
    first = inputs[0].impl()
    if all(
        t.impl().shape == first.shape and t.impl().dtype == first.dtype
        for t in inputs[1:]
    ):
        shape, common = first.shape, first.dtype
    elif (lib := _native.get_lib()) is not None:
        shape, common = _native_plan(lib, inputs)
    else:
        common = ScalarType.Undefined
        for t in inputs:
            common = promote(common, t.dtype())
        shape = broadcast_shapes(*[t.sizes() for t in inputs])
    check(len(shape) <= MAX_TENSOR_DIMS, "too many dims")
    if out is not None and out.defined():
        check(tuple(out.sizes()) == tuple(shape), "output may not broadcast:",
              out.sizes(), shape)
        check(out.device() == device, "output on wrong device")
    return LoopPlan(out_shape=tuple(shape), common_dtype=common, device=device)


@dataclass
class ReducePlan:
    dim: int
    out_shape: tuple  # keepdim semantics: reduced dim -> 1
    acc_dtype: ScalarType
    device: object


def plan_reduce(t, dim: int) -> ReducePlan:
    dim = maybe_wrap_dim(dim, t.dim())
    shape = list(t.sizes())
    shape[dim] = 1
    acc = accumulate_type(t.dtype())
    if acc == ScalarType.Undefined:
        acc = t.dtype()
    return ReducePlan(dim=dim, out_shape=tuple(shape), acc_dtype=acc, device=t.device())
