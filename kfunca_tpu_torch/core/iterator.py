"""Op planning: broadcast, type promotion, device checks, reduction shapes.

Counterpart of kfunca_tpu/core/iterator.py (the reference TensorIterator
build pipeline, tensor_iterator.cpp:486-528).  The plan records the
broadcast output shape and the common dtype; execution runs on dense views
(core/materialize.py).  The JAX package runs this in its native C++ planner
when it is built and in Python otherwise; the port keeps the Python
planner, which tests/test_native_core.py pins equal to the native one.  The
native core's loader waits for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

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
