"""Elementwise op family: add/sub/mul/div, fill, copy, dtype convert, unary math.

Counterpart of kfunca_tpu/ops/elementwise.py (the reference's
binary_ops.cpp + tensor_loops.h), with the reference's dtype contract:

  * operands promote to a common dtype (kfunca's table, core/dtype.py),
  * math runs in the *accumulation* dtype (fp16/bf16 compute in fp32,
    integers in int64; reference binary_ops_kernel.cu:34-60),
  * results store back in the common dtype, then in the output tensor's
    dtype when an explicit out is given (dynamic-cast store).

Each op is one call of core/dispatch.run_op; K9 serves the eight ops of
the TPU kernel under KFUNCA_ELEMENTWISE_ENGINE=pallas.  The grad functions
compute in plain torch, as the JAX package's do in jnp.
"""

from __future__ import annotations

import torch

from ..core.dispatch import run_op
from ..core.dtype import (
    ScalarType,
    accumulate_type,
    cast,
    is_floating_type,
    is_integral_type,
    to_torch,
)
from ..core.iterator import plan_loops
from ..core.tensor import GradFunction, Tensor, adopt_flat


def wrap_array(arr: torch.Tensor, dtype: ScalarType) -> Tensor:
    """A fresh contiguous Tensor holding `arr` in `dtype`.  A view (of some
    storage, or of nothing) is copied; an op's fresh result is adopted."""
    arr = cast(arr, to_torch(dtype))
    if arr._is_view() or not arr.is_contiguous():
        arr = arr.clone(memory_format=torch.contiguous_format)
    return adopt_flat(arr.reshape(-1), tuple(arr.shape), dtype)


def _acc_of(common: ScalarType) -> ScalarType:
    acc = accumulate_type(common)
    return common if acc == ScalarType.Undefined else acc


def _reduce_grad_to_shape(g, shape):
    """Sum-reduce a broadcast gradient back to an input's shape."""
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    if axes:
        g = g.sum(dim=axes, keepdim=True)
    return g


class BinaryGradFunction(GradFunction):
    """Tape node for add/sub/mul/div (generalizes reference AddGradFunction,
    binary_ops.cpp:18-28, to all four ops with broadcast-aware reduction)."""

    def __init__(self, name, a: Tensor, b: Tensor):
        super().__init__([a, b])
        self.name = name

    def backward(self, grad_output: Tensor):
        a, b = self.inputs
        g = grad_output._array()
        dt = grad_output.dtype()
        if self.name == "add":
            ga, gb = g, g
        elif self.name == "sub":
            ga, gb = g, -g
        elif self.name == "mul":
            ga = g * b._array().to(g.dtype)
            gb = g * a._array().to(g.dtype)
        elif self.name == "div":
            B = b._array().to(g.dtype)
            ga = g / B
            gb = -g * a._array().to(g.dtype) / (B * B)
        else:
            raise ValueError(self.name)
        ga = _reduce_grad_to_shape(ga, tuple(a.sizes()))
        gb = _reduce_grad_to_shape(gb, tuple(b.sizes()))
        return [wrap_array(ga, dt), wrap_array(gb, dt)]


def binary_op(name, a: Tensor, b: Tensor, out: Tensor | None = None, track_grad=True) -> Tensor:
    plan = plan_loops([a, b], out=out)
    common = plan.common_dtype
    acc = _acc_of(common)
    if out is not None and out.defined():
        run_op(name, [a, b], out=out, out_shape=plan.out_shape,
               acc=to_torch(acc), common=to_torch(common))
        return out
    out = wrap_array(run_op(name, [a, b], out_shape=plan.out_shape,
                            acc=to_torch(acc), common=to_torch(common)), common)
    if track_grad and (a.requires_grad() or b.requires_grad()) and is_floating_type(common):
        out.set_requires_grad(True)
        out.set_grad_fn(BinaryGradFunction(name, a, b))
    return out


def binary_scalar_op(name, t: Tensor, scalar, out: Tensor | None = None) -> Tensor:
    """Tensor-op-scalar as one op, the scalar a 0-d operand in the acc
    dtype (semantics of the reference's `self op empty_like().fill_(s)`
    pattern, register.cpp:172-206 — the scalar adopts the tensor's dtype —
    without materializing the filled tensor)."""
    common = t.dtype()
    acc = _acc_of(common)
    scalar = int(scalar) if is_integral_type(common) else float(scalar)
    shape = tuple(t.sizes())
    kw = dict(out_shape=shape, acc=to_torch(acc), common=to_torch(common),
              fill_value=scalar)
    if out is not None and out.defined():
        run_op(name + "_scalar", [t], out=out, **kw)
        return out
    return wrap_array(run_op(name + "_scalar", [t], **kw), common)


def fill_(t: Tensor, value) -> Tensor:
    """Nullary fill (reference nullary_ops.cpp:6-14); value is cast to the
    tensor dtype, matching the any_t double carrier."""
    value = int(value) if is_integral_type(t.dtype()) else float(value)
    dt = to_torch(t.dtype())
    run_op("fill", [], out=t, out_shape=tuple(t.sizes()), acc=dt, common=dt,
           fill_value=value)
    return t


def copy_(dst: Tensor, src: Tensor) -> Tensor:
    """copy_ with broadcast + dtype cast (reference unary_ops.cpp copy_)."""
    plan_loops([src], out=None)  # device check
    dt = to_torch(dst.dtype())
    run_op("copy", [src], out=dst, out_shape=tuple(dst.sizes()), acc=dt, common=dt)
    return dst


def convert(t: Tensor, dtype: ScalarType) -> Tensor:
    """dtype conversion as a fresh contiguous tensor (reference
    unary_ops.cpp convert: CopyFunctor over the output dtype)."""
    dt = to_torch(dtype)
    return wrap_array(run_op("copy", [t], out_shape=tuple(t.sizes()), acc=dt,
                             common=dt), dtype)


# -- unary math family (capability extension: the reference's unary layer has
#    only clone/copy/convert, unary_ops.cpp:7-24; these round out the eager
#    API with the same acc-dtype contract and tape autograd) ----------------

_UNARY_GRAD = {
    "neg": lambda x, y, g: -g,
    "abs": lambda x, y, g: g * torch.sign(x),
    "exp": lambda x, y, g: g * y,
    "log": lambda x, y, g: g / x,
    "sqrt": lambda x, y, g: g * 0.5 / y,
    "rsqrt": lambda x, y, g: g * (-0.5) * y / x,
    "relu": lambda x, y, g: g * (x > 0),
    "sigmoid": lambda x, y, g: g * y * (1 - y),
    "tanh": lambda x, y, g: g * (1 - y * y),
}


class UnaryGradFunction(GradFunction):
    def __init__(self, name, x: Tensor, y: Tensor):
        super().__init__([x])
        self.name = name
        self.y = y

    def backward(self, grad_output: Tensor):
        x = self.inputs[0]
        g = grad_output._array().float()
        gx = _UNARY_GRAD[self.name](x._array().float(), self.y._array().float(), g)
        return [wrap_array(gx, x.dtype())]


def unary_op(name, t: Tensor, out: Tensor | None = None, track_grad=True) -> Tensor:
    common = t.dtype()
    acc = _acc_of(common)
    kw = dict(out_shape=tuple(t.sizes()), acc=to_torch(acc), common=to_torch(common))
    if out is not None and out.defined():
        run_op(name, [t], out=out, **kw)
        return out
    out = wrap_array(run_op(name, [t], **kw), common)
    if track_grad and t.requires_grad() and is_floating_type(common):
        out.set_requires_grad(True)
        out.set_grad_fn(UnaryGradFunction(name, t, out))
    return out

