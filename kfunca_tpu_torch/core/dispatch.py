"""Eager dispatch: one elementwise op through its views, in the acc dtype.

Counterpart of kfunca_tpu/core/dispatch.py.  The JAX package compiles one
program per (op, layouts, dtypes) and caches it; PyTorch runs eagerly, so
the port has no program caches.  The semantics are the same:

  1. read every operand through its strided view (core/materialize.py),
  2. compute in the accumulate dtype and cast to the common dtype
     (reference acc-type contract, binary_ops_kernel.cu:34-60),
  3. write the result: adopted as a fresh contiguous storage, or written
     through the out= view in place (a self-overlapping target is refused).

Every op funnels through Launcher.submit, so set_sync_mode and
set_profiling_mode observe all eager ops.

Engine.  The compute step defaults to plain torch (the JAX package's
default is XLA).  KFUNCA_ELEMENTWISE_ENGINE=pallas routes the eight ops of
K9 (add, sub, mul, div, copy, neg, abs, exp) with no broadcast through
ops/pallas_kernels/elementwise.py, read at dispatch time: on CUDA tensors
the hand-written kernel launches (or the call raises), on CPU tensors its
plain version runs.  The JAX package also asks for a numel that is a
multiple of 128 (its lane tiling); the card's kernel takes any numel, so
that rule is dropped.  Scalar ops and fill stay plain torch, as they stay
XLA in the JAX package.
"""

from __future__ import annotations

import os

import torch

from ..ops.pallas_kernels import elementwise as k9
from ..runtime.launcher import Launcher
from .dtype import cast

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    # C-style trunc division for ints, true division for floats
    "div": k9._div,
}


def _float_in(fn):
    """A transcendental in float64 for integer inputs, as jnp widens them."""
    return lambda x: fn(x if x.is_floating_point() else x.double())


_UNARY = {
    "copy": lambda x: x,
    "neg": torch.neg,
    "abs": torch.abs,
    "exp": _float_in(torch.exp),
    "log": _float_in(torch.log),
    "sqrt": _float_in(torch.sqrt),
    "rsqrt": _float_in(torch.rsqrt),
    "relu": lambda x: torch.clamp_min(x, 0),
    "sigmoid": _float_in(torch.sigmoid),
    "tanh": _float_in(torch.tanh),
}

_OPS = {**_BINARY, **_UNARY}


def elementwise_engine() -> str:
    return os.environ.get("KFUNCA_ELEMENTWISE_ENGINE", "xla")


def run_op(op, inputs, out=None, out_shape=None, acc=None, common=None, fill_value=None):
    """Execute an eager elementwise op.

    inputs: list[Tensor] (read through their views)
    out:    optional Tensor written through its view, in place
    out_shape: broadcast result shape (defaults to out's shape)
    acc/common: torch dtypes for the math / result
    Returns the result (a torch tensor of out_shape, possibly a view of an
    input, for ops/elementwise.wrap_array to adopt or copy) when out is
    None, else writes out's storage and returns None.
    """
    if out is not None and out_shape is None:
        out_shape = tuple(out.sizes())
    out_shape = tuple(out_shape)
    dev = (inputs[0] if inputs else out).torch_device()

    def compute():
        arrs = [t._array() for t in inputs]
        direct = None  # the kernel wrote the whole out storage itself
        if op == "fill":
            r = torch.full((), fill_value, dtype=common, device=dev)
        elif op.endswith("_scalar"):
            s = torch.full((), fill_value, dtype=acc, device=dev)
            r = cast(_BINARY[op[: -len("_scalar")]](cast(arrs[0], acc), s), common)
        elif (elementwise_engine() == "pallas" and op in k9.OPS
              and all(tuple(a.shape) == out_shape for a in arrs)):
            target = None
            if out is not None:
                oimpl = out.impl()
                whole = (oimpl.numel == oimpl.storage.numel and oimpl.is_contiguous()
                         and oimpl.offset == 0 and oimpl.storage.data.dtype == common)
                if whole:
                    target = oimpl.storage.data
            r = k9.elementwise(op, *[a.contiguous() for a in arrs], acc_dt=acc,
                               out_dt=common, out=target)
            direct = target is not None
        else:
            r = cast(_OPS[op](*[cast(a, acc) for a in arrs]), common)
        if out is None:  # (expand makes a view, which wrap_array would copy)
            return r if tuple(r.shape) == out_shape else r.expand(out_shape)
        if not direct:
            out._write(r)
        return None

    return Launcher.instance().submit(compute, name=op, device=dev)
