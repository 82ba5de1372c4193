"""Reduction family: sum / mean / mean_var / norm_stat.

Counterpart of kfunca_tpu/ops/reduce.py (the reference's reduce_ops.cpp,
tensor_reduce.h:994-1083, welford_norm.h).  Contracts kept:

  * keepdim outputs (reduced dim -> extent 1),
  * accumulation in the widened dtype (fp16/bf16 -> fp32, int -> int64),
    output in the input dtype (an int32 sum is computed in int64 and
    stored as int32; an integer mean divides in float64 and truncates),
  * mean_var(dim, take_sqrt) -> (mean, var) with correction=1 (unbiased),
    sqrt applied to var when requested,
  * norm_stat(dim) -> (mean, invstd) with biased variance and eps=1e-12.

Engines, read at dispatch time as in the JAX package: KFUNCA_REDUCE_ENGINE
defaults to `xla` (plain torch) for sum and mean, and `pallas` sends them
to K8 (ops/pallas_kernels/reduce.py) when the accumulation is fp32 and the
tensor holds at least 65,536 elements.  norm_stat has its own default,
`pallas`: K7 (ops/pallas_kernels/welford.py) for a 2-D fp32 tensor
reduced over dim 0.  On CUDA tensors a selected kernel launches or the
call raises; on CPU tensors its plain version runs.
"""

from __future__ import annotations

import os

import torch

from ..core.dtype import ScalarType, cast, to_torch
from ..core.iterator import check, plan_reduce
from ..core.tensor import GradFunction, Tensor
from ..runtime.launcher import Launcher
from .elementwise import wrap_array
from .pallas_kernels.reduce import reduce_2d
from .pallas_kernels.welford import EPS, welford_norm_stat

K8_MIN_NUMEL = 1 << 16


class SumGradFunction(GradFunction):
    """Broadcast the output grad back over the reduced dim (extension; the
    reference has no reduction autograd)."""

    def __init__(self, t: Tensor, scale: float):
        super().__init__([t])
        self.scale = scale

    def backward(self, grad_output: Tensor):
        t = self.inputs[0]
        g = cast(grad_output._array(), to_torch(t.dtype()))
        g = g.expand(tuple(t.sizes())) * self.scale
        return [wrap_array(g, t.dtype())]


def _reduce_engine() -> str:
    return os.environ.get("KFUNCA_REDUCE_ENGINE", "xla")


def _norm_stat_engine() -> str:
    return os.environ.get("KFUNCA_REDUCE_ENGINE", "pallas")


def _reduce_common(t: Tensor, dim: int, mean: bool) -> Tensor:
    plan = plan_reduce(t, dim)
    name = "mean" if mean else "sum"
    out_dt = to_torch(t.dtype())

    def run():
        A = t._array()
        if (_reduce_engine() == "pallas" and plan.acc_dtype == ScalarType.Float
                and t.numel() >= K8_MIN_NUMEL):
            moved = A.movedim(plan.dim, 0)
            r = reduce_2d(moved.reshape(moved.shape[0], -1), op=name, out_dt=out_dt)
            return r.reshape((1,) + tuple(moved.shape[1:])).movedim(0, plan.dim)
        r = cast(A, to_torch(plan.acc_dtype)).sum(dim=plan.dim, keepdim=True)
        if mean:
            n = A.shape[plan.dim]
            r = r / n if r.is_floating_point() else r.double() / n
        return cast(r, out_dt)

    r = Launcher.instance().submit(run, name=name, device=t.torch_device())
    out = wrap_array(r, t.dtype())
    if t.requires_grad():
        out.set_requires_grad(True)
        out.set_grad_fn(SumGradFunction(t, 1.0 / t.shape(plan.dim) if mean else 1.0))
    return out


def sum(t: Tensor, dim: int) -> Tensor:  # noqa: A001 - mirrors reference API
    return _reduce_common(t, dim, mean=False)


def mean(t: Tensor, dim: int) -> Tensor:
    return _reduce_common(t, dim, mean=True)


def _as_float(A, acc: ScalarType):
    """A in the acc dtype; integer and bool accumulators average in float64
    (jnp.mean of an int64 array is float64)."""
    A = cast(A, to_torch(acc))
    return A if A.is_floating_point() else A.double()


def mean_var(t: Tensor, dim: int, take_sqrt: bool):
    plan = plan_reduce(t, dim)

    def run():
        A = _as_float(t._array(), plan.acc_dtype)
        n = A.shape[plan.dim]
        m = A.mean(dim=plan.dim, keepdim=True)
        var = ((A - m) * (A - m)).sum(dim=plan.dim, keepdim=True) / max(n - 1, 1)
        if take_sqrt:
            var = torch.sqrt(var)
        return m, var

    m, v = Launcher.instance().submit(run, name="mean_var", device=t.torch_device())
    return wrap_array(m, t.dtype()), wrap_array(v, t.dtype())


def norm_stat(t: Tensor, dim: int):
    """Fused batch-norm-style statistics: (mean, invstd) reducing `dim`
    (reference welford_norm.h + norm_ops_kernel.cu; eps=1e-12)."""
    plan = plan_reduce(t, dim)
    check(plan.acc_dtype in (ScalarType.Float, ScalarType.Double), "norm_stat: float only")

    def run():
        A = t._array()
        if (_norm_stat_engine() == "pallas" and t.dim() == 2 and plan.dim == 0
                and t.dtype() == ScalarType.Float):
            return welford_norm_stat(A)
        A = cast(A, to_torch(plan.acc_dtype))
        m = A.mean(dim=plan.dim, keepdim=True)
        var = ((A - m) * (A - m)).mean(dim=plan.dim, keepdim=True)
        return m, 1.0 / torch.sqrt(var + EPS)

    m, invstd = Launcher.instance().submit(run, name="norm_stat", device=t.torch_device())
    return wrap_array(m, t.dtype()), wrap_array(invstd, t.dtype())
