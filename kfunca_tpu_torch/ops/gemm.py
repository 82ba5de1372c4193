"""GEMM: alpha * (A @ B), with a gradient on the tape.

Counterpart of kfunca_tpu/ops/gemm.py (the reference's CUTLASS gemm,
gemm_kernel.cu:8-38): A of any rank is flattened to (m, k), B must be 2-D,
out = A.sizes with the last dim replaced by n (gemm_ops.cpp:6-16).

`beta` is accepted for reference API parity but is INERT: there is no C
operand to accumulate into (the reference applies beta to a freshly
allocated, uninitialized output), so the only well-defined behaviour is
beta contributing nothing.

Engine, read at dispatch time (KFUNCA_GEMM_ENGINE, as in the JAX package):
  * `xla` (default): the vendor product, torch.mm (cuBLAS on the card),
    as the JAX package leaves its default to XLA's dot: fp32 at full
    precision (TF32 is off, runtime/backend.resolve_device), 16-bit inputs
    summed in fp32 and rounded once;
  * `pallas`: K3, the hand-written kernel (ops/pallas_kernels/matmul.py),
    for fp32 / bf16 / fp16; on CUDA tensors it launches or the call raises,
    on CPU tensors its plain version runs.  fp64 stays on the vendor path.
The backward (dA = alpha * g @ B^T, dB = alpha * A^T @ g) goes through the
same engine, so K3 runs twice per gemm node there.
"""

from __future__ import annotations

import os

import torch

from ..core.dtype import is_floating_type, to_torch
from ..core.iterator import check
from ..core.tensor import GradFunction, Tensor, adopt_flat
from ..runtime.launcher import Launcher
from .pallas_kernels.matmul import matmul as k3_matmul

_K3_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _gemm_engine() -> str:
    return os.environ.get("KFUNCA_GEMM_ENGINE", "xla")


def _library_mm(A, B, out_dtype):
    """The vendor product with the JAX package's preferred_element_type:
    16-bit inputs sum in fp32 and round once to out_dtype.  On the card
    that is cuBLAS's 16-bit GEMM (fp32 accumulation, reduced-precision
    reductions off, runtime/backend.resolve_device); on the CPU the inputs
    widen to fp32, whose products of 16-bit values are exact."""
    if A.dtype in (torch.bfloat16, torch.float16):
        if A.device.type == "cuda" and out_dtype == A.dtype:
            return torch.mm(A, B)
        return (A.float() @ B.float()).to(out_dtype)
    return (A @ B).to(out_dtype)


def matmul_2d(A, B, out_dtype, engine: str | None = None):
    """(m,k) @ (k,n) with fp32 accumulation, in out_dtype."""
    if engine is None:
        engine = _gemm_engine()
    if A.dtype != B.dtype:  # jnp.matmul promotes mixed operands
        ct = torch.promote_types(A.dtype, B.dtype)
        A, B = A.to(ct), B.to(ct)
    if engine == "pallas" and A.dtype in _K3_DTYPES:
        return k3_matmul(A, B, out_dtype=out_dtype)
    return _library_mm(A, B, out_dtype)


def _scale(r, alpha: float):
    """r * alpha with alpha in r's dtype, as the JAX package multiplies."""
    if alpha == 1.0:
        return r
    return r * torch.full((), alpha, dtype=r.dtype, device=r.device)


class GemmGradFunction(GradFunction):
    def __init__(self, a: Tensor, b: Tensor, alpha: float):
        super().__init__([a, b])
        self.alpha = alpha

    def backward(self, grad_output: Tensor):
        from .elementwise import wrap_array

        a, b = self.inputs
        g = grad_output._array()
        g2 = g.reshape(-1, g.shape[-1])
        A2 = a._array().reshape(-1, a.shape(-1))
        dt = to_torch(a.dtype())
        ga = _scale(matmul_2d(g2, b._array().t(), dt), self.alpha)
        gb = _scale(matmul_2d(A2.t(), g2, dt), self.alpha)
        return [wrap_array(ga.reshape(tuple(a.sizes())), a.dtype()),
                wrap_array(gb, b.dtype())]


def gemm(a: Tensor, b: Tensor, alpha: float = 1.0, beta: float = 0.0) -> Tensor:
    check(b.dim() == 2, "gemm: b must be 2-D")
    check(a.dim() >= 1, "gemm: a must have rank >= 1")
    check(a.dtype() == b.dtype(), "gemm: dtype mismatch")
    check(is_floating_type(a.dtype()), "gemm: floating dtypes only")
    check(a.shape(-1) == b.shape(0), "gemm: inner dims mismatch")
    check(a.device() == b.device(), "gemm: device mismatch")
    out_shape = tuple(a.sizes()[:-1] + [b.shape(1)])

    def run():
        A = a._array().reshape(-1, a.shape(-1))
        r = _scale(matmul_2d(A, b._array(), to_torch(a.dtype())), float(alpha))
        # beta scales the (never initialized) fresh output: it contributes
        # nothing, kept for reference API parity (gemm_ops.cpp:6-16)
        return r.reshape(-1)

    flat = Launcher.instance().submit(run, name="gemm", device=a.torch_device())
    out = adopt_flat(flat, out_shape, a.dtype())
    if a.requires_grad() or b.requires_grad():
        out.set_requires_grad(True)
        out.set_grad_fn(GemmGradFunction(a, b, float(alpha)))
    return out
