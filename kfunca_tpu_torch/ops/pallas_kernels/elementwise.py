"""Elementwise kernel family K9 (contiguous operands).

Counterpart of kfunca_tpu/ops/pallas_kernels/elementwise.py.  On CUDA
tensors `elementwise` launches the hand-written kernel in
csrc/elementwise.cu (counted in `elementwise.launches`); on CPU tensors it
runs `elementwise_plain`.  There is no fallback between the two.

Contract (both routes, the TPU kernel's): the eight ops add, sub, mul, div,
copy, neg, abs, exp over same-shape operands; each operand is widened to
`acc_dt`, the math runs there, the result is stored in `out_dt`.  Integer
division truncates toward zero with XLA's answers where C leaves them open
(x / 0 = -1, INT_MIN / -1 = INT_MIN); a float stored into an integer type
saturates and NaN becomes 0, as XLA converts (core/dtype.cast).

The TPU kernel needs numel % 128 == 0 (its (rows, 128) lane tiling); the
card's kernel takes any numel, so the port drops that rule.  Strided views
are made contiguous by the caller first, as the JAX package materializes
them before its kernel.

Accumulation on the card: float for fp32/fp16/bf16 acc_dt, double for fp64
and int64 for integer and bool acc_dt.  Two cases take double instead,
where a narrower type would round twice or lose XLA's answer: `copy` (its
acc_dt is the target type: it converts in one step from the input), unless
both sides are integers (int64 then keeps every value), and `exp` of an
integer type (computed in float64 and saturated into the integer type, as
jnp.exp of an int64 array is).  The plain version computes the same
through torch.
"""

from __future__ import annotations

import torch

from ...core.dtype import cast, from_torch
from ...runtime import _kernels

OPS = ("add", "sub", "mul", "div", "copy", "neg", "abs", "exp")
_BINARY = ("add", "sub", "mul", "div")
_CODES = {name: i for i, name in enumerate(OPS)}


def _div(a, b):
    """a / b: true division for floats, C-truncating for integers with
    x / 0 = -1 and INT_MIN / -1 = INT_MIN (lax.div); torch raises on an
    integer zero divisor and leaves INT64_MIN / -1 undefined."""
    if a.is_floating_point():
        return a / b
    zero, minus_one = b == 0, b == -1
    safe = torch.where(zero | minus_one, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    q = torch.where(minus_one, -a, q)
    return torch.where(zero, torch.full_like(q, -1), q)


def _exp(x):
    return torch.exp(x if x.is_floating_point() else x.double())


FUNCS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": _div,
    "copy": lambda a: a,
    "neg": torch.neg,
    "abs": torch.abs,
    "exp": _exp,
}


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point


def _acc_kind(name, arrays, acc_dt, out_dt) -> int:
    """0 float, 1 double, 2 int64 (see the module docstring)."""
    if name == "copy":
        both_int = _is_int(arrays[0].dtype) and _is_int(out_dt)
        return 2 if both_int else 1
    if acc_dt in (torch.float32, torch.float16, torch.bfloat16):
        return 0
    if acc_dt == torch.float64 or name == "exp":
        return 1
    return 2


_TORCH_ACC = {0: torch.float32, 1: torch.float64, 2: torch.int64}


def _check(name, arrays, acc_dt, out_dt, out):
    if name not in OPS:
        raise ValueError(f"unknown elementwise op {name!r}; the kernel has {OPS}")
    want = 2 if name in _BINARY else 1
    if len(arrays) != want:
        raise ValueError(f"{name} takes {want} operands, got {len(arrays)}")
    shape = arrays[0].shape
    if any(a.shape != shape for a in arrays):
        raise ValueError(f"operands must share one shape (no broadcast), got "
                         f"{[tuple(a.shape) for a in arrays]}")
    if len({a.device for a in arrays}) != 1:
        raise ValueError("operands are on different devices")
    if out is not None and (out.numel() != arrays[0].numel()
                            or out.dtype != out_dt
                            or out.device != arrays[0].device):
        raise ValueError(f"out must hold {arrays[0].numel()} elements of "
                         f"{out_dt} on {arrays[0].device}")


def elementwise_plain(name, *arrays, acc_dt, out_dt):
    """Plain PyTorch version of the kernel: the same widening, math and
    store (see the module docstring)."""
    _check(name, arrays, acc_dt, out_dt, None)
    if name == "copy":
        return cast(arrays[0], out_dt).clone()
    acc = _TORCH_ACC[_acc_kind(name, arrays, acc_dt, out_dt)]
    r = FUNCS[name](*[cast(a, acc) for a in arrays])
    return cast(r, out_dt)


def elementwise(name, *arrays, acc_dt, out_dt, out=None):
    """Apply `name` elementwise over same-shape arrays; math in acc_dt,
    result in out_dt (torch dtypes).  Returns a fresh contiguous tensor,
    or writes `out` (a contiguous tensor of out_dt with the operands'
    numel, which may be an operand itself) and returns it.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `elementwise.launches`) or raise."""
    _check(name, arrays, acc_dt, out_dt, out)
    dev = arrays[0].device
    if dev.type == "cpu":
        r = elementwise_plain(name, *arrays, acc_dt=acc_dt, out_dt=out_dt)
        if out is None:
            return r
        out.copy_(r.reshape(out.shape))
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    kind = _acc_kind(name, arrays, acc_dt, out_dt)
    if out is None:
        out = torch.empty(arrays[0].shape, dtype=out_dt, device=dev)
    elif not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if out.numel() == 0:  # nothing to launch, and so nothing to count
        return out
    ops = [a.contiguous() for a in arrays]
    a = ops[0]
    b = ops[1] if len(ops) > 1 else ops[0]
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("elementwise", "kf_elementwise",
                           (i32, i32, vp, i32, vp, i32, vp, i32, _kernels.I64, vp))
    err = fn(_CODES[name], kind, a.data_ptr(), int(from_torch(a.dtype)),
             b.data_ptr(), int(from_torch(b.dtype)), out.data_ptr(),
             int(from_torch(out_dt)), a.numel(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"elementwise kernel launch failed: CUDA error {err}")
    elementwise.launches += 1
    return out


elementwise.launches = 0
