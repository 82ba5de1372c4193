"""Tiled GEMM K3 with a fused epilogue: (m, k) @ (k, n).

Counterpart of kfunca_tpu/ops/pallas_kernels/matmul.py.  On CUDA tensors
`matmul` launches the hand-written kernel in csrc/matmul.cu (counted in
`matmul.launches`); on CPU tensors it runs `matmul_plain`.  There is no
fallback between the two.

Contract (both routes, the TPU kernel's): fp32 / bf16 / fp16 inputs sum in
fp32 (fp32 at full precision, no TF32), int8 inputs in exact int32; the
epilogue runs on the accumulator in fp32, in this order: + bias (n,), one
of tanh-GELU / SiLU / ReLU, + residual (m, n); then the store in
`out_dtype` (default: the input dtype, int32 for int8).  `epilogue` names
its parts as the TPU kernel does ("bias", "bias_gelu", "silu", "bias_res",
...).  The TPU kernel's block sizes (`bm`, `bn`, `bk`, `vmem_limit`) are
VMEM choices and are not taken.

Layout: the kernel reads row-major a and b.  A transposed view (the gemm
backward's a^T and b^T) is copied to row-major first, and bias / residual
are handed over in fp32; `.contiguous()` and `.float()` are plain torch.
"""

from __future__ import annotations

import torch

from ...core.dtype import cast, from_torch
from ...runtime import _kernels

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_OUT = (torch.float32, torch.bfloat16, torch.float16, torch.int32)
_ACTS = {"gelu": 1, "silu": 2, "relu": 3}
# |acc| <= k * 128 * 128 must fit an int32
MAX_K_INT8 = (2 ** 31 - 1) // (128 * 128)


def _act(epilogue: str) -> int:
    for name, code in _ACTS.items():
        if name in epilogue:
            return code
    return 0


def _check(a, b, bias, residual, out_dtype, epilogue):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (m, k) @ (k, n), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _FLOATS + (torch.int8,):
        raise TypeError(f"a and b must share one of float32, bfloat16, "
                        f"float16, int8; got {a.dtype} and {b.dtype}")
    if out_dtype not in _OUT:
        raise TypeError(f"out_dtype must be one of {_OUT}, got {out_dtype}")
    if ("bias" in epilogue) != (bias is not None):
        raise ValueError(f"epilogue {epilogue!r} and bias disagree")
    if ("res" in epilogue) != (residual is not None):
        raise ValueError(f"epilogue {epilogue!r} and residual disagree")
    m, n = a.shape[0], b.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual must be ({m}, {n}), got {tuple(residual.shape)}")
    tensors = [t for t in (a, b, bias, residual) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("tensors on different devices")
    if a.dtype == torch.int8 and a.shape[1] > MAX_K_INT8:
        raise ValueError(f"k = {a.shape[1]} can overflow the int32 accumulator "
                         f"(limit {MAX_K_INT8})")


def _default_out(a) -> torch.dtype:
    return torch.int32 if a.dtype == torch.int8 else a.dtype


def apply_epilogue_plain(acc, epilogue, bias=None, residual=None):
    """The epilogue on an fp32 accumulator, in the kernel's order."""
    if bias is not None:
        acc = acc + bias.float()[None, :]
    act = _act(epilogue)
    if act == 1:
        acc = torch.nn.functional.gelu(acc, approximate="tanh")
    elif act == 2:
        acc = acc * torch.sigmoid(acc)
    elif act == 3:
        acc = torch.clamp_min(acc, 0.0)
    if residual is not None:
        acc = acc + residual.float()
    return acc


def matmul_plain(a, b, bias=None, residual=None, out_dtype=None, epilogue=""):
    """Plain PyTorch version of the kernel (same contract).  Float inputs
    are widened to fp32, whose products of 16-bit values are exact; int8
    sums exactly in int64 on the CPU and in float64 on the card (torch has
    no integer matmul there; |acc| < 2^53 keeps it exact)."""
    out_dtype = out_dtype or _default_out(a)
    _check(a, b, bias, residual, out_dtype, epilogue)
    if a.dtype == torch.int8:
        wide = torch.int64 if a.device.type == "cpu" else torch.float64
        acc = (a.to(wide) @ b.to(wide))
        if not epilogue:  # the exact int32, or its float rounding
            return acc.to(out_dtype) if out_dtype == torch.int32 \
                else acc.float().to(out_dtype)
        acc = acc.float()
    else:
        acc = a.float() @ b.float()
    if epilogue:
        acc = apply_epilogue_plain(acc, epilogue, bias, residual)
    return cast(acc, out_dtype)


def matmul(a, b, bias=None, residual=None, out_dtype=None, epilogue=""):
    """(m, k) @ (k, n) -> (m, n) with the fused epilogue.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `matmul.launches`) or raise.  Any m, k, n: the kernel masks
    ragged edges itself."""
    out_dtype = out_dtype or _default_out(a)
    _check(a, b, bias, residual, out_dtype, epilogue)
    if a.device.type == "cpu":
        return matmul_plain(a, b, bias, residual, out_dtype, epilogue)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"the kernel needs m, k, n > 0, got ({m}, {k}, {n})")
    a, b = a.contiguous(), b.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    residual = None if residual is None else residual.float().contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("matmul", "kf_matmul", (vp,) * 5 + (i32,) * 6 + (vp,))
    err = fn(a.data_ptr(), b.data_ptr(),
             None if bias is None else bias.data_ptr(),
             None if residual is None else residual.data_ptr(), out.data_ptr(),
             int(from_torch(a.dtype)), int(from_torch(out_dtype)), m, k, n,
             _act(epilogue), torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    matmul.launches += 1
    return out


matmul.launches = 0
