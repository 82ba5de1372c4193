"""Column reduction K8: (R, C) -> (1, C) sum / mean / max.

Counterpart of kfunca_tpu/ops/pallas_kernels/reduce.py.  On CUDA tensors
`reduce_2d` launches the hand-written kernel in csrc/reduce.cu (counted in
`reduce_2d.launches`); on CPU tensors it runs `reduce_2d_plain`.  There is
no fallback between the two.

Contract (both routes, the TPU kernel's): fp32 accumulation of an fp32,
bf16 or fp16 matrix over its rows; mean multiplies the sum by
float32(1 / R); max starts from -3.4e38 and propagates NaN; the result is
stored in `out_dt` (fp32, bf16 or fp16; default the input's).  The caller
moves the reduced axis to the front and flattens the rest.  Sums are taken
in another order than the plain version's, so they agree to fp32 rounding,
not bit for bit; the kernel repeats bit for bit from run to run.
"""

from __future__ import annotations


import numpy as np
import torch

from ...core.dtype import from_torch
from ...runtime import _kernels

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_OPS = {"sum": 0, "mean": 1, "max": 2}
MAX_INIT = -3.4e38


def _check(x, op, out_dt):
    if op not in _OPS:
        raise ValueError(f"op must be one of {tuple(_OPS)}, got {op!r}")
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D (R, C) matrix, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES or out_dt not in _DTYPES:
        raise TypeError(f"the kernel takes and returns float32, bfloat16 or "
                        f"float16; got {x.dtype} -> {out_dt}")


def _mean_scale(rows: int) -> float:
    return float(np.float32(1.0 / rows))


def reduce_2d_plain(x, op="sum", out_dt=None):
    """Plain PyTorch version of the kernel (same contract)."""
    out_dt = out_dt or x.dtype
    _check(x, op, out_dt)
    xf = x.float()
    if op == "max":
        r = torch.maximum(xf.amax(dim=0, keepdim=True),
                          torch.tensor(MAX_INIT, device=x.device))
    else:
        r = xf.sum(dim=0, keepdim=True)
        if op == "mean":
            r = r * _mean_scale(x.shape[0])
    return r.to(out_dt)


def reduce_2d(x, op="sum", out_dt=None):
    """(R, C) -> (1, C) over dim 0 with fp32 accumulation.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `reduce_2d.launches`) or raise."""
    out_dt = out_dt or x.dtype
    _check(x, op, out_dt)
    if x.device.type == "cpu":
        return reduce_2d_plain(x, op, out_dt)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"the kernel needs R > 0 and C > 0, got {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty((1, cols), dtype=out_dt, device=x.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("reduce", "kf_reduce_2d",
                           (vp, i32, vp, i32, i32, i32, i32, _kernels.F32, vp))
    err = fn(x.data_ptr(), int(from_torch(x.dtype)), out.data_ptr(),
             int(from_torch(out_dt)), rows, cols, _OPS[op],
             _mean_scale(rows), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"reduce kernel launch failed: CUDA error {err}")
    reduce_2d.launches += 1
    return out


reduce_2d.launches = 0
