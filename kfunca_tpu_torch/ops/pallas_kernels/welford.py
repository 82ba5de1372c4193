"""Welford statistics K7: (R, C) fp32 -> (mean (1, C), invstd (1, C)).

Counterpart of kfunca_tpu/ops/pallas_kernels/welford.py.  On CUDA tensors
`welford_norm_stat` launches the hand-written kernel in csrc/reduce.cu
(counted in `welford_norm_stat.launches`); on CPU tensors it runs
`welford_norm_stat_plain`.  There is no fallback between the two.

Contract (both routes, the TPU kernel's): per-column mean and
invstd = 1 / sqrt(m2 / R + 1e-12) with the biased variance m2 / R, in fp32.
The TPU kernel reduces the floor-aligned rows and merges the ragged tail
in XLA; the card's kernel reduces every row itself (per-thread Welford
updates merged by Chan's formula), so the two agree to fp32 rounding, not
bit for bit.  The plain version is the two-pass formula.
"""

from __future__ import annotations

import torch

from ...runtime import _kernels

EPS = 1e-12


def _check(x):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"expected a 2-D float32 (R, C) matrix, got "
                        f"{x.dtype} {tuple(x.shape)}")


def welford_norm_stat_plain(x):
    """Plain PyTorch version: two-pass mean and biased variance in fp32."""
    _check(x)
    mean = x.mean(dim=0, keepdim=True)
    var = ((x - mean) * (x - mean)).mean(dim=0, keepdim=True)
    return mean, 1.0 / torch.sqrt(var + EPS)


def welford_norm_stat(x):
    """(mean, invstd) of each column of x over its rows.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `welford_norm_stat.launches`) or raise."""
    _check(x)
    if x.device.type == "cpu":
        return welford_norm_stat_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"the kernel needs R > 0 and C > 0, got {tuple(x.shape)}")
    x = x.contiguous()
    mean = torch.empty((1, cols), dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("reduce", "kf_welford_norm_stat",
                           (vp, vp, vp, i32, i32, vp))
    err = fn(x.data_ptr(), mean.data_ptr(), invstd.data_ptr(), rows, cols,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"welford kernel launch failed: CUDA error {err}")
    welford_norm_stat.launches += 1
    return mean, invstd


welford_norm_stat.launches = 0
