"""Welford statistics K7: (R, C) fp32 -> (mean (1, C), invstd (1, C)).

Counterpart of kfunca_tpu/ops/pallas_kernels/welford.py.  On CUDA tensors
`welford_norm_stat` launches the hand-written kernel in csrc/reduce.cu
(counted in `welford_norm_stat.launches`); on CPU tensors it runs
`welford_norm_stat_plain`.  There is no fallback between the two.

Contract (both routes, the TPU kernel's): per-column mean and
invstd = 1 / sqrt(m2 / R + 1e-12) with the biased variance m2 / R, in fp32.
The TPU kernel reduces the floor-aligned rows and merges the ragged tail
in XLA; the card's kernel reduces every row itself, so the two agree to
fp32 rounding, not bit for bit.  The plain version is the two-pass formula.

The card's kernel is a split-row reduction in two launches (counted as one
call): the rows are cut into `split_count(R, C, target=...)` splits of
ceil(R / S) rows (from the shape and the target alone, so the result
repeats bit for bit; the target is `split_target`'s: the caller's, or the
one runtime/autotune.py recorded for the shape class, or TARGET_BLOCKS);
a block of 256
threads takes 256 columns of one split, each thread folding chunks of 16
rows (the chunk's mean and M2 taken in registers, relative to its running
mean) into its (count, mean, M2) by Chan's formula; the splits' partials go
to a workspace of 2 x S x C fp32 that this wrapper allocates, and a second
kernel merges each column's partials in a fixed order.
"""

from __future__ import annotations

import torch

from ...runtime import _kernels

EPS = 1e-12
SPLIT_COLS = 256  # threads of a split block, one a column (reduce.cu kSplitThreads)
CHUNK = 16  # rows a thread loads before it uses them (reduce.cu kChunk)
TARGET_BLOCKS = 4 * 132 * 8  # about four waves of 8 blocks on each of 132 SMs


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


def split_count(rows: int, cols: int, block_cols: int = SPLIT_COLS,
                target: int = TARGET_BLOCKS) -> int:
    """S, the row splits of a split-row kernel (K7's, and K8's whose blocks
    own `block_cols` columns each), from the shape and `target` alone:
    enough blocks for `target` (the launch parameter runtime/autotune.py
    sweeps as "welford" and "reduce"), and no more splits than chunks of
    CHUNK rows."""
    if int(target) < 1:
        raise ValueError(f"split_count takes target >= 1, got {target}")
    strips = -(-cols // block_cols)
    return max(1, min(-(-int(target) // strips), -(-rows // CHUNK)))


def split_target(op: str, shape, target_blocks=None) -> int:
    """The blocks split_count aims at for `op` ("welford" for K7,
    "reduce" for K8) over an (R, C) matrix: `target_blocks` where given,
    else the winner `kfunca.autotune(op, R, C)` recorded for the shape
    class (keyed float32, as the JAX package's), else TARGET_BLOCKS."""
    if target_blocks is None:
        from ...runtime import autotune

        target_blocks = autotune.tuned(op, tuple(shape), torch.float32).get(
            "target_blocks", TARGET_BLOCKS)
    if int(target_blocks) < 1:
        raise ValueError(f"split_count takes target >= 1, got "
                         f"{target_blocks}")
    return int(target_blocks)


def welford_norm_stat(x, target_blocks=None):
    """(mean, invstd) of each column of x over its rows.  `target_blocks`:
    the blocks split_count aims at, by default `split_target`'s (a target
    changes the order of the fp32 sums, so results agree across targets
    within rounding).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `welford_norm_stat.launches`) or raise.  An empty matrix
    launches nothing and counts nothing."""
    _check(x)
    target = split_target("welford", x.shape, target_blocks)
    if x.device.type == "cpu":
        return welford_norm_stat_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        # the reference's answers (its XLA path, no kernel): NaN mean and
        # invstd of (1, C) for no rows, (1, 0) outputs for no columns
        mean = torch.full((1, cols), float("nan"), device=x.device)
        return mean, mean.clone()
    splits = split_count(rows, cols, target=target)
    x = x.contiguous()
    mean = torch.empty((1, cols), dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    ws = torch.empty((2, splits, cols), dtype=torch.float32, device=x.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("reduce", "kf_welford_norm_stat",
                           (vp, vp, vp, vp, i32, i32, i32, vp))
    err = fn(x.data_ptr(), mean.data_ptr(), invstd.data_ptr(), ws.data_ptr(),
             rows, cols, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"welford kernel launch failed: CUDA error {err}")
    welford_norm_stat.launches += 1
    return mean, invstd


welford_norm_stat.launches = 0
