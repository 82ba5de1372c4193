"""Stable per-row sort of (key, index) pairs (K10).

Counterpart of kfunca_tpu/ops/pallas_kernels/bitonic_sort.py
(`bitonic_sort_pairs`).  On CUDA tensors `bitonic_sort_pairs` launches the
hand-written Hopper kernel in csrc/bitonic_sort.cu (counted in
`bitonic_sort_pairs.launches`); on CPU tensors it runs
`bitonic_sort_pairs_plain`.  There is no fallback between the two.

Contract (both routes): keys (rows, n) fp32 or int32, n <= MAX_N ->
(the keys of each row in ascending order, their int32 positions in the
row), ordered by (key, index): the stable order.  Rows of any length are
taken; the kernel pads each to a power of two >= 128 with cells that sort
after every real cell, whatever its key, and drops them.

The kernel runs a bitonic network over 64-bit (ordered key, index) words,
8 consecutive words of a row in each thread's registers: pairs closer
than 8 are exchanged within a thread, pairs up to 255 apart by warp
shuffles, farther ones through shared memory (3 of the 55 passes of a row
of 1024).  It needs no workspace.

One departure from the TPU kernel, by design: the TPU network compares
with `>` and `<`, so a row that holds NaN comes back in no defined order.
Here every NaN sorts after every number, ties by index, which is the port's
default sort order (ops/sort.py); -0.0 and 0.0 tie, as `==` gives on both.
The keys come back with their own bits (a NaN's payload, a zero's sign).
"""

from __future__ import annotations

import torch

from ...runtime import _kernels

MAX_N = 8192  # the kernel's row limit (one block of 1024 threads, 8 words each)
WORDS_PER_THREAD = 8  # csrc/bitonic_sort.cu kE: words a thread holds in registers
DISPATCH_MAX_N = 1024  # the largest padded row ops/sort.py sends it
MIN_PAD = 128  # rows pad to a power of two at least this
_DTYPES = (torch.float32, torch.int32)


def padded_length(n: int) -> int:
    """The power of two a row of n pads to in the kernel."""
    return 1 << (max(n, MIN_PAD) - 1).bit_length()


def _check(keys):
    if keys.dim() != 2:
        raise ValueError(f"expected (rows, n) keys, got {tuple(keys.shape)}")
    if keys.dtype not in _DTYPES:
        raise TypeError(f"the sort kernel takes float32 or int32 keys, got "
                        f"{keys.dtype}")
    if keys.shape[1] > MAX_N:
        raise ValueError(f"rows of {keys.shape[1]} exceed the kernel's "
                         f"{MAX_N}")


def sort_key(keys):
    """A key whose stable ascending torch.sort is the contract's order:
    NaN made one positive NaN (torch's CUDA sort orders by the bits and
    would put a negative NaN first), -0.0 made 0.0 (+ 0.0 does it)."""
    if not keys.is_floating_point():
        return keys
    k = keys + 0.0
    return torch.where(torch.isnan(k), torch.full_like(k, float("nan")), k)


def bitonic_sort_pairs_plain(keys):
    """Plain PyTorch version of the kernel (same contract): a stable sort."""
    _check(keys)
    _, idx = torch.sort(sort_key(keys), dim=-1, stable=True)
    return torch.gather(keys, -1, idx), idx.to(torch.int32)


def bitonic_sort_pairs(keys):
    """(sorted keys, int32 indices) of each row, stable ascending.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in `bitonic_sort_pairs.launches`) or raise."""
    _check(keys)
    if keys.device.type == "cpu":
        return bitonic_sort_pairs_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    rows, n = keys.shape
    if rows == 0 or n == 0:
        raise ValueError(f"the kernel needs rows > 0 and n > 0, got "
                         f"{tuple(keys.shape)}")
    keys = keys.contiguous()
    out = torch.empty_like(keys)
    idx = torch.empty((rows, n), dtype=torch.int32, device=keys.device)
    vp, i32 = _kernels.VP, _kernels.I32
    fn = _kernels.function("bitonic_sort", "kf_bitonic_sort_pairs",
                           (vp, vp, vp, _kernels.I64, i32, i32, vp))
    err = fn(keys.data_ptr(), out.data_ptr(), idx.data_ptr(), rows, n,
             int(keys.dtype == torch.float32),
             torch.cuda.current_stream(keys.device).cuda_stream)
    if err:
        raise RuntimeError(f"sort kernel launch failed: CUDA error {err}")
    bitonic_sort_pairs.launches += 1
    return out, idx


bitonic_sort_pairs.launches = 0
