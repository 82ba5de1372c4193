"""Stable segmented sort + topk.

Counterpart of kfunca_tpu/ops/sort.py.  The JAX package's default engine is
XLA's variadic lax.sort; the port's is torch.sort(stable=True), the vendor
sort, with the JAX package's contract and its orders where torch's differ:

  * stable ascending/descending per segment (every slice along `dim`),
    int64 indices;
  * descending is stable-ascending over an order-reversing key (float
    negate / int bitwise NOT on int64), so equal keys keep their order;
    NaN sorts LAST both ways (lax.sort's canonical NaN is greatest, and a
    negated NaN is still NaN; torch.sort(descending=True) would put NaN
    first, and torch's CUDA sort puts a negative NaN first even
    ascending); -0.0 and 0.0 tie;
  * topk = stable sort + narrow(k), except where the JAX package calls
    lax.top_k (largest, float keys, k <= 2048): there the order is the
    float total order by bits, +NaN > +inf > ... > +0 > -0 > ... > -NaN,
    ties in index order, which the port reproduces with a stable sort of
    the bits mapped to ordered integers (torch.topk promises no order for
    ties).

KFUNCA_PALLAS_SORT=1 selects the JAX package's bitonic kernel (K10), which
is not ported yet: on CUDA tensors where the JAX package would run it, the
port raises NotImplementedError; CPU tensors take the default engine, as
the JAX package does off the TPU.  Bool keys are unsupported, as in the
reference.
"""

from __future__ import annotations

import os

import torch

from ..core.dtype import ScalarType
from ..core.iterator import check, maybe_wrap_dim
from ..core.tensor import Tensor
from ..runtime.launcher import Launcher
from .elementwise import wrap_array

TOP_K_MAX = 2048  # lax.top_k serves k up to this (ops/sort.py of the JAX package)
K10_DISPATCH_MAX_N = 1024  # the bitonic dispatcher's padded row limit (bitonic_sort.py:45)

_INT_OF = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
           torch.float32: torch.int32, torch.float64: torch.int64}


def _check_k10(t: Tensor, dim: int) -> None:
    """Raise where the JAX package would run its Pallas sort (K10)."""
    if os.environ.get("KFUNCA_PALLAS_SORT", "0") != "1":
        return
    if t.torch_device().type != "cuda":
        return
    if t.dtype() in (ScalarType.Double, ScalarType.Long, ScalarType.Bool):
        return  # the JAX package keeps 64-bit keys on XLA
    n = max(t.shape(dim), 128)
    if 1 << (n - 1).bit_length() <= K10_DISPATCH_MAX_N:
        raise NotImplementedError(
            "KFUNCA_PALLAS_SORT=1 selects the bitonic sort kernel K10 "
            "(kfunca_tpu/ops/pallas_kernels/bitonic_sort.py:89), which the "
            "port has not ported yet; unset it to use the default sort")


def _ascending_key(x, descending: bool):
    """A key whose stable ascending sort is lax.sort's order of x.  Float
    keys are made canonical: every NaN positive (greatest) and -0.0 equal
    to 0.0 (+ 0.0 turns -0.0 into 0.0), since torch's CUDA sort orders by
    the bits and would put a negative NaN first and -0.0 below 0.0."""
    if x.is_floating_point():
        k = (-x if descending else x) + 0.0
        return torch.where(torch.isnan(k), torch.full_like(k, float("nan")), k)
    return ~x.to(torch.int64) if descending else x


def _stable_sort(x, descending: bool):
    """(values, int64 indices) of a stable sort along the last dim."""
    _, idx = torch.sort(_ascending_key(x, descending), dim=-1, stable=True)
    return torch.gather(x, -1, idx), idx


def _total_order_key(x):
    """Integers ordered as the float total order of x's bits (lax.top_k)."""
    bits = x.contiguous().view(_INT_OF[x.dtype])
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def sort(t: Tensor, dim: int, descending: bool):
    check(t.dtype() != ScalarType.Bool, "sort: Bool unsupported")
    dim = maybe_wrap_dim(dim, t.dim())
    _check_k10(t, dim)

    def run():
        x = t._array().movedim(dim, -1)
        vals, idx = _stable_sort(x, bool(descending))
        return vals.movedim(-1, dim), idx.movedim(-1, dim)

    vals, idx = Launcher.instance().submit(run, name="sort", device=t.torch_device())
    return wrap_array(vals, t.dtype()), wrap_array(idx, ScalarType.Long)


def topk(t: Tensor, k: int, dim: int, largest: bool):
    check(t.dtype() != ScalarType.Bool, "topk: Bool unsupported")
    dim = maybe_wrap_dim(dim, t.dim())
    k = int(k)
    check(0 < k <= t.shape(dim), "topk: invalid k")
    if k > 256:
        _check_k10(t, dim)

    def run():
        x = t._array().movedim(dim, -1)
        if largest and k <= TOP_K_MAX and x.is_floating_point():
            _, idx = torch.sort(_total_order_key(x), dim=-1, descending=True,
                                stable=True)
            idx = idx[..., :k]
            vals = torch.gather(x, -1, idx)
        else:
            vals, idx = _stable_sort(x, bool(largest))
            vals, idx = vals[..., :k], idx[..., :k]
        return vals.movedim(-1, dim), idx.movedim(-1, dim)

    vals, idx = Launcher.instance().submit(run, name="topk", device=t.torch_device())
    return wrap_array(vals, t.dtype()), wrap_array(idx, ScalarType.Long)
