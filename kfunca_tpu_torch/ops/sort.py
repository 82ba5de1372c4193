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

KFUNCA_PALLAS_SORT=1 (read at dispatch time) selects the bitonic sort
kernel K10 (ops/pallas_kernels/bitonic_sort.py, csrc/bitonic_sort.cu)
wherever the JAX package would run its Pallas kernel (`_pallas_eligible`):
keys that are not Double, Long or Bool in rows that pad to at most 1024.
`_k10_sort` is the JAX package's `_pallas_sort_jit`: `dim` moved last in
dense rows, float keys widened to fp32 and integer keys to int32,
descending as a negated (float) or bit-inverted (int32) key, int64
indices; topk with k > 256 is a full K10 sort, then a narrow.  On CUDA
tensors the engine launches K10 or raises; on CPU tensors it runs K10's
plain version, as the port's other engine knobs do, so the CPU tests reach
the key transforms.  The values come back by gathering the input along the
sorted indices, so each keeps its own bits; the order (NaN last both ways,
-0.0 tied with 0.0) is the default engine's.  Bool keys are unsupported,
as in the reference.
"""

from __future__ import annotations

import os

import torch

from ..core.dtype import ScalarType
from ..core.iterator import check, maybe_wrap_dim
from ..core.tensor import Tensor
from ..runtime.launcher import Launcher
from .elementwise import wrap_array
from .pallas_kernels import bitonic_sort

TOP_K_MAX = 2048  # lax.top_k serves k up to this (ops/sort.py of the JAX package)

_INT_OF = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
           torch.float32: torch.int32, torch.float64: torch.int64}


def _pallas_eligible(t: Tensor, dim: int) -> bool:
    """Where the JAX package runs K10: the knob set, keys that are not
    64-bit or Bool, and rows that pad to at most DISPATCH_MAX_N."""
    if os.environ.get("KFUNCA_PALLAS_SORT", "0") != "1":
        return False
    if t.dtype() in (ScalarType.Double, ScalarType.Long, ScalarType.Bool):
        return False  # the JAX package keeps 64-bit keys on XLA
    return (bitonic_sort.padded_length(t.shape(dim))
            <= bitonic_sort.DISPATCH_MAX_N)


def _k10_sort(x, descending: bool):
    """(values, int64 indices) of a stable sort of x along its last dim
    through K10, with the JAX package's key transforms."""
    shape = x.shape
    if x.numel() == 0:
        return x.clone(), torch.zeros(shape, dtype=torch.int64, device=x.device)
    flat = x.reshape(-1, shape[-1])
    if flat.is_floating_point():
        keys = flat.to(torch.float32)
        keys = -keys if descending else keys
    else:
        keys = flat.to(torch.int32)
        keys = ~keys if descending else keys
    _, idx = bitonic_sort.bitonic_sort_pairs(keys.contiguous())
    idx = idx.to(torch.int64)
    return torch.gather(flat, -1, idx).reshape(shape), idx.reshape(shape)


def _ascending_key(x, descending: bool):
    """A key whose stable ascending sort is lax.sort's order of x: float
    keys negated for descending and made canonical (bitonic_sort.sort_key:
    every NaN positive, -0.0 equal to 0.0), integer keys bit-inverted."""
    if x.is_floating_point():
        return bitonic_sort.sort_key(-x if descending else x)
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
    engine = _k10_sort if _pallas_eligible(t, dim) else _stable_sort

    def run():
        x = t._array().movedim(dim, -1)
        vals, idx = engine(x, bool(descending))
        return vals.movedim(-1, dim), idx.movedim(-1, dim)

    vals, idx = Launcher.instance().submit(run, name="sort", device=t.torch_device())
    return wrap_array(vals, t.dtype()), wrap_array(idx, ScalarType.Long)


def topk(t: Tensor, k: int, dim: int, largest: bool):
    check(t.dtype() != ScalarType.Bool, "topk: Bool unsupported")
    dim = maybe_wrap_dim(dim, t.dim())
    k = int(k)
    check(0 < k <= t.shape(dim), "topk: invalid k")
    # reference semantics exactly: topk = full sort + narrow(k), on K10
    k10 = k > 256 and _pallas_eligible(t, dim)

    def run():
        x = t._array().movedim(dim, -1)
        if k10:
            vals, idx = _k10_sort(x, bool(largest))
            vals, idx = vals[..., :k], idx[..., :k]
        elif largest and k <= TOP_K_MAX and x.is_floating_point():
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
