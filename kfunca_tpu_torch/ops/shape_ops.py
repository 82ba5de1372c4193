"""Shape ops: concat (tensor_split lives on Tensor.split).

Counterpart of kfunca_tpu/ops/shape_ops.py.  The reference implements
concat as alloc + narrow + copy_ per input (tensor_shape.cpp:41-70); here it
is one torch.cat over the inputs' views.  Output dtype follows the first
input, with copy_-style casting of the rest.
"""

from __future__ import annotations

import torch

from ..core.dtype import cast, to_torch
from ..core.iterator import check, maybe_wrap_dim
from ..core.tensor import Tensor
from ..runtime.launcher import Launcher
from .elementwise import wrap_array


def concat(tensors, dim: int) -> Tensor:
    check(len(tensors) >= 1, "cat: need at least one tensor")
    first = tensors[0]
    dim = maybe_wrap_dim(dim, first.dim())
    for t in tensors:
        check(t.dim() == first.dim(), "cat: rank mismatch")
        check(t.device() == first.device(), "cat: device mismatch")
        for d in range(first.dim()):
            if d != dim:
                check(t.shape(d) == first.shape(d), "cat: shape mismatch off-dim")
    dt = to_torch(first.dtype())

    def run():
        return torch.cat([cast(t._array(), dt) for t in tensors], dim=dim)

    r = Launcher.instance().submit(run, name="cat", device=first.torch_device())
    return wrap_array(r, first.dtype())
