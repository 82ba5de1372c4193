"""index_put_: scatter values at int64 coordinate tensors.

Counterpart of kfunca_tpu/ops/index.py (the reference's index_ops.cpp:6-38
and tensor_index.h:56-104).  Linear storage addresses are computed from
the view's strides and the values are scattered into the storage tensor in
place, so every view of the storage sees the write and data_ptr() stays.

Semantics (torch-compatible, as exercised by test_tensor.py): index tensors
broadcast together and address the first len(indices) dims; any remaining
dims are written as whole slices; values broadcast to the result shape;
negative indices wrap.
"""

from __future__ import annotations

import torch

from ..core.dtype import ScalarType, cast
from ..core.iterator import check
from ..core.tensor import Tensor
from ..runtime.launcher import Launcher


def index_put_(self: Tensor, indices, values: Tensor) -> Tensor:
    check(len(indices) <= self.dim(), "index_put_: too many index tensors")
    for i in indices:
        check(i.dtype() == ScalarType.Long, "index_put_: indices must be int64")
        check(i.device() == self.device(), "index_put_: device mismatch")
    check(values.device() == self.device(), "index_put_: device mismatch")
    impl = self.impl()
    data = impl.storage.data
    shape, strides = impl.shape, impl.strides

    def run():
        idx = [i._array() for i in indices]
        bshape = torch.broadcast_shapes(*[i.shape for i in idx]) if idx else ()
        lin = torch.full(bshape, impl.offset, dtype=torch.int64, device=data.device)
        for d, ix in enumerate(idx):
            ix = torch.where(ix < 0, ix + shape[d], ix)  # negative-index wrap
            lin = lin + ix.expand(bshape) * strides[d]
        rest = shape[len(idx):]
        if rest:
            lin = lin.reshape(tuple(bshape) + (1,) * len(rest))
            for j, n in enumerate(rest):
                view = [1] * (len(bshape) + len(rest))
                view[len(bshape) + j] = n
                step = torch.arange(n, device=data.device).reshape(view)
                lin = lin + step * strides[len(idx) + j]
        target = tuple(bshape) + tuple(rest)
        vals = cast(values._array(), data.dtype).expand(target)
        data.index_put_((lin.expand(target).reshape(-1),), vals.reshape(-1))

    Launcher.instance().submit(run, name="index_put_", device=self.torch_device())
    return self
