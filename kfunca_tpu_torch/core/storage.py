"""Typed device storage over a flat torch tensor.

Counterpart of kfunca_tpu/core/storage.py (the reference's TensorStorage,
tensor_impl.h:62-92): a span of device memory that views read and write.
Here the span is a flat 1-D torch tensor on an explicit device, and every
write goes INTO that tensor, so a storage's address never changes and
every view of it sees every write.  PyTorch's caching allocator owns the
memory; runtime/allocator.py reads its statistics.

Devices.  A kfunca device is a CUDA index (an int, default 0) or "cpu".
An index resolves to the card through runtime/backend.resolve_device,
which raises when there is no card: the CPU runs only when asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.backend import resolve_device
from .dtype import ScalarType, to_torch


def torch_device(device) -> torch.device:
    """The torch.device of a kfunca device (CUDA index or "cpu")."""
    if isinstance(device, torch.device):
        dev = device
    elif isinstance(device, str):
        dev = torch.device(device)
    elif isinstance(device, (int, np.integer)):
        dev = torch.device("cuda", int(device))
    else:
        raise ValueError(f"unsupported device {device!r}; expected a CUDA "
                         "index or 'cpu'")
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise IndexError(f"device index {dev.index} out of range "
                         f"({torch.cuda.device_count()} devices)")
    return dev


def device_key(dev: torch.device):
    """The kfunca name of a torch.device: its CUDA index, or "cpu"."""
    return "cpu" if dev.type == "cpu" else dev.index


class Storage:
    __slots__ = ("numel", "dtype", "device", "data", "__weakref__")

    def __init__(self, numel: int, dtype: ScalarType, device=0, data=None,
                 zero: bool = False):
        """`data`, when given, is ADOPTED as the storage's memory (a 1-D
        tensor of `numel` elements in `dtype`, which no other storage
        holds).  Otherwise fresh memory: uninitialized, as the reference's
        cudaMalloc, or zeros with `zero`."""
        dev = data.device if data is not None else torch_device(device)
        self.numel = int(numel)
        self.dtype = dtype
        self.device = device_key(dev)
        if data is None:
            make = torch.zeros if zero else torch.empty
            data = make(self.numel, dtype=to_torch(dtype), device=dev)
        assert data.dim() == 1 and data.numel() == self.numel, (
            data.shape, self.numel)
        assert data.dtype == to_torch(dtype), (data.dtype, dtype)
        self.data = data

    @property
    def torch_device(self) -> torch.device:
        return self.data.device

    @property
    def base_ptr(self) -> int:
        return self.data.data_ptr()
