"""Launcher: device enumeration, selection, sync and profiling toggles.

Counterpart of kfunca_tpu/runtime/launcher.py and of the reference's
Launcher singleton (launcher_cuda.h).  Every eager op funnels through
`submit`, so the two modes observe all of them:

  * sync_mode: synchronize the card after each op (the reference's default
    behaviour, launcher_cuda.h:290; off by default here, as in the JAX
    package, because PyTorch's stream is asynchronous);
  * profiling_mode: time each op with a pair of torch.cuda.Events around
    it and record the elapsed time to the profiler, as the reference does
    (launcher_cuda.h:336-349).  On CPU tensors the host clock times it.
"""

from __future__ import annotations

import threading
import time

import torch


class Launcher:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._device_index = 0
        self.sync_mode = False
        self.profiling_mode = False

    @classmethod
    def instance(cls) -> "Launcher":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # -- devices -----------------------------------------------------------

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def device(self, index: int | None = None) -> torch.device:
        i = self._device_index if index is None else index
        n = self.device_count()
        if not 0 <= i < n:
            raise IndexError(f"device {i} out of range ({n} devices)")
        return torch.device("cuda", i)

    def set_device(self, index: int) -> None:
        self.device(index)  # validate
        self._device_index = index
        torch.cuda.set_device(index)

    def current_device(self) -> int:
        return self._device_index

    def device_properties(self, index: int = 0) -> dict:
        p = torch.cuda.get_device_properties(self.device(index))
        return {
            "platform": "gpu",
            "device_kind": p.name,
            "id": index,
            "bytes_limit": p.total_memory,
            "bytes_in_use": torch.cuda.memory_allocated(index),
            "multi_processor_count": p.multi_processor_count,
        }

    # -- launches ----------------------------------------------------------

    def submit(self, fn, *args, name: str | None = None, device=None):
        """Run `fn(*args)` under the current sync/profiling policy.
        `device` is the torch.device the op runs on."""
        cuda = device is not None and torch.device(device).type == "cuda"
        if self.profiling_mode:
            from ..utils.profiling import PROFILER

            label = name or getattr(fn, "__name__", "launch")
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                end.synchronize()
                PROFILER.record(label, start.elapsed_time(end) * 1e-3)
            else:
                t0 = time.perf_counter()
                out = fn(*args)
                PROFILER.record(label, time.perf_counter() - t0)
            return out
        out = fn(*args)
        if self.sync_mode and cuda:
            torch.cuda.synchronize(device)
        return out

    def set_sync_mode(self, value: bool) -> None:
        self.sync_mode = bool(value)

    def set_profiling_mode(self, value: bool) -> None:
        self.profiling_mode = bool(value)
        from ..utils.profiling import PROFILER

        PROFILER.enabled = bool(value)
