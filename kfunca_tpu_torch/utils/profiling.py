"""Profiling / tracing utilities (counterpart of kfunca_tpu/utils/profiling.py).

  * time_fn()        — device time of a callable on the card: CUDA events
                       around each call after a synchronize, min over runs;
                       on the CPU, the host clock.
  * profiling_mode() — context manager mirroring set_profiling_mode(true):
                       the Launcher records every eager op's time here.
  * trace()          — a torch.profiler trace of the CPU and the card,
                       exported as a Chrome trace (the JAX package's
                       jax.profiler trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return False


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Best-of-`iters` time of fn(*args) in seconds: CUDA events when the
    result lives on the card, the host clock otherwise."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    cuda = _on_cuda(out) or _on_cuda(args)
    best = float("inf")
    for _ in range(iters):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best


@dataclass
class ProfileRecord:
    name: str
    seconds: float


@dataclass
class Profiler:
    enabled: bool = False
    records: list = field(default_factory=list)

    def record(self, name: str, seconds: float) -> None:
        if self.enabled:
            self.records.append(ProfileRecord(name, seconds))

    def summary(self) -> str:
        lines = ["=== kfunca_tpu_torch profile ==="]
        for r in self.records:
            lines.append(f"{r.name:40s} {r.seconds * 1e3:10.3f} ms")
        return "\n".join(lines)


PROFILER = Profiler()


@contextlib.contextmanager
def profiling_mode():
    """Enable per-op timing collection (Launcher set_profiling_mode analog)."""
    from ..runtime.launcher import Launcher

    launcher = Launcher.instance()
    prev = launcher.profiling_mode
    launcher.set_profiling_mode(True)
    try:
        yield PROFILER
    finally:
        launcher.set_profiling_mode(prev)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU and, where present, the
    card) and write `trace.json` (Chrome trace format) into logdir."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
