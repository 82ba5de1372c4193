"""Data loading: tokenized-corpus batcher with background host prefetch.

Counterpart of kfunca_tpu/models/data.py.  TokenDataset is numpy with the
same seeded generators, so its batches are identical to the JAX package's:
(tokens, targets) int32 arrays of static shape, a flat token array (numpy
or np.memmap) as the corpus, and `batch_at(step)` stateless in the step
index, which the Trainer's exact resume relies on.

Prefetcher keeps the device from waiting on the host: a background thread
stages the next batches in pinned host memory and starts their copies to
the device with non_blocking=True (the JAX package's jax.device_put),
while the current step runs.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..runtime.backend import resolve_device


class TokenDataset:
    """Flat token array -> (batch, seq_len) next-token-prediction batches.

    `device` (default: the CUDA device; raises without one) is where
    Prefetcher puts the batches; the sampling itself is numpy."""

    def __init__(self, tokens, seq_len: int, batch_size: int, *, seed: int = 0,
                 device=None):
        self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 1:
            raise ValueError("TokenDataset expects a flat token array")
        if self.tokens.shape[0] < seq_len + 1:
            raise ValueError("corpus shorter than one sequence")
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def _windows(self, rng):
        starts = rng.integers(
            0, self.tokens.shape[0] - self.seq_len - 1, size=self.batch_size)
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None, :]
        window = self.tokens[idx].astype(np.int32)
        return window[:, :-1], window[:, 1:]

    def sample_batch(self):
        """Random contiguous windows (the standard LM pretraining sampler)."""
        return self._windows(self.rng)

    def batch_at(self, step: int):
        """Deterministic per-step batch: the generator is seeded from
        (seed, step), so checkpoint/resume reproduces the exact
        uninterrupted batch sequence with no generator state to save."""
        return self._windows(np.random.default_rng((self.seed, int(step))))

    def iter_from(self, step: int = 0):
        """Infinite deterministic iterator starting at `step`."""
        while True:
            yield self.batch_at(step)
            step += 1

    def __iter__(self):
        while True:
            yield self.sample_batch()


class Prefetcher:
    """Background-thread host staging + asynchronous copy to the device.

    next() returns (tokens, targets) int32 tensors on dataset.device."""

    def __init__(self, dataset: TokenDataset, depth: int = 2):
        self.dataset = dataset
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, array):
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.dataset.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.dataset.device, non_blocking=True)

    def _worker(self):
        for batch in self.dataset:
            if self._stop.is_set():
                return
            staged = tuple(self._stage(a) for a in batch)
            while not self._stop.is_set():
                try:
                    self.q.put(staged, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self.q.get()

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
