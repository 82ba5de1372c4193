"""Comparison helpers (counterpart of kfunca_tpu/utils/compare.py; the
reference's utils/compare.h:1-74 CompareMaxdiff/all_close).

Host-side oracles for tests and debugging: max-abs-diff and allclose over
kfunca tensors, torch tensors or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x):
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().cpu().numpy()
    if hasattr(x, "contiguous"):  # kfunca_tpu_torch Tensor
        return x.contiguous().numpy()
    return np.asarray(x)


def max_diff(a, b) -> float:
    a, b = _to_numpy(a).astype(np.float64), _to_numpy(b).astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)))


def all_close(a, b, atol: float = 1e-3, rtol: float = 1e-3) -> bool:
    return bool(np.allclose(_to_numpy(a), _to_numpy(b), atol=atol, rtol=rtol))
