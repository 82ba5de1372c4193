"""Carry transformer parameters between the JAX package and the port.

Both packages use one parameter layout (see models/transformer.py), so a
JAX params pytree maps leaf for leaf onto the port's dict of tensors.  The
conversion goes through numpy: the port never imports JAX, and a caller
holding JAX arrays passes them as they are (each leaf goes through
np.asarray) or as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.backend import resolve_device
from .transformer import TransformerConfig, _check_supported


def _to_tensor(leaf, device, dtype):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # own, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, cfg: TransformerConfig, device=None, dtype=None):
    """JAX params pytree (dicts and lists of arrays) -> the port's params on
    `device` (default: the CUDA device).  `dtype` recasts every float leaf
    (None keeps each leaf's dtype).  Checks the tree against `cfg`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['blocks'])} blocks for a config of "
                         f"{cfg.n_layers} layers")
    if tuple(np.shape(tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {np.shape(tree['embed'])} does not match "
                         f"the config")
    for blk in tree["blocks"]:
        if tuple(np.shape(blk["wqkv"])) != (cfg.d_model, cfg.qkv_out):
            raise ValueError(f"wqkv {np.shape(blk['wqkv'])} does not match "
                             f"the config's ({cfg.d_model}, {cfg.qkv_out})")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return _to_tensor(x, dev, dtype)

    return conv(tree)


def params_to_numpy(params):
    """The port's params -> the same tree of numpy arrays (bf16 tensors
    widen exactly to float32, which numpy can hold)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
