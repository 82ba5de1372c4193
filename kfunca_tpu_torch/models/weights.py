"""Carry transformer parameters and optimizer state between the JAX
package and the port.

Both packages use one parameter layout (see models/transformer.py) and one
optimizer-state layout (see models/train.py), so a JAX pytree maps leaf for
leaf onto the port's dicts of tensors, and both can start a step from the
same (params, opt_state).  The conversion goes through numpy: the port
never imports JAX, and a caller holding JAX arrays passes them as they are
(each leaf goes through np.asarray) or as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import pack_int4
from ..runtime.backend import resolve_device
from ..utils.tree import tree_map
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

    return tree_map(lambda x: _to_tensor(x, dev, dtype), tree)


def decode_params_from_jax(tree, device=None):
    """A JAX `quantize_decode_params` pytree -> the port's decode params on
    `device` (default: the CUDA device): quantized weights are
    (intN array, fp32 scales) tuples there and here.  int8 pairs cross as
    they are.  numpy has no int4, so the caller hands jnp.int4 weights over
    widened (`w.astype(jnp.int8)`); a pair whose scales are 2-D group
    scales is such a widened int4 weight and is packed two values a byte
    (ops/quant.pack_int4).  Float leaves keep their dtype."""
    dev = resolve_device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            w, scale = (_to_tensor(leaf, "cpu", None) for leaf in x)
            if scale.ndim == 2:
                w = pack_int4(w.to(torch.int8))
            return w.to(dev), scale.to(dev)
        return _to_tensor(x, dev, None)

    return walk(tree)


def opt_state_from_jax(tree, device=None):
    """JAX optimizer state (init_opt_state's layout: "step", "m", "v", ...)
    -> the port's on `device` (default: the CUDA device), every leaf in its
    own dtype (int32 step, fp32 or bf16 moments, 0-dim dummies)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _to_tensor(x, dev, None), tree)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def tree_to_numpy(tree):
    """A tree of tensors (params, optimizer state) -> the same tree of
    numpy arrays (bf16 tensors widen exactly to float32, which numpy can
    hold)."""
    return tree_map(_to_numpy, tree)


params_to_numpy = tree_to_numpy  # the same walk, under the params' name
