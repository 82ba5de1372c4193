"""Checkpoint / resume: save and restore trees of tensors.

Counterpart of kfunca_tpu/utils/checkpoint.py (`save`, `load`), with the
same file format, so a checkpoint written by either package loads in the
other: one .npz holding `leaf_{i}` arrays in the tree's flatten order (dict
keys sorted, list items in order), bf16 leaves stored as their uint16 bits
(npz has no bf16), and a JSON manifest under `__kfunca_manifest__` with each
leaf's dtype name.  The file is written beside its path and moved into
place, so a crash never leaves a torn checkpoint.

Sharded, asynchronous and orbax checkpoints are a later slice of the port.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_unflatten

_MANIFEST_KEY = "__kfunca_manifest__"


def _to_host(leaf):
    """(array for the .npz, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array handed in
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def save(path: str, tree) -> None:
    """Save a tree (dicts and lists) of tensors, numpy arrays and numpy
    scalars to `path`."""
    arrays, dtypes = [], []
    for leaf in tree_leaves(tree):
        arr, name = _to_host(leaf)
        arrays.append(arr)
        dtypes.append(name)
    manifest = {"treedef": _treedef(tree), "kinds": ["array"] * len(arrays),
                "dtypes": dtypes, "version": 1}
    payload = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    payload[_MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic: a crash never corrupts the checkpoint


def _treedef(tree) -> str:
    """A readable description of the structure (informational, as the JAX
    package's str(treedef); load() follows `like`, not this)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def load(path: str, like=None, device=None):
    """Restore a checkpoint.

    `like` is a tree with the target structure: the result mirrors it, each
    tensor leaf coming back as a tensor of `like`'s dtype on `like`'s device
    (or on `device` when given), each numpy leaf as a numpy array of its
    dtype.  Without `like`, returns the flat list of numpy arrays (bf16
    leaves as their uint16 bits)."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z[_MANIFEST_KEY]).decode())
        arrays = [z[f"leaf_{i}"] for i in range(len(manifest["dtypes"]))]
    if like is None:
        return arrays
    protos = tree_leaves(like)
    if len(protos) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, target "
                         f"structure has {len(protos)}")
    out = []
    for proto, arr, name in zip(protos, arrays, manifest["dtypes"]):
        if not isinstance(proto, torch.Tensor):
            out.append(np.asarray(arr, dtype=np.asarray(proto).dtype))
            continue
        if name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(proto.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for "
                             f"a target of {tuple(proto.shape)}")
        out.append(t.to(device=proto.device if device is None else device,
                        dtype=proto.dtype))
    return tree_unflatten(like, out)
