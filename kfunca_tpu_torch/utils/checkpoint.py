"""Checkpoint / resume: save and restore trees of tensors.

Counterpart of kfunca_tpu/utils/checkpoint.py (`save`, `load`), with the
same file format, so a checkpoint written by either package loads in the
other: one .npz holding `leaf_{i}` arrays in the tree's flatten order (dict
keys sorted, list items in order), bf16 leaves stored as their uint16 bits
(npz has no bf16), and a JSON manifest under `__kfunca_manifest__` with each
leaf's dtype name.  The file is written beside its path and moved into
place, so a crash never leaves a torn checkpoint.

Sharded checkpoints (save_sharded / load_sharded) are the JAX package's
directory format: `manifest.json` (each leaf's global shape and dtype) and
one `shard_<process>.npz` a process holding its ranks' pieces, each
recorded in `__shard_manifest__` with its slice in GLOBAL coordinates, a
piece held by several ranks (replicated) written once a process.  A tree
may hold parallel.mesh.ShardedParams nodes (params, or the optimizer
state through models/train.sharded_opt_state), whose leaves are written in
the global layout of param_specs, so a directory written by either package
loads in the other whatever the meshes.  save_async copies the tree to the
host before it returns and writes it on a thread; an error surfaces on
wait().

save_orbax / load_orbax read and write orbax's StandardCheckpointer
directory (OCDBT, zarr v2) with numpy and the native core alone (the
format: utils/orbax_format.py); a directory written by either package
loads in the other, bit for bit.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..parallel.mesh import ShardedParams, gather_leaf
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
    scalars to `path`; a ShardedParams node is saved as its global tree."""
    _write(path, [_to_host(leaf) for leaf in _global_leaves(tree)],
           _treedef(tree))


def _global_leaves(tree) -> list:
    """The leaves of `tree` in flatten order, a ShardedParams node's as its
    global tensors (gathered)."""
    out = []

    def walk(x):
        if isinstance(x, ShardedParams):
            out.extend(gather_leaf(x.mesh, s, list(xs))[0]
                       for s, xs in x.leaves())
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            out.append(x)

    walk(tree)
    del walk  # the walk -> cell -> walk cycle would hold `out` until gc
    return out


def _write(path: str, host, treedef: str) -> None:
    """The .npz of save() from (array, dtype name) pairs."""
    arrays = [a for a, _ in host]
    dtypes = [n for _, n in host]
    manifest = {"treedef": treedef, "kinds": ["array"] * len(arrays),
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
    if isinstance(tree, ShardedParams):
        return _treedef(tree.shards)
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


# ---------------------------------------------------------------------------
# sharded checkpoints (a shard file a process) and the asynchronous save
# ---------------------------------------------------------------------------


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _pieces(tree) -> list:
    """[(global shape, dtype name, [(global box, host array)])] a leaf in
    flatten order: this process's pieces of a ShardedParams leaf (one a
    distinct region), the whole of any other leaf."""
    out = []

    def add_sharded(sp: ShardedParams):
        mesh = sp.mesh
        for shard, xs in sp.leaves():
            seen, recs, name = set(), [], None
            for r, x in zip(mesh.ranks, xs):
                for box, sub in shard.slices(mesh, r):
                    key = tuple(map(tuple, box))
                    if key in seen:
                        continue
                    seen.add(key)
                    piece = x if sub is None else x.narrow(
                        shard.tp_dim, sub[0], sub[1] - sub[0])
                    arr, name = _to_host(piece)
                    recs.append((box, arr))
            if name is None:
                name = _to_host(xs[0])[1]
            out.append((list(shard.shape), name, recs))

    def walk(x):
        if isinstance(x, ShardedParams):
            add_sharded(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            arr, name = _to_host(x)
            out.append((list(arr.shape), name,
                        [([[0, n] for n in arr.shape], arr)]))

    walk(tree)
    del walk  # the walk -> cell -> walk cycle would hold `out` until gc
    return out


def save_sharded(dir_path: str, tree) -> None:
    """Save a tree of ShardedParams nodes and plain leaves as a sharded
    checkpoint directory:

        dir_path/manifest.json       treedef + per-leaf shape/dtype
        dir_path/shard_<proc>.npz    this process's pieces

    Each process writes only its own file; a piece replicated over ranks
    is written once.  Process 0 writes the manifest."""
    os.makedirs(dir_path, exist_ok=True)
    payload, records, leaves = {}, [], []
    for i, (shape, name, recs) in enumerate(_pieces(tree)):
        leaves.append({"shape": shape, "dtype": name})
        for box, arr in recs:
            key = f"leaf{i}_s{len(records)}"
            payload[key] = arr
            records.append({"leaf": i, "name": key, "slice": box})
    proc = _process_index()
    tmp = os.path.join(dir_path, f"shard_{proc}.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload, __shard_manifest__=np.frombuffer(
            json.dumps({"shards": records}).encode(), dtype=np.uint8))
    os.replace(tmp, os.path.join(dir_path, f"shard_{proc}.npz"))
    if proc == 0:
        manifest = {"version": 1, "treedef": _treedef(tree),
                    "leaves": leaves, "process": proc}
        mtmp = os.path.join(dir_path, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(dir_path, "manifest.json"))


def _from_host(arr, name, like):
    """A host array (bf16 as uint16 bits) as `like` takes it."""
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def load_sharded(dir_path: str, like):
    """Restore a sharded checkpoint against `like`: its ShardedParams nodes
    come back as ShardedParams over the same mesh and layout (each held
    rank's piece cut from the reassembled global leaf), its tensor leaves
    as tensors of their dtype and device, other leaves as numpy arrays.
    Raises where the shard files present leave a region of a leaf
    uncovered."""
    with open(os.path.join(dir_path, "manifest.json")) as f:
        manifest = json.load(f)
    metas = manifest["leaves"]
    full = [np.zeros(m["shape"], np.uint16 if m["dtype"] == "bfloat16"
                     else np.dtype(m["dtype"])) for m in metas]
    boxes = [set() for _ in metas]
    for path in sorted(glob.glob(os.path.join(dir_path, "shard_*.npz"))):
        with np.load(path, allow_pickle=False) as z:
            sm = json.loads(bytes(z["__shard_manifest__"]).decode())
            for rec in sm["shards"]:
                idx = tuple(slice(a, b) for a, b in rec["slice"])
                full[rec["leaf"]][idx] = z[rec["name"]]
                boxes[rec["leaf"]].add(tuple(map(tuple, rec["slice"])))
    for i, (arr, leaf_boxes) in enumerate(zip(full, boxes)):
        n = _covered(arr.shape, leaf_boxes)
        if n < arr.size:
            raise ValueError(f"leaf {i}: only {n}/{arr.size} elements "
                             f"covered by shards")
    it = iter(zip(full, metas))
    count = [0]

    def take(shape):
        count[0] += 1
        arr, meta = next(it, (None, None))
        if arr is None:
            raise ValueError(f"checkpoint has {len(metas)} leaves, the "
                             f"target more")
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape} for a "
                             f"target of {tuple(shape)}")
        return arr, meta["dtype"]

    def walk(x):
        if isinstance(x, ShardedParams):
            mesh = x.mesh
            leaves = []
            for shard, xs in x.leaves():
                arr, name = take(shard.shape)
                g = _from_host(arr, name, xs[0])
                leaves.append([shard.local(g, mesh, r) for r in mesh.ranks])
            local = [tree_unflatten(x.shards, [lv[j] for lv in leaves])
                     for j in range(len(mesh.ranks))]
            return ShardedParams(mesh, local, x.shards, x.specs, x.cfg,
                                 x.fsdp)
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if x is None:
            return None
        arr, name = take(np.shape(x))
        if isinstance(x, torch.Tensor):
            return _from_host(arr, name, x)
        return np.asarray(arr, dtype=np.asarray(x).dtype)

    out = walk(like)
    if count[0] != len(metas):
        raise ValueError(f"checkpoint has {len(metas)} leaves, the target "
                         f"{count[0]}")
    return out


def _covered(shape, boxes) -> int:
    """Elements of a leaf covered by the (distinct) boxes: the sum of their
    volumes when no two overlap, else a per-element mask (a region may be
    held by some processes whole and by others in pieces)."""
    boxes = sorted(boxes)

    def volume(b):
        return int(np.prod([hi - lo for lo, hi in b], dtype=np.int64))

    def overlap(a, b):
        return all(lo1 < hi2 and lo2 < hi1
                   for (lo1, hi1), (lo2, hi2) in zip(a, b))

    if not any(overlap(a, b) for i, a in enumerate(boxes)
               for b in boxes[i + 1:]):
        return sum(volume(b) for b in boxes)
    mask = np.zeros(shape, bool)
    for b in boxes:
        mask[tuple(slice(lo, hi) for lo, hi in b)] = True
    return int(mask.sum())


class AsyncCheckpoint:
    """Handle of an in-flight save_async; wait() joins the writer thread
    and raises the error it met, if any."""

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self.error = None

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self) -> None:
        self._thread.join()
        if self.error is not None:
            raise self.error


def save_async(path: str, tree) -> AsyncCheckpoint:
    """save() on a thread.  The device-to-host copy happens NOW (the
    tensors may change as soon as this returns); the file write runs in
    the background."""
    host = [_to_host(leaf) for leaf in _global_leaves(tree)]
    host = [(np.array(a, copy=True), n) for a, n in host]
    treedef = _treedef(tree)
    handle = None

    def write():
        try:
            _write(path, host, treedef)
        except Exception as e:  # surfaced on wait()
            handle.error = e

    t = threading.Thread(target=write, daemon=True)
    handle = AsyncCheckpoint(t)
    t.start()
    return handle


# ---------------------------------------------------------------------------
# orbax interop: the StandardCheckpointer format without orbax
# ---------------------------------------------------------------------------


def _orbax_items(tree, keys=()):
    """(keys, leaf) of each leaf in flatten order: keys a tuple of (key,
    key_type), 2 a dict key and 1 a sequence index, as orbax records them;
    a ShardedParams node as its global tree."""
    if isinstance(tree, ShardedParams):
        leaves = [gather_leaf(tree.mesh, s, list(xs))[0]
                  for s, xs in tree.leaves()]
        tree = tree_unflatten(tree.shards, leaves)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _orbax_items(tree[k], keys + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _orbax_items(v, keys + ((str(i), 1),))
    elif tree is not None:
        yield keys, tree


def _orbax_host(leaf):
    """(C-contiguous numpy array, zarr dtype, is a Python scalar) of a leaf:
    torch tensors on any device (bf16 as its bits), eager kfunca Tensors
    (their dtype kept), numpy arrays and scalars, Python numbers (stored as
    int64 / float64 / bool, as orbax stores them)."""
    from . import orbax_format as of
    from ..core.tensor import Tensor

    if isinstance(leaf, Tensor):
        leaf = leaf.to_torch()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16", False
        arr = t.numpy()
    else:
        scalar = isinstance(leaf, (bool, int, float))
        arr = np.asarray(leaf)  # not ascontiguousarray: it makes 0-d 1-d
        if arr.dtype.name == "bfloat16":  # an ml_dtypes array
            return arr.view(np.uint16), "bfloat16", scalar
        if scalar:
            return arr, of.NUMPY_TO_ZARR[arr.dtype], True
    if arr.dtype not in of.NUMPY_TO_ZARR:
        raise ValueError(f"save_orbax: dtype {arr.dtype} is not written "
                         f"(float32, bfloat16, float16, float64, int8, "
                         f"int16, int32, int64, uint8 and bool are)")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    return arr, of.NUMPY_TO_ZARR[arr.dtype], False


def save_orbax(dir_path: str, tree) -> None:
    """Write `tree` as orbax's StandardCheckpointer writes it (use_ocdbt,
    zarr v2), readable by the JAX package's load_orbax; an existing
    directory is replaced, as orbax's force=True replaces it.  Leaves:
    torch tensors on any device, eager kfunca Tensors, numpy arrays and
    scalars, Python numbers; nodes: dicts, lists, tuples and ShardedParams
    (written as the global tree).  Every chunk is a zstd frame of raw
    blocks, so the directory is about the size of the raw arrays.  Needs no
    native core."""
    from . import orbax_format as of

    dir_path = os.path.abspath(dir_path)
    values, tree_md, array_md, sharding = {}, {}, [], {}
    for keys, leaf in _orbax_items(tree):
        host, zdt, scalar = _orbax_host(leaf)
        name = ".".join(k for k, _ in keys)
        shape = list(host.shape)
        values[f"{name}/.zarray"] = [of.zarray_json(shape, zdt)]
        chunk = ".".join("0" for _ in shape) or "0"
        values[f"{name}/{chunk}"] = of.zstd_raw_frame_parts(
            memoryview(host.reshape(-1).view(np.uint8)))
        value_md = {"value_type": "scalar" if scalar else "jax.Array",
                    "skip_deserialize": False}
        if not scalar:
            value_md["write_shape"] = shape
            array_md.append({"array_metadata": {
                "param_name": name, "write_shape": shape,
                "chunk_shape": shape, "ext_metadata": None}})
            sharding[of.sharding_key(name)] = json.dumps({
                "sharding_type": "SingleDeviceSharding",
                "device_str": "TFRT_CPU_0"})
        tree_md[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value_md}
    tmp = f"{dir_path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.join(tmp, "array_metadatas"))
    started = time.time_ns()
    of.write_ocdbt(tmp, values)
    files = {
        "_METADATA": {"tree_metadata": tree_md, "use_ocdbt": True,
                      "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True,
                      "custom_metadata": None},
        "_sharding": sharding,
        os.path.join("array_metadatas", "process_0"): {
            "array_metadatas": array_md},
        "_CHECKPOINT_METADATA": {
            "item_handlers": "orbax.checkpoint._src.handlers."
                             "standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": started,
            "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}},
    }
    for rel, obj in files.items():
        with open(os.path.join(tmp, rel), "w") as f:
            json.dump(obj, f)
    if os.path.exists(dir_path):
        shutil.rmtree(dir_path)
    os.replace(tmp, dir_path)


def _proto_dtype(proto) -> torch.dtype:
    from ..core.dtype import to_torch
    from ..core.tensor import Tensor

    if isinstance(proto, torch.Tensor):
        return proto.dtype
    if isinstance(proto, Tensor):
        return to_torch(proto.dtype())
    arr = np.asarray(proto)
    if arr.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), arr.dtype)).dtype


def load_orbax(dir_path: str, like, device=None):
    """Restore an orbax StandardCheckpointer directory (use_ocdbt, zarr v2;
    written by the JAX package's save_orbax, by orbax, or by save_orbax)
    against `like`'s structure and dtypes, as the JAX package's load_orbax.
    Array leaves come back as torch tensors of `like`'s dtype on the card,
    or on `device` (device="cpu" for the plain path); a Python-number leaf
    of `like` as a number of its type.  A layout not read here (zarr3, a
    dtype, a missing leaf or key, a shape other than `like`'s) raises
    ValueError naming it, before anything is returned.  zstd decodes in the
    native core: without it this raises RuntimeError."""
    from . import orbax_format as of
    from ..runtime import _native
    from ..runtime.backend import resolve_device

    dir_path = os.path.abspath(dir_path)
    if _native.get_lib() is None:
        raise RuntimeError("load_orbax decodes zstd in the native core "
                           "(csrc/core.cpp, built by g++); it is not built "
                           "(KFUNCA_NO_NATIVE=1, or no g++)")
    dev = resolve_device(device)
    try:
        with open(os.path.join(dir_path, "_METADATA")) as f:
            meta = json.load(f)
    except OSError as e:
        raise ValueError(f"{dir_path}: not an orbax checkpoint ({e})") from None
    if meta.get("use_zarr3"):
        raise ValueError(f"{dir_path}: use_zarr3 is true; only zarr v2 "
                         f"checkpoints are read here")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{dir_path}: use_ocdbt is false; only OCDBT "
                         f"checkpoints are read here")
    tree_md = meta.get("tree_metadata", {})
    store = of.OcdbtReader(dir_path)
    items = list(_orbax_items(like))
    out = []
    for keys, proto in items:
        path = str(tuple(k for k, _ in keys))
        if path not in tree_md:
            raise ValueError(f"{dir_path}: no leaf {path} in the checkpoint "
                             f"(it holds {sorted(tree_md)})")
        name = ".".join(k for k, _ in keys)
        arr, zdt = of.read_zarr(store, name)
        if isinstance(proto, (bool, int, float)):
            if arr.shape != ():
                raise ValueError(f"leaf {path}: shape {arr.shape} for a "
                                 f"Python number of `like`")
            out.append(type(proto)(arr.item()))
            continue
        if zdt == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want = tuple(proto.sizes()) if hasattr(proto, "sizes") else tuple(
            np.shape(proto))
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {path}: the checkpoint holds shape "
                             f"{tuple(t.shape)}, `like` has {want}")
        out.append(t.to(device=dev, dtype=_proto_dtype(proto)))
    it = iter(out)

    def rebuild(x):
        if isinstance(x, ShardedParams):  # the global tree's structure
            return rebuild(x.shards)
        if isinstance(x, dict):
            return {k: rebuild(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return None if x is None else next(it)

    return rebuild(like)
