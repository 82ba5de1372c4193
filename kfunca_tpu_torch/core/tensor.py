"""Tensor handle: strided views over Storage + tape-based autograd.

Counterpart of kfunca_tpu/core/tensor.py (the reference's Tensor /
TensorImpl / GradFunction stack, tensor.h:24-165, tensor_impl.h:150-214,
tensor.cpp:86-126).  The data plane is a flat torch tensor per storage
(core/storage.py); view ops are pure metadata (shape/strides/offset), and
reads/writes go through core/materialize.py.

  * data_ptr() is the real device address: the storage tensor's address
    plus offset x element size.  In-place ops write into the storage
    tensor, so the address is stable, as the reference tests require.
  * The tape is kfunca's own: GradFunction nodes and the reference's
    two-pass schedule.  torch.autograd is not used; the torch tensors
    inside carry no requires_grad.
  * numpy() of a bfloat16 tensor returns float32 values (exact): numpy has
    no bfloat16, and the JAX package's ml_dtypes arrays come with JAX.
    from_numpy accepts an ml_dtypes bfloat16 array by its dtype name.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from . import materialize as mat
from .dtype import ScalarType, element_size, from_numpy_dtype
from .dtype import from_torch as _scalar_of
from .iterator import MAX_TENSOR_DIMS, check, maybe_wrap_dim
from .storage import Storage

_ELEMENTWISE = None


def _elementwise():
    """ops.elementwise, cached (a module-level import would be circular:
    ops.elementwise imports this module)."""
    global _ELEMENTWISE
    if _ELEMENTWISE is None:
        from ..ops import elementwise as _m

        _ELEMENTWISE = _m
    return _ELEMENTWISE


class TensorImpl:
    """Shape/stride/offset metadata over a Storage (reference tensor_impl.h)."""

    __slots__ = (
        "storage",
        "shape",
        "strides",
        "offset",
        "dtype",
        "requires_grad",
        "grad",
        "__weakref__",
    )

    def __init__(self, storage: Storage, shape, strides, offset: int, dtype: ScalarType):
        self.storage = storage
        self.shape = tuple(int(s) for s in shape)
        self.strides = tuple(int(s) for s in strides)
        self.offset = int(offset)
        self.dtype = dtype
        self.requires_grad = False
        self.grad = None  # Tensor

    @property
    def numel(self) -> int:
        return mat.numel_of(self.shape)

    def is_contiguous(self) -> bool:
        return mat.is_contiguous(self.shape, self.strides)


class GradFunction:
    """Autograd tape node (reference tensor.h:18-22). Subclasses implement
    backward(grad_output) -> list of grads aligned with self.inputs."""

    def __init__(self, inputs):
        self.inputs = list(inputs)

    def backward(self, grad_output: "Tensor"):
        raise NotImplementedError


class Tensor:
    """Value-type handle: shares a TensorImpl; copies share storage."""

    __slots__ = ("_impl", "_grad_fn")

    def __init__(self, impl: TensorImpl | None = None, grad_fn=None):
        self._impl = impl
        self._grad_fn = grad_fn

    # -- copies ------------------------------------------------------------

    def __copy__(self):
        return Tensor(self._impl, self._grad_fn)

    def __deepcopy__(self, memo):
        return Tensor(self._impl, self._grad_fn)

    # -- basic introspection -------------------------------------------------

    def defined(self) -> bool:
        return self._impl is not None

    def impl(self) -> TensorImpl:
        return self._impl

    def dim(self) -> int:
        return len(self._impl.shape)

    def shape(self, d: int) -> int:
        return self._impl.shape[maybe_wrap_dim(d, self.dim())]

    def sizes(self):
        return list(self._impl.shape)

    def strides(self):
        return list(self._impl.strides)

    def stride(self, d: int) -> int:
        return self._impl.strides[maybe_wrap_dim(d, self.dim())]

    def numel(self) -> int:
        return self._impl.numel

    def dtype(self) -> ScalarType:
        return self._impl.dtype

    def device(self):
        """The CUDA index the tensor lives on, or "cpu"."""
        return self._impl.storage.device

    def torch_device(self) -> torch.device:
        return self._impl.storage.torch_device

    def storage_offset(self) -> int:
        return self._impl.offset

    def is_contiguous(self) -> bool:
        return self._impl.is_contiguous()

    def data_ptr(self) -> int:
        return self._impl.storage.base_ptr + self._impl.offset * element_size(self._impl.dtype)

    def storage_ref_count(self) -> int:
        return sys.getrefcount(self._impl.storage) - 1

    def impl_ref_count(self) -> int:
        return sys.getrefcount(self._impl) - 1

    # -- device data ---------------------------------------------------------

    def _array(self) -> torch.Tensor:
        """The view as a torch tensor of shape self.sizes(): a torch view of
        the storage (no copy) unless a stride is negative."""
        impl = self._impl
        return mat.read_view(impl.storage.data, impl.shape, impl.strides, impl.offset)

    def _write(self, value) -> "Tensor":
        """Write a dense array (or scalar) through this view, in place."""
        impl = self._impl
        mat.write_view(impl.storage.data, impl.shape, impl.strides, impl.offset, value)
        return self

    def numpy(self):
        check(self.is_contiguous(), "to_numpy() requires a contiguous tensor")
        arr = self._array()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        # an owned, writable copy (reference to_numpy is a D2H memcpy)
        return np.array(arr.detach().cpu().numpy(), copy=True)

    def to_torch(self) -> torch.Tensor:
        """A dense torch tensor holding the view's values.  It never aliases
        the storage, so later in-place ops on this tensor leave it alone
        (the role of the JAX package's to_jax)."""
        return self._array().clone(memory_format=torch.contiguous_format)

    def item(self, indices):
        check(len(indices) == self.dim(), "item(): index rank mismatch")
        impl = self._impl
        flat = impl.offset
        for d, i in enumerate(indices):
            i = int(i)
            check(0 <= i < impl.shape[d], "item(): index out of range")
            flat += i * impl.strides[d]
        return impl.storage.data[flat].item()

    # -- factories-on-self ----------------------------------------------------

    def fill_(self, value) -> "Tensor":
        return _elementwise().fill_(self, value)

    def contiguous(self) -> "Tensor":
        if self.is_contiguous():
            return self
        out = empty(self.sizes(), self.dtype(), self.device())
        return _elementwise().copy_(out, self)

    def clone(self) -> "Tensor":
        out = empty(self.sizes(), self.dtype(), self.device())
        return _elementwise().copy_(out, self)

    def copy_(self, src: "Tensor") -> "Tensor":
        return _elementwise().copy_(self, src)

    # -- view ops (pure metadata; reference tensor.cpp:148-320) ---------------

    def as_strided(self, shape, strides, offset) -> "Tensor":
        impl = self._impl
        n = mat.numel_of(shape)
        if n > 0:
            max_off = int(offset) + sum(
                (int(s) - 1) * int(st) for s, st in zip(shape, strides) if int(s) > 0
            )
            check(max_off < impl.storage.numel, "as_strided out of bounds")
        return Tensor(TensorImpl(impl.storage, shape, strides, offset, impl.dtype))

    def permute(self, *dims) -> "Tensor":
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = tuple(dims[0])
        check(len(dims) == self.dim(), "permute: rank mismatch")
        dims = [maybe_wrap_dim(d, self.dim()) for d in dims]
        check(sorted(dims) == list(range(self.dim())), "permute: invalid permutation")
        impl = self._impl
        shape = tuple(impl.shape[d] for d in dims)
        strides = tuple(impl.strides[d] for d in dims)
        return self.as_strided(shape, strides, impl.offset)

    def slice(self, dim: int, start: int, end: int, step: int = 1) -> "Tensor":
        dim = maybe_wrap_dim(dim, self.dim())
        impl = self._impl
        n = impl.shape[dim]
        check(step > 0, "slice: step must be positive")
        start = min(max(int(start), 0), n)
        end = min(max(int(end), start), n)
        new_len = (end - start + step - 1) // step
        shape = list(impl.shape)
        strides = list(impl.strides)
        offset = impl.offset + start * strides[dim]
        shape[dim] = new_len
        strides[dim] = strides[dim] * step
        return self.as_strided(shape, strides, offset)

    def select(self, dim: int, index: int) -> "Tensor":
        dim = maybe_wrap_dim(dim, self.dim())
        impl = self._impl
        n = impl.shape[dim]
        if index < 0:
            index += n
        check(0 <= index < n, "select: index out of range")
        shape = list(impl.shape)
        strides = list(impl.strides)
        offset = impl.offset + index * strides[dim]
        del shape[dim], strides[dim]
        return self.as_strided(shape, strides, offset)

    def narrow(self, dim: int, start: int, length: int) -> "Tensor":
        return self.slice(dim, start, start + length, 1)

    def view(self, *dims) -> "Tensor":
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = tuple(dims[0])
        check(self.is_contiguous(), "view() requires a contiguous tensor")
        dims = [int(d) for d in dims]
        neg = [i for i, d in enumerate(dims) if d == -1]
        check(len(neg) <= 1, "view: at most one -1 dim")
        known = math.prod(d for d in dims if d != -1)
        if neg:
            check(known != 0 and self.numel() % known == 0, "view: shape mismatch")
            dims[neg[0]] = self.numel() // known
        check(math.prod(dims) == self.numel(), "view: shape mismatch")
        return self.as_strided(dims, mat.contiguous_strides(dims), self._impl.offset)

    def split(self, split_sizes, dim: int):
        dim = maybe_wrap_dim(dim, self.dim())
        check(sum(split_sizes) == self.shape(dim), "split: sizes must sum to dim extent")
        outs, start = [], 0
        for s in split_sizes:
            outs.append(self.narrow(dim, start, s))
            start += s
        return outs

    def __getitem__(self, key):
        out = self
        if isinstance(key, tuple):
            check(len(key) <= self.dim(), "too many indices")
            dim = 0
            for item in key:
                if isinstance(item, slice):
                    start, end, step = item.indices(out.shape(dim))
                    out = out.slice(dim, start, end, step)
                    dim += 1
                else:
                    out = out.select(dim, int(item))
        elif isinstance(key, slice):
            start, end, step = key.indices(self.shape(0))
            out = out.slice(0, start, end, step)
        else:
            out = out.select(0, int(key))
        return out

    # -- arithmetic ------------------------------------------------------------

    def _scalar_like(self, scalar) -> "Tensor":
        # reference pattern: self op empty_like(self).fill_(scalar)
        # (register.cpp:172-206) — scalar adopts self's dtype.
        return empty_like(self).fill_(scalar)

    def _binary(self, name, other, inplace=False):
        elementwise = _elementwise()
        if not isinstance(other, Tensor):
            if not self.requires_grad():
                # fused: the scalar rides as a 0-d operand in the acc dtype,
                # the semantics of the filled-tensor pattern in one op
                return elementwise.binary_scalar_op(
                    name, self, other, out=self if inplace else None
                )
            other = self._scalar_like(other)
        return elementwise.binary_op(name, self, other, out=self if inplace else None)

    def __add__(self, other):
        return self._binary("add", other)

    def __sub__(self, other):
        return self._binary("sub", other)

    def __mul__(self, other):
        return self._binary("mul", other)

    def __truediv__(self, other):
        return self._binary("div", other)

    def __neg__(self):
        return _elementwise().unary_op("neg", self)

    def __matmul__(self, other):
        from ..ops import gemm as _gemm

        return _gemm.gemm(self, other, 1.0, 0.0)

    def __iadd__(self, other):
        return self._binary("add", other, inplace=True)

    def __isub__(self, other):
        return self._binary("sub", other, inplace=True)

    def __imul__(self, other):
        return self._binary("mul", other, inplace=True)

    def __itruediv__(self, other):
        return self._binary("div", other, inplace=True)

    # -- unary math (extension; reference unary layer is clone/copy/convert) ----

    def _unary(self, name):
        return _elementwise().unary_op(name, self)

    def neg(self):
        return self._unary("neg")

    def abs(self):
        return self._unary("abs")

    def exp(self):
        return self._unary("exp")

    def log(self):
        return self._unary("log")

    def sqrt(self):
        return self._unary("sqrt")

    def rsqrt(self):
        return self._unary("rsqrt")

    def relu(self):
        return self._unary("relu")

    def sigmoid(self):
        return self._unary("sigmoid")

    def tanh(self):
        return self._unary("tanh")

    # -- reductions / sort / nn -------------------------------------------------

    def sum(self, dim: int) -> "Tensor":
        from ..ops import reduce as _reduce

        return _reduce.sum(self, dim)

    def mean(self, dim: int) -> "Tensor":
        from ..ops import reduce as _reduce

        return _reduce.mean(self, dim)

    def mean_var(self, dim: int, take_sqrt: bool):
        from ..ops import reduce as _reduce

        return _reduce.mean_var(self, dim, take_sqrt)

    def norm_stat(self, dim: int):
        from ..ops import reduce as _reduce

        return _reduce.norm_stat(self, dim)

    def sort(self, dim: int, descending: bool):
        from ..ops import sort as _sort

        return _sort.sort(self, dim, descending)

    def topk(self, k: int, dim: int, largest: bool):
        from ..ops import sort as _sort

        return _sort.topk(self, k, dim, largest)

    def index_put_(self, indices, values) -> "Tensor":
        from ..ops import index as _index

        return _index.index_put_(self, indices, values)

    # -- dtype conversion ---------------------------------------------------------

    def _convert(self, dtype: ScalarType) -> "Tensor":
        return _elementwise().convert(self, dtype)

    def half(self) -> "Tensor":
        return self._convert(ScalarType.Half)

    def bfloat16(self) -> "Tensor":
        return self._convert(ScalarType.BFloat16)

    def float(self) -> "Tensor":
        return self._convert(ScalarType.Float)

    def double(self) -> "Tensor":
        return self._convert(ScalarType.Double)

    # -- autograd (reference tensor.cpp:75-126) -----------------------------------

    def requires_grad(self) -> bool:
        return self._impl.requires_grad

    def set_requires_grad(self, value: bool) -> "Tensor":
        self._impl.requires_grad = bool(value)
        return self

    def grad_fn(self):
        return self._grad_fn

    def set_grad_fn(self, fn) -> None:
        self._grad_fn = fn

    def grad(self):
        return self._impl.grad

    def update_grad(self, g: "Tensor") -> None:
        """Leaf accumulation: clone on first grad, += after (tensor.cpp:75-84)."""
        elementwise = _elementwise()
        if self._impl.grad is None or not self._impl.grad.defined():
            self._impl.grad = g.clone()
        else:
            elementwise.binary_op("add", self._impl.grad, g, out=self._impl.grad, track_grad=False)

    def _tape_nodes(self):
        """Collect the reachable interior graph: nodes are tensors carrying a
        grad_fn, keyed by impl identity; edges (u -> v) mean "u's backward
        delivers a gradient to interior node v"."""
        nodes = []  # Tensor per node
        index = {}  # id(impl) -> node index
        edges = []  # (src, dst)
        stack = [self]
        index[id(self._impl)] = 0
        nodes.append(self)
        while stack:
            t = stack.pop()
            u = index[id(t._impl)]
            for inp in t._grad_fn.inputs:
                if not (inp.defined() and inp._impl.requires_grad):
                    continue
                if inp._grad_fn is None:
                    continue  # leaf
                key = id(inp._impl)
                if key not in index:
                    index[key] = len(nodes)
                    nodes.append(inp)
                    stack.append(inp)
                edges.append((u, index[key]))
        return nodes, edges

    @staticmethod
    def _schedule(n_nodes, edges):
        """Execution order for the tape (reference two-pass BFS,
        tensor.cpp:86-126): a node runs only after every consumer has
        delivered its gradient.  Runs in the native core's scheduler
        (csrc/core.cpp kf_tape_schedule) when it is loaded; Python
        otherwise."""
        from ..runtime import _native

        lib = _native.get_lib()
        if lib is not None and edges:
            src = _native.i64_array([e[0] for e in edges])
            dst = _native.i64_array([e[1] for e in edges])
            out = _native.i64_array([0] * n_nodes)
            n = lib.kf_tape_schedule(n_nodes, len(edges), src, dst, 0, out)
            check(n >= 0, "tape scheduler: edge out of range")
            return [out[i] for i in range(n)]
        uses = [0] * n_nodes
        children = [[] for _ in range(n_nodes)]
        for u, v in edges:
            children[u].append(v)
            uses[v] += 1
        order, queue = [], [0]
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in children[u]:
                uses[v] -= 1
                if uses[v] == 0:
                    queue.append(v)
        return order

    def backward(self, grad: "Tensor") -> None:
        """Tape walk: schedule (two-pass BFS semantics), then execute,
        accumulating interior gradients and updating leaves."""
        elementwise = _elementwise()
        check(grad is not None and grad.defined(), "backward() needs an explicit grad")
        if self._grad_fn is None:
            if self._impl.requires_grad:
                self.update_grad(grad)
            return

        nodes, edges = self._tape_nodes()
        order = self._schedule(len(nodes), edges)

        grad_of: dict[int, Tensor] = {id(self._impl): grad}
        for node_idx in order:
            t = nodes[node_idx]
            g = grad_of.pop(id(t._impl))
            for inp, gi in zip(t._grad_fn.inputs, t._grad_fn.backward(g)):
                if gi is None or not (inp.defined() and inp._impl.requires_grad):
                    continue
                if inp._grad_fn is None:
                    inp.update_grad(gi)
                    continue
                key = id(inp._impl)
                if key in grad_of:
                    elementwise.binary_op(
                        "add", grad_of[key], gi, out=grad_of[key], track_grad=False
                    )
                else:
                    grad_of[key] = gi.clone()

    # -- printing -------------------------------------------------------------------

    def to_string(self) -> str:
        if not self.defined():
            return "tensor(undefined)"
        impl = self._impl
        head = (
            f"tensor(shape={list(impl.shape)}, strides={list(impl.strides)}, "
            f"offset={impl.offset}, dtype={impl.dtype.name}, device={impl.storage.device})"
        )
        try:
            with np.printoptions(threshold=144, edgeitems=3):
                body = str(self.contiguous().numpy())
        except Exception as e:  # uninitialized or during teardown
            body = f"<unavailable: {e}>"
        return head + "\n" + body

    def __repr__(self) -> str:
        return self.to_string()


# -- factories (reference tensor.cpp:17-69) -----------------------------------------


def _shape_tuple(shape) -> tuple:
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    check(len(shape) <= MAX_TENSOR_DIMS, "too many dims")
    return shape


def empty(shape, dtype: ScalarType, device=0) -> Tensor:
    """Uninitialized contiguous tensor, as the reference's cudaMalloc."""
    shape = _shape_tuple(shape)
    storage = Storage(mat.numel_of(shape), dtype, device)
    return Tensor(TensorImpl(storage, shape, mat.contiguous_strides(shape), 0, dtype))


def empty_like(t: Tensor) -> Tensor:
    return empty(t.sizes(), t.dtype(), t.device())


def adopt_flat(flat: torch.Tensor, shape, dtype: ScalarType) -> Tensor:
    """Fresh contiguous tensor ADOPTING `flat` (a 1-D torch tensor in the
    storage dtype that nothing else holds) as its storage: an op's fresh
    result becomes a Tensor without a copy."""
    storage = Storage(mat.numel_of(shape), dtype, data=flat)
    return Tensor(TensorImpl(storage, shape, mat.contiguous_strides(shape), 0, dtype))


def empty_strided(shape, strides, dtype: ScalarType, device=0) -> Tensor:
    shape = tuple(int(s) for s in shape)
    strides = tuple(int(s) for s in strides)
    # A negative stride with storage_offset 0 would index below the
    # storage; rejected like torch.empty_strided.  Negative strides remain
    # legal for as_strided views within an existing storage.
    check(all(st >= 0 for st in strides), "empty_strided: negative strides", strides)
    # storage sized from the offset range, not numel (reference
    # tensor_impl.cpp:57-65) — handles arbitrary strided layouts.
    span = 1 + sum((s - 1) * st for s, st in zip(shape, strides) if s > 0)
    storage = Storage(span, dtype, device)
    return Tensor(TensorImpl(storage, shape, strides, 0, dtype))


def zeros(shape, dtype: ScalarType, device=0) -> Tensor:
    shape = _shape_tuple(shape)
    storage = Storage(mat.numel_of(shape), dtype, device, zero=True)
    return Tensor(TensorImpl(storage, shape, mat.contiguous_strides(shape), 0, dtype))


def _torch_of_numpy(array) -> torch.Tensor:
    """A torch tensor over a C-contiguous numpy array (bfloat16 by name)."""
    if not array.flags.writeable:  # torch wants writable memory; we copy anyway
        array = array.copy()
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def from_numpy(array, device=0) -> Tensor:
    """A fresh contiguous tensor holding a COPY of `array` (the reference's
    copy_from_cpu_ptr is an H2D memcpy: later numpy mutations must not
    reach the tensor)."""
    array = np.ascontiguousarray(array)
    dtype = from_numpy_dtype(array.dtype)
    out = empty(array.shape, dtype, device)
    out._impl.storage.data.copy_(_torch_of_numpy(array).reshape(-1))
    return out


def to_numpy(t: Tensor):
    return t.numpy()


def from_torch(arr: torch.Tensor, device=0) -> Tensor:
    """A fresh contiguous tensor holding a copy of a torch tensor, on
    `device`: CUDA index 0 by default whatever device `arr` lies on (it
    raises without a card), "cpu" for the plain path; the role of the JAX
    package's from_jax(arr, device=0)."""
    dtype = _scalar_of(arr.dtype)
    out = empty(tuple(arr.shape), dtype, device)
    out._impl.storage.data.copy_(arr.detach().reshape(-1))
    return out


def from_storage_numpy(flat, shape, strides, offset: int, device=0) -> Tensor:
    """The port's view of another tensor's state: `flat` is its whole
    storage as a 1-D numpy array (copied once into a fresh storage), and
    (shape, strides, offset) its view metadata.  The parity tests take a
    JAX-package Tensor's storage and view this way, so one strided view
    feeds both packages."""
    flat = np.ascontiguousarray(flat).reshape(-1)
    base = from_numpy(flat, device)
    return base.as_strided(tuple(shape), tuple(strides), int(offset))
