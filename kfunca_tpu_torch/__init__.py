"""PyTorch/CUDA port of kfunca_tpu for one NVIDIA Hopper card (sm_90a).

The package mirrors kfunca_tpu's module layout so each counterpart is easy
to find; kfunca_tpu stays the reference the port is tested against.  Plain
tensor code is PyTorch, and every Pallas TPU kernel on a ported path has a
hand-written CUDA kernel under `csrc/`, built with nvcc at first use
(runtime/_kernels.py) and bound through ctypes.

`import kfunca_tpu_torch as kfunca` gives the eager Tensor API of the
reference (kfunca_tpu/__init__.py): strided Tensors over storages (core/),
kfunca's dtype promotion, elementwise, reduction, shape, index and sort
ops, the GEMM, eager causal attention, kfunca's own autograd tape and
`autotune`.  Its engine knobs are the JAX package's, read at dispatch
time: KFUNCA_GEMM_ENGINE=pallas runs K3 (csrc/matmul.cu, at the tile
`autotune("gemm", ...)` recorded), KFUNCA_REDUCE_ENGINE=pallas K8 for sum
and mean (csrc/reduce.cu; K7, the Welford kernel in the same file, is
norm_stat's default), KFUNCA_ELEMENTWISE_ENGINE=pallas K9
(csrc/elementwise.cu), KFUNCA_PALLAS_SORT=1 K10 for sort and topk
(csrc/bitonic_sort.cu).  The host-side planning (promotion, broadcasting,
view loop nests, the tape schedule, the server's page pool, queue and
prefix index) runs in the native core (csrc/core.cpp, built by g++ at
first use) unless KFUNCA_NO_NATIVE=1.

    import numpy as np
    import kfunca_tpu_torch as kfunca
    x = kfunca.from_numpy(np.ones((4, 8), np.float32), 0)   # card 0
    w = kfunca.from_numpy(np.ones((8, 2), np.float32), 0).set_requires_grad(True)
    y = kfunca.gemm(x, w).relu().sum(0)
    y.backward(kfunca.from_numpy(np.ones((1, 2), np.float32), 0))
    print(w.grad().numpy())

Also ported: the single-chip paged-KV serving path (models/serve.
InferenceServer: fused or split page pools, fp or int8 KV, int8/int4
weight-quantized decode, prefix caching; models/generate.py) with its
paged decode attention kernels (csrc/paged_attention.cu) and its int8
matmul kernel (ops/quant.py, csrc/quant.cu), and the training path
(models/train.make_train_step, models/trainer.Trainer, the losses, data,
eval and checkpoints) with the flash attention forward and backward
kernels (csrc/flash_attention.cu).

Entry points run on the CUDA device unless the caller passes
device="cpu"; on CPU tensors each kernel wrapper runs its plain PyTorch
version.
"""

from .core.dtype import ScalarType
from .core.dtype import ScalarType as dtype  # kfunca.dtype enum alias
from .core.tensor import (
    GradFunction,
    Tensor,
    Tensor as tensor,
    empty,
    empty_like,
    empty_strided,
    from_numpy,
    from_storage_numpy,
    from_torch,
    to_numpy,
    zeros,
)
from .ops.attention import causal_attention
from .ops.gemm import gemm
from .ops.quant import gemm_w8, quantize_cols
from .ops.shape_ops import concat as cat
from .runtime.allocator import memstat
from .runtime.autotune import autotune
from .runtime.launcher import Launcher
from .utils.compare import all_close, max_diff
from .utils.device_info import device_info

launcher = Launcher.instance()
set_device = launcher.set_device
device_count = launcher.device_count

# dtype enum values exported at module level (pybind export_values analog).
for _name, _member in {
    "bool": ScalarType.Bool,
    "byte": ScalarType.Byte,
    "char": ScalarType.Char,
    "short": ScalarType.Short,
    "int": ScalarType.Int,
    "long": ScalarType.Long,
    "half": ScalarType.Half,
    "bfloat16": ScalarType.BFloat16,
    "float": ScalarType.Float,
    "double": ScalarType.Double,
}.items():
    globals()[_name] = _member

__version__ = "0.1.0"

__all__ = [
    "ScalarType",
    "dtype",
    "Tensor",
    "tensor",
    "GradFunction",
    "empty",
    "empty_like",
    "empty_strided",
    "zeros",
    "from_numpy",
    "to_numpy",
    "cat",
    "gemm",
    "gemm_w8",
    "quantize_cols",
    "causal_attention",
    "device_info",
    "memstat",
    "autotune",
    "Launcher",
    "launcher",
    "set_device",
    "device_count",
    "all_close",
    "max_diff",
]
