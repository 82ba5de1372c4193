"""Device resolution: the CUDA card by default, the CPU only when asked.

Counterpart of kfunca_tpu/runtime/backend.py.  The JAX package picks its
engine from the default backend; the port instead resolves an explicit
`torch.device` at every entry point.  There is no silent CPU fallback: an
entry point called without a device on a machine with no CUDA device
raises, and the CPU path runs only for callers (the tests) that pass
device="cpu".  Kernel wrappers dispatch on the device of the tensors they
are given (ops/pallas_kernels/*), so a CPU tensor runs the plain PyTorch
version and a CUDA tensor runs the hand-written kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present.  Selecting CUDA also pins the matmul
    precision to the JAX package's: fp32 at full fp32 (Precision.HIGHEST;
    TF32 would keep only ~3 decimal digits), and bf16 / fp16 products summed
    in fp32 (preferred_element_type=float32), never in reduced precision."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def sync(device=None) -> None:
    """Block until queued device work finishes (no-op on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
