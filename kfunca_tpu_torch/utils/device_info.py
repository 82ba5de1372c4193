"""device_info(): device properties + built-in microbenchmarks.

Counterpart of kfunca_tpu/utils/device_info.py (the reference's
device_info.cu:135-216): prints the card's properties, then MEASURES its
memory bandwidth with a copy of a large buffer and its bf16 matmul rate,
both timed with CUDA events.  Without a card it raises unless asked for
the CPU, where the same loops run on the host clock and are labelled as
the CPU's.
"""

from __future__ import annotations

import torch

from ..runtime.backend import resolve_device
from .profiling import time_fn

# NVIDIA's H100 SXM data sheet (dense) for roofline context
H100_PEAKS = (989, 3350)  # bf16 TFLOP/s, HBM GB/s


def copy_bandwidth_gbps(nbytes: int = 1 << 30, device=None) -> float:
    """Copy benchmark (reference test_threads_copy, device_info.cu:37-86):
    read + write bytes over the best time of one copy."""
    dev = resolve_device(device)
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    src.fill_(1.0)
    dt = time_fn(dst.copy_, src, iters=5, warmup=2)
    return 2 * nbytes / dt / 1e9


def matmul_tflops(m: int = 8192, dtype=torch.bfloat16, device=None) -> float:
    """Matmul throughput (reference fmad_loop, device_info.cu:88-129)."""
    dev = resolve_device(device)
    a = torch.ones((m, m), dtype=dtype, device=dev)
    b = torch.ones((m, m), dtype=dtype, device=dev)
    dt = time_fn(torch.mm, a, b, iters=5, warmup=2)
    return 2 * m * m * m / dt / 1e12


def device_info(run_benchmarks: bool = True, device=None) -> None:
    dev = resolve_device(device)
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            print(f"=== device {i} ===")
            print("platform      : gpu")
            print(f"device_kind   : {p.name}")
            print(f"sm count      : {p.multi_processor_count}")
            print(f"hbm bytes     : {p.total_memory}")
            print(f"hbm in use    : {torch.cuda.memory_allocated(i)}")
            if "H100" in p.name:
                print(f"peak bf16     : {H100_PEAKS[0]} TFLOP/s (data sheet)")
                print(f"peak HBM BW   : {H100_PEAKS[1]} GB/s (data sheet)")
    else:
        print("=== device cpu ===")
        print("platform      : cpu")
    if run_benchmarks:
        small = dev.type == "cpu"
        where = "cpu" if small else torch.cuda.get_device_name(dev)
        bw = copy_bandwidth_gbps(1 << (24 if small else 30), dev)
        print(f"measured copy bandwidth : {bw:.1f} GB/s ({where})")
        tf = matmul_tflops(512 if small else 8192, torch.bfloat16, dev)
        print(f"measured bf16 matmul    : {tf:.2f} TFLOP/s ({where})")
