"""What the runnable examples share: the --device flag, the activation
dtype rule, the card line and the kernel launch counters they print.

Every example runs on the CUDA card unless `--device cpu` is given (the
plain PyTorch path, for the tests); without a card the default raises."""

from __future__ import annotations

import shutil
import subprocess
import time

import torch

from ..ops import quant
from ..ops.pallas_kernels import flash_attention, paged_attention
from ..runtime.backend import resolve_device, sync


def add_device_flag(parser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="cuda (the default: the card; raises without one) or cpu (the "
             "plain PyTorch path)")


def device(args) -> torch.device:
    return resolve_device(args.device)


def card_dtype(dev: torch.device) -> str:
    """bf16 activations on the card, fp32 elsewhere: the JAX examples'
    rule, with the card where they name a TPU."""
    return "bfloat16" if dev.type == "cuda" else "float32"


def now(dev: torch.device) -> float:
    """The host clock after the device's queued work has finished."""
    sync(dev)
    return time.perf_counter()


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (the name
    alone where nvidia-smi is missing), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev)


# (label, wrapper, counter): every wrapper of a kernel an example reaches
# adds one to its counter where it launches its kernel
COUNTERS = (
    ("K1", flash_attention.flash_attention_fwd_stats, "launches"),
    ("K1 wgmma", flash_attention.flash_attention_fwd_stats, "launches_wgmma"),
    ("K2", flash_attention.flash_attention_backward, "launches"),
    ("K2 wgmma", flash_attention.flash_attention_backward, "launches_wgmma"),
    ("K4", paged_attention.paged_decode_attention_dma, "launches"),
    ("K6", paged_attention.paged_decode_attention, "launches"),
    ("K5", quant.matmul_q8, "launches"),
)


def counts() -> dict:
    return {label: getattr(fn, name) for label, fn, name in COUNTERS}


class Launches:
    """The kernel launches made since it was made: read() gives each
    counter's difference."""

    def __init__(self):
        self.start = counts()

    def read(self) -> dict:
        return {k: v - self.start[k] for k, v in counts().items()}


def launch_line(launches: dict) -> str:
    shown = {k: v for k, v in launches.items() if v}
    if not shown:
        return "kernel launches: none"
    return "kernel launches: " + ", ".join(f"{k} {v}" for k, v in
                                           shown.items())
