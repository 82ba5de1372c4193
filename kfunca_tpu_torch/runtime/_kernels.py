"""Build and load the port's CUDA kernels (role of kfunca_tpu/runtime/_native.py).

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into
`build/lib<name>-<hash>.so`, a shared library with a plain C interface
that the kernel wrappers call through ctypes.  The hash covers the source
and the compiler flags, so an edited source is rebuilt on its next use and
a stale library is never loaded.  Nothing is compiled at import: the first
wrapper call on a CUDA tensor builds what it needs.  A failed build raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()

# argument types of the kernels' C entry points
VP, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (default /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to under the current source and flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile each named source (default: every csrc/*.cu) whose library
    is missing, one nvcc process per source, all started together.

    Returns {name: seconds} for the sources compiled by this call.  The
    compiler's register and spill report is kept beside each library as
    `<library>.log`.  Raises RuntimeError with nvcc's output on failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            nvcc = nvcc or nvcc_path()
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        took = {}
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu:\n{out}")
            so.with_name(so.name + ".log").write_text(out)
            os.replace(tmp, so)
            took[name] = time.perf_counter() - t0
        return took
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) for `name`."""
    so = library_path(name)
    log = so.with_name(so.name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> object:
    """The C entry point `symbol` of `csrc/<name>.cu`, its argument types
    set once, when it is first looked up; every entry point returns a CUDA
    error code (0 on success)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn
