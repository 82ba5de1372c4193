"""Build and load the port's native host core (csrc/core.cpp).

Counterpart of kfunca_tpu/runtime/_native.py.  g++ compiles csrc/core.cpp
into `build/libcore-<hash>.so` (the hash covers the source and the flags,
as runtime/_kernels.py keys the CUDA sources) at the first `get_lib()`,
never at import; the library has a plain C interface bound with ctypes.
Each build writes a temporary file of its own and renames it into place,
so processes that build at once (test workers) do not race.

`KFUNCA_NO_NATIVE=1` selects the Python forms, as in the JAX package; so
does a machine without g++.  Where g++ is present a failed build raises:
it does not quietly give way to Python.  The callers (core/iterator,
core/materialize, core/tensor, models/serve, models/tokenizer) read
`get_lib()` and run their Python form when it is None;
tests/test_torch_native_core.py and tests/test_torch_tokenizer.py hold the
two forms together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid

from ._kernels import BUILD, CSRC

SRC = CSRC / "core.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")

_lib = None
_loaded = False
_lock = threading.Lock()


def library_path():
    """Where csrc/core.cpp builds to under the current source and flags."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"libcore-{digest}.so"


def build(cxx: str):
    """Compile csrc/core.cpp with `cxx` unless its library exists; returns
    the library's path.  Raises RuntimeError with the compiler's output."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SRC.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i8, i32, i64 = ctypes.c_int8, ctypes.c_int, ctypes.c_int64
    u64 = ctypes.c_uint64
    i64p, u64p = ctypes.POINTER(i64), ctypes.POINTER(u64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "kf_promote": (i8, [i8, i8]),
        "kf_accumulate_type": (i8, [i8]),
        "kf_broadcast_shapes": (i32, [i32, i64p, i64p, i64p, i64p]),
        "kf_plan_loop_nest": (i32, [i32, i64, i64p, i64p, i64p, i64p, i64p,
                                    i64p]),
        "kf_tape_schedule": (i32, [i64, i64, i64p, i64p, i64, i64p]),
        "kf_page_pool_create": (i64, [i64]),
        "kf_page_alloc": (i64, [i64, i64, i64p]),
        "kf_page_free": (i64, [i64, i64, i64p]),
        "kf_page_pool_available": (i64, [i64]),
        "kf_queue_create": (i64, []),
        "kf_queue_push": (i64, [i64, i64]),
        "kf_queue_pop": (i64, [i64]),
        "kf_queue_size": (i64, [i64]),
        "kf_pcache_create": (i64, []),
        "kf_pcache_destroy": (None, [i64]),
        "kf_pcache_hash_chain": (i64, [i32p, i64, i64, i64, u64p]),
        "kf_pcache_get": (i64, [i64, u64, u64]),
        "kf_pcache_touch": (i64, [i64, u64, u64]),
        "kf_pcache_put": (i64, [i64, u64, u64, i64]),
        "kf_pcache_erase": (i64, [i64, u64, u64]),
        "kf_pcache_size": (i64, [i64]),
        "kf_pcache_lru": (i64, [i64, u64p, i64p, i64]),
        "kf_bpe_create": (i64, []),
        "kf_bpe_destroy": (None, [i64]),
        "kf_bpe_add_merge": (i64, [i64, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32]),
        "kf_bpe_encode": (i64, [i64, u8p, i64, i32p]),
        "kf_bpe_decode": (i64, [i64, i32p, i64, u8p, i64]),
        "kf_bpe_vocab_size": (i64, [i64]),
        "kf_zstd_decompress": (i64, [ctypes.c_void_p, i64, ctypes.c_void_p,
                                     i64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib():
    """The native core, built on first use; None under KFUNCA_NO_NATIVE=1
    or where there is no g++ (the callers then run their Python forms)."""
    global _lib, _loaded
    if os.environ.get("KFUNCA_NO_NATIVE", "0") == "1":
        return None
    if _loaded:
        return _lib
    with _lock:
        if not _loaded:
            cxx = shutil.which("g++")
            if cxx is not None:
                _lib = _bind(ctypes.CDLL(str(build(cxx))))
            _loaded = True
    return _lib


def i64_array(values):
    return (ctypes.c_int64 * len(values))(*values)
