"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use by
`nvcc -gencode arch=compute_90a,code=sm_90a` into `csrc/build/lib<name>.so`,
which is loaded with ctypes. A library older than its source is rebuilt. Only
the repository's own sources go into the build: no kernel library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # name -> (seconds, compiler output) of builds in this process


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set NVCC or put the CUDA toolkit on PATH")


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing or stale, and load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        lib_path = BUILD_DIR / f"lib{name}.so"
        if not lib_path.exists() or lib_path.stat().st_mtime < src.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                   "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, lib_path)
            build_log[name] = (time.perf_counter() - t0, res.stdout + res.stderr)
        lib = ctypes.CDLL(str(lib_path))
        lib.last_error_string.restype = ctypes.c_char_p
        lib.last_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        msg = lib.last_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
