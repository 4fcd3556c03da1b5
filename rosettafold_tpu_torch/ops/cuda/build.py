"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first use by
`nvcc -gencode arch=compute_90a,code=sm_90a` into `csrc/build/lib<name>.so`,
which is loaded with ctypes. A library older than its source or than a header
of `csrc/` is rebuilt. `build_all` starts one nvcc per source at once. Only
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


def _stale(name: str) -> bool:
    lib_path = BUILD_DIR / f"lib{name}.so"
    if not lib_path.exists():
        return True
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib_path.stat().st_mtime < newest


def _start(name: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = CSRC / f"{name}.cu"
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", "-I", str(CSRC),
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, proc, tmp, t0):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {CSRC / (name + '.cu')}:\n{out}")
    os.replace(tmp, BUILD_DIR / f"lib{name}.so")
    build_log[name] = (time.perf_counter() - t0, out)


def build_all(names) -> None:
    """Compile every stale library of `names` with one nvcc each, all at once."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs and _stale(n)}
        errors = []
        for n, job in started.items():
            try:
                _finish(n, *job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing or stale, and load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
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


def stream_of(t) -> int:
    """The current CUDA stream of t's device as an address: PyTorch's raw
    stream query (a Stream object costs ~5 us a call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
