"""Build the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``strugatzki_tpu_torch/_build/`` under a name keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time, and a failed
build raises: there is no other path to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "load", "BUILD_DIR", "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: no --use_fast_math: divisions stay IEEE so x/0 keeps its inf/NaN
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: name → {"seconds": build time (0.0 when reused), "log": nvcc's output}
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard location
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless an up-to-date build exists, and load
    it.  Thread-safe; the loaded library is cached for the process."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            key = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
        info = {"seconds": 0.0, "log": ""}
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {r.returncode}):\n"
                    f"{r.stdout}{r.stderr}")
            os.replace(tmp, so)
            info = {"seconds": time.perf_counter() - t0,
                    "log": r.stdout + r.stderr}
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        build_info[name] = info
        return lib
