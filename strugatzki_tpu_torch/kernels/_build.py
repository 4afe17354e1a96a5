"""Build the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lands in ``strugatzki_tpu_torch/_build/`` under a name keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time, and a failed
build raises: there is no other path to fall back to.  The kernel wrappers
also share what a launch needs here: the check of each tensor argument,
ctypes arrays of pointers and ints, and the error a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["NVCC_FLAGS", "load", "BUILD_DIR", "build_info", "check",
           "raise_on", "pointers", "ints"]

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


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          device: torch.device, shape) -> None:
    """Raise ``ValueError`` unless kernel argument ``name`` is a contiguous
    tensor of ``dtype`` and ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, error_string, what: str, plan=None) -> None:
    """Raise ``RuntimeError`` for a non-zero launch code ``err``: ``"<what>
    (<plan>) failed: "`` and the library's message, ``error_string(err)``
    (its ``<name>_error_string``)."""
    if err != 0:
        where = what if plan is None else f"{what} ({plan})"
        raise RuntimeError(f"{where} failed: " + error_string(err).decode())


def pointers(ptrs) -> ctypes.Array:
    """A ``void*`` array of device pointers (one slot at least)."""
    ptrs = list(ptrs)
    return (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)


def ints(vals) -> ctypes.Array:
    """An ``int`` array (one slot at least)."""
    vals = list(vals)
    return (ctypes.c_int * max(1, len(vals)))(*vals)
