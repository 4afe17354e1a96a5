"""ctypes bindings for the native sample codec (native/codec.cpp).

Auto-builds ``libstrugatzki_codec.so`` on first use if a toolchain is
available; otherwise the NumPy fallback paths in ``audiofile.py`` are used.
Set ``STRUGATZKI_NO_NATIVE=1`` to force the fallback.

The library is built with ``native/Makefile``'s own rule under a name of
this process's and renamed into place, so a concurrent build by another
process (or by the ``strugatzki_tpu`` package's copy of this module) never
leaves a half-written library where a loader can find it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["lib", "decode", "encode", "fix_nans", "FMT_CODES"]

FMT_CODES = {"int16": 2, "int24": 3, "int32": 4, "float": 5, "double": 6}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


def lib() -> Optional[ctypes.CDLL]:
    """The loaded codec library, building it if necessary; None if
    unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        try:
            _lib = _load()
        finally:
            # only now: concurrent callers short-circuit to None while the
            # build is in flight otherwise, silently taking the numpy path
            # for the whole (up to 120 s) make window
            _tried = True
        return _lib


def _build(so: str) -> bool:
    """Build the library with the Makefile's recipe under a temporary name
    and rename it to ``so``; False if the build failed."""
    tmp = f"libstrugatzki_codec.so.{os.getpid()}.tmp"
    rule = f"{tmp}: codec.cpp\n\t$(CXX) $(CXXFLAGS) $(SOFLAGS) -o $@ $<"
    try:
        subprocess.run(["make", "-C", _native_dir(), f"--eval={rule}", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(_native_dir(), tmp), so)
        return True
    except Exception:
        try:
            os.unlink(os.path.join(_native_dir(), tmp))
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("STRUGATZKI_NO_NATIVE"):
        return None
    so = os.path.join(_native_dir(), "libstrugatzki_codec.so")
    src = os.path.join(_native_dir(), "codec.cpp")
    stale = (not os.path.exists(so)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(so)))
    # a stale .so must NOT be used when its required rebuild failed — the
    # numpy fallback is the correct path then
    if stale and not _build(so):
        return None
    try:
        l = ctypes.CDLL(so)
    except OSError:
        # another process may still be writing it in place (the JAX
        # package's copy of this module builds without a rename): load a
        # build of our own
        if not os.path.exists(src) or not _build(so):
            return None
        try:
            l = ctypes.CDLL(so)
        except OSError:
            return None
    return _bind(l)


def _bind(l: ctypes.CDLL) -> ctypes.CDLL:
    l.strug_decode.restype = ctypes.c_int
    l.strug_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    l.strug_encode.restype = ctypes.c_int
    l.strug_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    l.strug_fix_nans.restype = ctypes.c_int
    l.strug_fix_nans.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64]
    return l


def decode(raw: bytes, frames: int, channels: int, fmt: str,
           big_endian: bool) -> Optional[np.ndarray]:
    """raw interleaved bytes → planar float32 [channels, frames];
    None if the native library is unavailable."""
    l = lib()
    if l is None or fmt not in FMT_CODES:
        return None
    bps = {"int16": 2, "int24": 3, "int32": 4, "float": 4, "double": 8}[fmt]
    if len(raw) < frames * channels * bps:
        # never hand native code a frame count the buffer can't back
        return None
    out = np.empty((channels, frames), dtype=np.float32)
    rc = l.strug_decode(
        raw, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, FMT_CODES[fmt], int(big_endian))
    return out if rc == 0 else None


def encode(data: np.ndarray, fmt: str, big_endian: bool) -> Optional[bytes]:
    """planar float32 [channels, frames] → interleaved bytes."""
    l = lib()
    if l is None or fmt not in FMT_CODES:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    channels, frames = data.shape
    bps = {"int16": 2, "int24": 3, "int32": 4, "float": 4, "double": 8}[fmt]
    buf = ctypes.create_string_buffer(frames * channels * bps)
    rc = l.strug_encode(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf,
        frames, channels, FMT_CODES[fmt], int(big_endian))
    return buf.raw if rc == 0 else None


def fix_nans(data: np.ndarray, chunk: int = 1024) -> bool:
    """In-place NaN forward-fill with per-chunk reset; False if unavailable
    (the caller must then use a fallback).  The array must be C-contiguous
    float32 — anything else returns False rather than silently fixing a
    private copy."""
    l = lib()
    if l is None or chunk <= 0:
        return False
    if (data.dtype != np.float32 or data.ndim != 2
            or not data.flags["C_CONTIGUOUS"]):
        return False
    channels, frames = data.shape
    rc = l.strug_fix_nans(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, chunk)
    return rc == 0
