"""Minimal AIFF codec of the benchmark's own: 16-bit PCM AIFF (the input
sounds) and float32 AIFC (``fl32``, the feature files the reference
extracts) out, both in.  Kept apart from the program's codec so that what
the program wrote is read back by code it does not share."""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_pcm16", "write_fl32", "read"]


def _f80(value: float) -> bytes:
    """A positive sample rate as an 80-bit extended float."""
    mant, exp = np.frexp(float(value))
    return struct.pack(">HQ", int(exp) + 16382, int(mant * (1 << 64)))


def _from_f80(raw: bytes) -> float:
    se, mant = struct.unpack(">HQ", raw)
    if se & 0x7FFF == 0 and mant == 0:
        return 0.0
    sign = -1.0 if se & 0x8000 else 1.0
    return sign * float(mant) * 2.0 ** ((se & 0x7FFF) - 16383 - 63)


def write_pcm16(path: str, samples: np.ndarray, rate: float) -> None:
    """One channel of int16 ``samples`` as an AIFF file."""
    data = np.asarray(samples, dtype=">i2").tobytes()
    comm = struct.pack(">hIh", 1, len(samples), 16) + _f80(rate)
    ssnd = struct.pack(">II", 0, 0) + data
    body = (struct.pack(">4sI", b"COMM", len(comm)) + comm
            + struct.pack(">4sI", b"SSND", len(ssnd)) + ssnd)
    if len(ssnd) & 1:
        body += b"\0"
    with open(path, "wb") as f:
        f.write(struct.pack(">4sI4s", b"FORM", 4 + len(body), b"AIFF") + body)


def _chunk(cid: bytes, body: bytes) -> bytes:
    return struct.pack(">4sI", cid, len(body)) + body + b"\0" * (len(body) & 1)


def write_fl32(path: str, data: np.ndarray, rate: float) -> None:
    """``data [channels, frames]`` as a float32 AIFC (``fl32``) file."""
    data = np.asarray(data, np.float32)
    channels, frames = data.shape
    name = b"\x0bFloat 32bit"   # pascal string, even length with its count
    comm = (struct.pack(">hIh", channels, frames, 32) + _f80(rate)
            + b"fl32" + name)
    ssnd = struct.pack(">II", 0, 0) + data.T.astype(">f4").tobytes()
    body = (_chunk(b"FVER", struct.pack(">I", 0xA2805140))
            + _chunk(b"COMM", comm) + _chunk(b"SSND", ssnd))
    with open(path, "wb") as f:
        f.write(struct.pack(">4sI4s", b"FORM", 4 + len(body), b"AIFC") + body)


def read(path: str):
    """``(data [channels, frames], rate)``: float32 samples of an AIFC
    ``fl32`` file, or int16 samples of a 16-bit PCM AIFF file."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"FORM" or raw[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not an AIFF file")
    pos, comm, ssnd = 12, None, None
    while pos + 8 <= len(raw):
        cid, size = struct.unpack(">4sI", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise ValueError(f"{path}: no COMM or SSND chunk")
    channels, frames, bits = struct.unpack(">hIh", comm[:8])
    rate = _from_f80(comm[8:18])
    comp = comm[18:22] if raw[8:12] == b"AIFC" else b"NONE"
    if comp == b"fl32" and bits == 32:
        dtype = ">f4"
    elif comp == b"NONE" and bits == 16:
        dtype = ">i2"
    else:
        raise ValueError(f"{path}: unsupported format {comp!r} {bits} bits")
    offset = struct.unpack(">I", ssnd[:4])[0]
    n = channels * frames
    data = np.frombuffer(ssnd, dtype=dtype, count=n, offset=8 + offset)
    return data.reshape(frames, channels).T.astype(dtype[1:]), rate
