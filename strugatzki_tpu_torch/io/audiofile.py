"""Audio file I/O.

From-scratch codecs for the containers the reference framework touches via
``de.sciss.synth.io.AudioFile`` and libsndfile-inside-scsynth (SURVEY §2.2):

* **AIFF / AIFC** — feature files are float32 AIFC (``fl32``) at the feature
  rate with ``numCoeffs + 1`` channels (reference NonRealtimeProcessor.scala:164),
  and the normalization file ``feat_norms.aif`` is the same format with 2
  frames (Strugatzki.scala:417-429).  PCM 8/16/24/32 and fl64 are also read
  (input audio).
* **WAV** — PCM and IEEE-float input audio, plus cross-similarity output.
* **IRCAM** — float trace temp files (reference IOUtil.scala:21-26) and
  selectable output container.
* **NeXT/AU, RAW** — remaining writable cross-similarity containers
  (CrossSimilarity.scala:128).

Data is exchanged as float32 arrays shaped ``[channels, frames]`` (the
reference's ``Array[Array[Float]]`` frame-buffer layout).  Integer PCM maps to
``[-1, 1)`` via division by ``2**(bits-1)``, matching synth.io.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from . import native as _native
from .formats import (AIFF, IRCAM, NEXT, RAW, WAVE, WAVE64, AudioFileType,
                      SampleFormat)

__all__ = ["AudioFileSpec", "read", "read_spec", "write", "AudioFileReader",
           "AudioFileWriter", "open_read", "open_write", "feature_spec"]


@dataclass(frozen=True)
class AudioFileSpec:
    """Container + encoding + shape of an audio file (cf. synth.io AudioFileSpec)."""

    file_type: AudioFileType = AIFF
    sample_format: str = SampleFormat.FLOAT
    num_channels: int = 1
    sample_rate: float = 44100.0
    num_frames: int = 0


def feature_spec(num_features: int, feature_rate: float,
                 num_frames: int = 0) -> AudioFileSpec:
    """Spec of a feature file: float32 AIFC, one channel per feature
    (reference NonRealtimeProcessor.scala:164)."""
    return AudioFileSpec(AIFF, SampleFormat.FLOAT, num_features, feature_rate,
                         num_frames)


# ---------------------------------------------------------------------------
# 80-bit extended float (AIFF sample rate encoding)
# ---------------------------------------------------------------------------

def _encode_f80(value: float) -> bytes:
    if value == 0.0:
        return b"\x00" * 10
    sign = 0
    if value < 0:
        sign = 0x8000
        value = -value
    mant, exp = np.frexp(value)
    # mant in [0.5, 1); extended float wants explicit leading 1 bit
    exp = int(exp) + 16382
    mant_bits = int(mant * (1 << 64))
    return struct.pack(">HQ", sign | exp, mant_bits)


def _decode_f80(raw: bytes) -> float:
    se, mant = struct.unpack(">HQ", raw)
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


# ---------------------------------------------------------------------------
# sample codecs
# ---------------------------------------------------------------------------

_PCM_FORMATS = {
    "int8": 1,
    "uint8": 1,
    SampleFormat.INT16: 2,
    SampleFormat.INT24: 3,
    SampleFormat.INT32: 4,
    SampleFormat.FLOAT: 4,
    SampleFormat.DOUBLE: 8,
}


#: header bit depths of the writable formats (single source for every
#: container writer)
_BITS = {SampleFormat.INT16: 16, SampleFormat.INT24: 24,
         SampleFormat.INT32: 32, SampleFormat.FLOAT: 32,
         SampleFormat.DOUBLE: 64}


def _bytes_per_sample(fmt: str) -> int:
    return _PCM_FORMATS[fmt]


def _decode_samples(raw: bytes, fmt: str, big_endian: bool) -> np.ndarray:
    bo = ">" if big_endian else "<"
    if fmt == SampleFormat.FLOAT:
        return np.frombuffer(raw, dtype=f"{bo}f4").astype(np.float32)
    if fmt == SampleFormat.DOUBLE:
        return np.frombuffer(raw, dtype=f"{bo}f8").astype(np.float32)
    if fmt == SampleFormat.INT16:
        return (np.frombuffer(raw, dtype=f"{bo}i2").astype(np.float32)
                / 32768.0).astype(np.float32)
    if fmt == SampleFormat.INT32:
        return (np.frombuffer(raw, dtype=f"{bo}i4").astype(np.float64)
                / 2147483648.0).astype(np.float32)
    if fmt == SampleFormat.INT24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        if big_endian:
            val = (b[:, 0].astype(np.int32) << 16) | (b[:, 1].astype(np.int32) << 8) \
                  | b[:, 2].astype(np.int32)
        else:
            val = (b[:, 2].astype(np.int32) << 16) | (b[:, 1].astype(np.int32) << 8) \
                  | b[:, 0].astype(np.int32)
        val = np.where(val >= (1 << 23), val - (1 << 24), val)
        return (val.astype(np.float32) / 8388608.0).astype(np.float32)
    if fmt == "int8":
        return (np.frombuffer(raw, dtype=np.int8).astype(np.float32)
                / 128.0).astype(np.float32)
    if fmt == "uint8":
        return ((np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0)
                / 128.0).astype(np.float32)
    raise ValueError(f"unsupported sample format {fmt!r}")


def _encode_samples(data: np.ndarray, fmt: str, big_endian: bool) -> bytes:
    bo = ">" if big_endian else "<"
    flat = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
    if fmt == SampleFormat.FLOAT:
        return flat.astype(f"{bo}f4").tobytes()
    if fmt == SampleFormat.DOUBLE:
        return flat.astype(f"{bo}f8").tobytes()
    if fmt == SampleFormat.INT16:
        q = np.clip(np.round(flat * 32768.0), -32768, 32767).astype(f"{bo}i2")
        return q.tobytes()
    if fmt == SampleFormat.INT32:
        q = np.clip(np.round(flat.astype(np.float64) * 2147483648.0),
                    -2147483648, 2147483647).astype(f"{bo}i4")
        return q.tobytes()
    if fmt == SampleFormat.INT24:
        q = np.clip(np.round(flat.astype(np.float64) * 8388608.0),
                    -8388608, 8388607).astype(np.int32)
        q = np.where(q < 0, q + (1 << 24), q).astype(np.uint32)
        out = np.empty((q.size, 3), dtype=np.uint8)
        if big_endian:
            out[:, 0] = (q >> 16) & 0xFF
            out[:, 1] = (q >> 8) & 0xFF
            out[:, 2] = q & 0xFF
        else:
            out[:, 2] = (q >> 16) & 0xFF
            out[:, 1] = (q >> 8) & 0xFF
            out[:, 0] = q & 0xFF
        return out.tobytes()
    raise ValueError(f"unsupported sample format {fmt!r}")


# ---------------------------------------------------------------------------
# container parsing
# ---------------------------------------------------------------------------

@dataclass
class _Layout:
    spec: AudioFileSpec
    data_offset: int
    big_endian: bool


def _parse_aiff(f) -> _Layout:
    header = f.read(12)
    if header[:4] != b"FORM" or header[8:12] not in (b"AIFF", b"AIFC"):
        raise IOError("not an AIFF/AIFC file")
    is_aifc = header[8:12] == b"AIFC"
    num_channels = num_frames = None
    sample_rate = 44100.0
    fmt = None
    data_offset = None
    big_endian = True
    while True:
        chunk_hdr = f.read(8)
        if len(chunk_hdr) < 8:
            break
        cid, size = struct.unpack(">4sI", chunk_hdr)
        pos = f.tell()
        if cid == b"COMM":
            # parse at most the fields we use — a corrupt 4 GB declared
            # size must not drive a 4 GB allocation (fuzz-pinned)
            body = f.read(min(size, 64))
            num_channels, num_frames, bits = struct.unpack(">hIh", body[:8])
            sample_rate = _decode_f80(body[8:18])
            if is_aifc and size >= 22:
                comp = body[18:22]
                if comp in (b"fl32", b"FL32"):
                    fmt = SampleFormat.FLOAT
                elif comp in (b"fl64", b"FL64"):
                    fmt = SampleFormat.DOUBLE
                elif comp in (b"NONE", b"sowt", b"twos", b"in16", b"in24", b"in32"):
                    fmt = {8: "int8", 16: SampleFormat.INT16, 24: SampleFormat.INT24,
                           32: SampleFormat.INT32}[bits]
                    # 'sowt' is byte-swapped (little-endian) PCM — the
                    # CoreAudio default for AIFF-C int16
                    big_endian = comp != b"sowt"
                else:
                    raise IOError(f"unsupported AIFC compression {comp!r}")
            else:
                fmt = {8: "int8", 16: SampleFormat.INT16, 24: SampleFormat.INT24,
                       32: SampleFormat.INT32}[bits]
        elif cid == b"SSND":
            off, _blk = struct.unpack(">II", f.read(8))
            data_offset = pos + 8 + off
        f.seek(pos + size + (size & 1))
    if num_channels is None or data_offset is None or fmt is None:
        raise IOError("incomplete AIFF file")
    spec = AudioFileSpec(AIFF, fmt, num_channels, sample_rate, num_frames)
    return _Layout(spec, data_offset, big_endian=big_endian)


def _parse_wav(f) -> _Layout:
    header = f.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise IOError("not a WAV file")
    fmt = None
    num_channels = sample_rate = None
    bits = None
    data_offset = data_size = None
    wformat = None
    while True:
        chunk_hdr = f.read(8)
        if len(chunk_hdr) < 8:
            break
        cid, size = struct.unpack("<4sI", chunk_hdr)
        pos = f.tell()
        if cid == b"fmt ":
            body = f.read(min(size, 64))   # bound alloc on corrupt sizes
            wformat, num_channels, sample_rate, _br, _ba, bits = \
                struct.unpack("<HHIIHH", body[:16])
            if wformat == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                wformat = struct.unpack("<H", body[24:26])[0]
        elif cid == b"data":
            data_offset = pos
            data_size = size
        f.seek(pos + size + (size & 1))
    if wformat is None or data_offset is None:
        raise IOError("incomplete WAV file")
    if wformat == 1:
        fmt = {8: "uint8", 16: SampleFormat.INT16, 24: SampleFormat.INT24,
               32: SampleFormat.INT32}[bits]
    elif wformat == 3:
        fmt = SampleFormat.FLOAT if bits == 32 else SampleFormat.DOUBLE
    else:
        raise IOError(f"unsupported WAV format tag {wformat}")
    bps = 1 if bits == 8 else _bytes_per_sample(fmt)
    num_frames = data_size // (bps * num_channels)
    spec = AudioFileSpec(WAVE, fmt, num_channels, float(sample_rate), num_frames)
    return _Layout(spec, data_offset, big_endian=False)


_IRCAM_MAGICS = {
    b"\x64\xa3\x01\x00": "<",  # VAX little endian
    b"\x64\xa3\x02\x00": ">",  # Sun big endian
    b"\x64\xa3\x03\x00": "<",  # MIPS little endian
    b"\x64\xa3\x04\x00": ">",  # NeXT big endian
    b"\x00\x01\xa3\x64": ">",
    b"\x00\x02\xa3\x64": "<",
}


def _parse_ircam(f, file_size: int) -> _Layout:
    magic = f.read(4)
    try:
        bo = _IRCAM_MAGICS[magic]
    except KeyError:
        raise IOError("not an IRCAM file") from None
    sample_rate, num_channels, code = struct.unpack(f"{bo}fii", f.read(12))
    fmt = {2: SampleFormat.INT16, 3: SampleFormat.INT24, 0x40004: SampleFormat.INT32,
           4: SampleFormat.FLOAT, 8: SampleFormat.DOUBLE}.get(code)
    if fmt is None:
        raise IOError(f"unsupported IRCAM sample code {code}")
    data_offset = 1024
    bps = _bytes_per_sample(fmt)
    num_frames = (file_size - data_offset) // (bps * num_channels)
    spec = AudioFileSpec(IRCAM, fmt, num_channels, float(sample_rate), num_frames)
    return _Layout(spec, data_offset, big_endian=(bo == ">"))


def _parse_au(f, file_size: int) -> _Layout:
    magic = f.read(4)
    if magic != b".snd":
        raise IOError("not an AU file")
    data_offset, data_size, enc, sample_rate, num_channels = \
        struct.unpack(">IIIII", f.read(20))
    fmt = {2: "int8", 3: SampleFormat.INT16, 4: SampleFormat.INT24,
           5: SampleFormat.INT32, 6: SampleFormat.FLOAT,
           7: SampleFormat.DOUBLE}.get(enc)
    if fmt is None:
        raise IOError(f"unsupported AU encoding {enc}")
    if data_size in (0xFFFFFFFF, 0):
        data_size = file_size - data_offset
    bps = _bytes_per_sample(fmt)
    num_frames = data_size // (bps * num_channels)
    spec = AudioFileSpec(NEXT, fmt, num_channels, float(sample_rate), num_frames)
    return _Layout(spec, data_offset, big_endian=True)


def _parse_w64(f) -> _Layout:
    """Wave64 (GUID-chunked RIFF variant; sizes include the 24-byte chunk
    header, bodies padded to 8) — mirrors the writer below."""
    f.seek(16)
    (_total,) = struct.unpack("<Q", f.read(8))
    f.read(16)  # wave GUID
    wformat = bits = num_channels = sample_rate = None
    data_offset = data_size = None
    while True:
        head = f.read(24)
        if len(head) < 24:
            break
        guid = head[:16]
        (size,) = struct.unpack("<Q", head[16:24])
        if size < 24:
            # declared size includes this 24-byte header; anything smaller
            # would seek backwards onto the same header and loop forever
            raise IOError(f"corrupt Wave64 chunk: declared size {size} < 24")
        body_size = size - 24
        pos = f.tell()
        if guid[:4] == b"fmt ":
            body = f.read(min(body_size, 64))  # bound alloc on corrupt sizes
            wformat, num_channels, sample_rate, _, _, bits = \
                struct.unpack("<HHIIHH", body[:16])
        elif guid[:4] == b"data":
            data_offset = pos
            data_size = body_size
        f.seek(pos + body_size + ((8 - (size % 8)) % 8))
    if wformat is None or data_offset is None:
        raise IOError("incomplete Wave64 file")
    if wformat == 1:
        fmt = {16: SampleFormat.INT16, 24: SampleFormat.INT24,
               32: SampleFormat.INT32}[bits]
    elif wformat == 3:
        fmt = SampleFormat.FLOAT if bits == 32 else SampleFormat.DOUBLE
    else:
        raise IOError(f"unsupported Wave64 format tag {wformat}")
    num_frames = data_size // (_bytes_per_sample(fmt) * num_channels)
    spec = AudioFileSpec(WAVE64, fmt, num_channels, float(sample_rate),
                         num_frames)
    return _Layout(spec, data_offset, big_endian=False)


_W64_RIFF_GUID = (bytes.fromhex("72696666")
                  + bytes.fromhex("2E91CF11A5D628DB04C10000"))


def _parse(f, path: str) -> _Layout:
    file_size = os.fstat(f.fileno()).st_size
    magic = f.read(16)
    f.seek(0)
    try:
        layout = None
        if magic[:4] == b"FORM":
            layout = _parse_aiff(f)
        elif magic[:4] == b"RIFF":
            layout = _parse_wav(f)
        elif magic == _W64_RIFF_GUID:
            layout = _parse_w64(f)
        elif magic[:4] == b".snd":
            layout = _parse_au(f, file_size)
        elif magic[:4] in _IRCAM_MAGICS:
            layout = _parse_ircam(f, file_size)
    except (struct.error, KeyError, ZeroDivisionError, OverflowError,
            IndexError, ValueError) as e:
        # corrupt or unsupported-variant headers surface uniformly
        # (ValueError covers e.g. a bogus 64-bit Wave64 chunk size blowing
        # past the OS seek-offset range — found by tests/test_audiofile_fuzz)
        raise IOError(f"corrupt audio file {path}: {e!r}") from e
    if layout is None:
        raise IOError(f"unrecognized audio file format: {path}")
    if layout.spec.num_channels < 1:
        raise IOError(f"corrupt audio file {path}: "
                      f"{layout.spec.num_channels} channels")
    if layout.spec.num_frames < 0:
        # a data offset past EOF (truncated IRCAM/AU headers) implies a
        # negative remaining-bytes frame count
        raise IOError(f"corrupt audio file {path}: negative frame count")
    return layout


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class AudioFileReader:
    """Streaming reader with frame-accurate :meth:`seek` (cf. synth.io AudioFile)."""

    def __init__(self, path) -> None:
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        try:
            layout = _parse(self._f, self.path)
        except Exception:
            self._f.close()
            raise
        self.spec = layout.spec
        self._data_offset = layout.data_offset
        self._big_endian = layout.big_endian
        self._frame_bytes = (self.spec.num_channels
                             * _bytes_per_sample(self.spec.sample_format))
        self._position = 0
        self._file_size = os.fstat(self._f.fileno()).st_size
        self._f.seek(self._data_offset)

    # -- iteration ----------------------------------------------------------------

    @property
    def num_frames(self) -> int:
        return self.spec.num_frames

    @property
    def num_channels(self) -> int:
        return self.spec.num_channels

    @property
    def sample_rate(self) -> float:
        return self.spec.sample_rate

    @property
    def position(self) -> int:
        return self._position

    def seek(self, frame: int) -> None:
        self._position = int(frame)
        self._f.seek(self._data_offset + self._position * self._frame_bytes)

    def read_frames(self, num: Optional[int]) -> np.ndarray:
        """Read ``num`` frames (``None`` = to EOF); returns ``[channels, n]``
        float32 (n ≤ num at EOF)."""
        if num is None:
            want = None
        else:
            # bound the request by the bytes actually left in the file: a
            # corrupt header's huge frame count must not drive a huge
            # read-buffer preallocation (fuzz-pinned)
            left = max(0, self._file_size - self._f.tell())
            want = min(max(0, num) * self._frame_bytes, left)
        raw = self._f.read(want)
        n = len(raw) // self._frame_bytes
        raw = raw[: n * self._frame_bytes]
        self._position += n
        out = _native.decode(raw, n, self.spec.num_channels,
                             self.spec.sample_format, self._big_endian)
        if out is not None:
            return out
        flat = _decode_samples(raw, self.spec.sample_format, self._big_endian)
        return flat.reshape(n, self.spec.num_channels).T.copy()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "AudioFileReader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def open_read(path) -> AudioFileReader:
    return AudioFileReader(path)


def read_spec(path) -> AudioFileSpec:
    with AudioFileReader(path) as r:
        return r.spec


def read(path) -> Tuple[np.ndarray, AudioFileSpec]:
    """Read an entire file → (``[channels, frames]`` float32, spec)."""
    with AudioFileReader(path) as r:
        data = r.read_frames(r.num_frames if r.num_frames else None)
        return data, replace(r.spec, num_frames=data.shape[1])


def write(path, data: np.ndarray, spec: AudioFileSpec) -> AudioFileSpec:
    """Write ``data`` (``[channels, frames]``) in the given container/format.

    AIFF + float32 produces an AIFC ``fl32`` file identical in layout to what
    the reference toolchain writes for feature files.
    """
    path = os.fspath(path)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None, :]
    num_channels, num_frames = data.shape
    if num_channels != spec.num_channels:
        raise ValueError(f"data has {num_channels} channels, spec says {spec.num_channels}")
    t = spec.file_type
    fmt = spec.sample_format

    def _encode(big_endian: bool) -> bytes:
        enc = _native.encode(data, fmt, big_endian)
        if enc is not None:
            return enc
        return _encode_samples(np.ascontiguousarray(data.T), fmt, big_endian)

    if t == AIFF:
        payload = _encode(True)
        is_float = fmt in (SampleFormat.FLOAT, SampleFormat.DOUBLE)
        bits = _BITS[fmt]
        if is_float:
            comp = b"fl32" if fmt == SampleFormat.FLOAT else b"fl64"
            comp_name = b"\x0c32-bit float\x00" if fmt == SampleFormat.FLOAT \
                else b"\x0c64-bit float\x00"
            comm_body = (struct.pack(">hIh", num_channels, num_frames, bits)
                         + _encode_f80(spec.sample_rate) + comp + comp_name)
            form_type = b"AIFC"
        else:
            comm_body = (struct.pack(">hIh", num_channels, num_frames, bits)
                         + _encode_f80(spec.sample_rate))
            form_type = b"AIFF"
        chunks = []
        if form_type == b"AIFC":
            chunks.append((b"FVER", struct.pack(">I", 0xA2805140)))
        chunks.append((b"COMM", comm_body))
        chunks.append((b"SSND", struct.pack(">II", 0, 0) + payload))
        body = b""
        for cid, cbody in chunks:
            body += struct.pack(">4sI", cid, len(cbody)) + cbody
            if len(cbody) & 1:
                body += b"\x00"
        with open(path, "wb") as f:
            f.write(struct.pack(">4sI4s", b"FORM", 4 + len(body), form_type) + body)

    elif t == WAVE:
        payload = _encode(False)
        is_float = fmt in (SampleFormat.FLOAT, SampleFormat.DOUBLE)
        bits = _BITS[fmt]
        wformat = 3 if is_float else 1
        block_align = num_channels * bits // 8
        byte_rate = int(spec.sample_rate) * block_align
        fmt_chunk = struct.pack("<HHIIHH", wformat, num_channels,
                                int(spec.sample_rate), byte_rate, block_align, bits)
        body = struct.pack("<4sI", b"fmt ", len(fmt_chunk)) + fmt_chunk
        if is_float:
            body += struct.pack("<4sI", b"fact", 4) + struct.pack("<I", num_frames)
        body += struct.pack("<4sI", b"data", len(payload)) + payload
        if len(payload) & 1:
            body += b"\x00"
        with open(path, "wb") as f:
            f.write(struct.pack("<4sI4s", b"RIFF", 4 + len(body), b"WAVE") + body)

    elif t == IRCAM:
        payload = _encode(True)
        code = {SampleFormat.INT16: 2, SampleFormat.INT24: 3,
                SampleFormat.INT32: 0x40004, SampleFormat.FLOAT: 4,
                SampleFormat.DOUBLE: 8}[fmt]
        header = (b"\x64\xa3\x02\x00"  # Sun big-endian variant
                  + struct.pack(">fii", spec.sample_rate, num_channels, code))
        header += b"\x00" * (1024 - len(header))
        with open(path, "wb") as f:
            f.write(header + payload)

    elif t == NEXT:
        payload = _encode(True)
        enc = {SampleFormat.INT16: 3, SampleFormat.INT24: 4,
               SampleFormat.INT32: 5, SampleFormat.FLOAT: 6,
               SampleFormat.DOUBLE: 7}[fmt]
        header = struct.pack(">4sIIIII", b".snd", 28, len(payload), enc,
                             int(spec.sample_rate), num_channels) + b"\x00" * 4
        with open(path, "wb") as f:
            f.write(header + payload)

    elif t == RAW:
        with open(path, "wb") as f:
            f.write(_encode(False))

    elif t == WAVE64:
        # Wave64: GUID-chunked RIFF variant; 16-byte GUIDs + 8-byte sizes
        payload = _encode(False)
        is_float = fmt in (SampleFormat.FLOAT, SampleFormat.DOUBLE)
        bits = _BITS[fmt]
        wformat = 3 if is_float else 1
        block_align = num_channels * bits // 8

        def guid(fourcc: bytes) -> bytes:
            return fourcc + bytes.fromhex("F3ACD3118CD100C04F8EDB8A")

        riff_guid = bytes.fromhex("72696666") + bytes.fromhex(
            "2E91CF11A5D628DB04C10000")
        wave_guid = guid(b"wave")
        fmt_guid = guid(b"fmt ")
        data_guid = guid(b"data")
        fmt_body = struct.pack("<HHIIHH", wformat, num_channels,
                               int(spec.sample_rate),
                               int(spec.sample_rate) * block_align,
                               block_align, bits)
        fmt_chunk = fmt_guid + struct.pack("<Q", 24 + len(fmt_body)) + fmt_body
        fmt_chunk += b"\x00" * ((8 - len(fmt_chunk) % 8) % 8)
        data_chunk = data_guid + struct.pack("<Q", 24 + len(payload)) + payload
        total = 16 + 8 + 16 + len(fmt_chunk) + len(data_chunk)
        with open(path, "wb") as f:
            f.write(riff_guid + struct.pack("<Q", total) + wave_guid
                    + fmt_chunk + data_chunk)
    else:
        raise ValueError(f"unsupported container {t!r}")

    return replace(spec, num_frames=num_frames)


class AudioFileWriter:
    """Incremental frame writer (AIFF/AIFC and WAV): stream blocks with
    :meth:`write_frames`, sizes are patched into the headers on
    :meth:`close` — bounded memory for arbitrarily long outputs (cf.
    synth.io's streaming AudioFile used by the reference's stitch loop)."""

    def __init__(self, path, spec: AudioFileSpec) -> None:
        self.path = os.fspath(path)
        self.spec = spec
        if spec.file_type not in (AIFF, WAVE):
            raise ValueError(
                f"incremental writing supports aiff/wav, not {spec.file_type.id}")
        self._big_endian = spec.file_type == AIFF
        self._frames_written = 0
        self._f = open(self.path, "wb")
        self._write_header(0)

    def _write_header(self, num_frames: int) -> None:
        fmt = self.spec.sample_format
        ch = self.spec.num_channels
        bits = _BITS[fmt]
        payload_len = num_frames * ch * (bits // 8)
        f = self._f
        f.seek(0)
        if self.spec.file_type == AIFF:
            is_float = fmt in (SampleFormat.FLOAT, SampleFormat.DOUBLE)
            if is_float:
                comp = b"fl32" if fmt == SampleFormat.FLOAT else b"fl64"
                name = b"\x0c32-bit float\x00" if fmt == SampleFormat.FLOAT \
                    else b"\x0c64-bit float\x00"
                comm = (struct.pack(">hIh", ch, num_frames, bits)
                        + _encode_f80(self.spec.sample_rate) + comp + name)
                form_type = b"AIFC"
            else:
                comm = (struct.pack(">hIh", ch, num_frames, bits)
                        + _encode_f80(self.spec.sample_rate))
                form_type = b"AIFF"
            body = b""
            if form_type == b"AIFC":
                body += struct.pack(">4sI", b"FVER", 4) + struct.pack(">I", 0xA2805140)
            body += struct.pack(">4sI", b"COMM", len(comm)) + comm
            if len(comm) & 1:
                body += b"\x00"
            body += struct.pack(">4sI", b"SSND", 8 + payload_len) + struct.pack(">II", 0, 0)
            # FORM size counts the alignment pad byte close() appends for
            # odd payloads (chunk sizes do not)
            f.write(struct.pack(">4sI4s",
                                b"FORM",
                                4 + len(body) + payload_len + (payload_len & 1),
                                form_type) + body)
        else:  # WAV
            is_float = fmt in (SampleFormat.FLOAT, SampleFormat.DOUBLE)
            wformat = 3 if is_float else 1
            block_align = ch * bits // 8
            fmt_chunk = struct.pack("<HHIIHH", wformat, ch,
                                    int(self.spec.sample_rate),
                                    int(self.spec.sample_rate) * block_align,
                                    block_align, bits)
            body = struct.pack("<4sI", b"fmt ", len(fmt_chunk)) + fmt_chunk
            if is_float:
                body += struct.pack("<4sI", b"fact", 4) + struct.pack("<I", num_frames)
            body += struct.pack("<4sI", b"data", payload_len)
            f.write(struct.pack("<4sI4s",
                                b"RIFF",
                                4 + len(body) + payload_len + (payload_len & 1),
                                b"WAVE") + body)
        self._data_start = f.tell()

    def write_frames(self, data: np.ndarray) -> None:
        """Append ``[channels, n]`` float32 frames."""
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data[None, :]
        enc = _native.encode(data, self.spec.sample_format, self._big_endian)
        if enc is None:
            enc = _encode_samples(np.ascontiguousarray(data.T),
                                  self.spec.sample_format, self._big_endian)
        self._f.write(enc)
        self._frames_written += data.shape[1]

    def close(self) -> None:
        if self._f.closed:
            return
        # odd payloads (e.g. int24 mono) take the containers' alignment
        # pad byte, like the one-shot write() path
        self._f.seek(0, 2)
        payload = self._f.tell() - self._data_start
        if payload & 1:
            self._f.write(b"\x00")
        # patch the final frame count into the (same-length) header
        self._write_header(self._frames_written)
        self._f.close()

    def __enter__(self) -> "AudioFileWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def open_write(path, spec: AudioFileSpec) -> AudioFileWriter:
    return AudioFileWriter(path, spec)


def identify(path) -> Optional[AudioFileType]:
    """Identify a file's container by magic, or ``None`` if unrecognized
    (cf. ``AudioFile.identify``, used for directory expansion in the reference
    CLI, Strugatzki.scala:479-483)."""
    try:
        with open(os.fspath(path), "rb") as f:
            magic = f.read(4)
    except OSError:
        return None
    if magic == b"FORM":
        return AIFF
    if magic == b"RIFF":
        return WAVE
    if magic == _W64_RIFF_GUID[:4]:
        # Wave64 shares the ASCII 'riff' prefix of its 16-byte GUID
        try:
            with open(os.fspath(path), "rb") as f:
                if f.read(16) == _W64_RIFF_GUID:
                    return WAVE64
        except OSError:
            return None
    if magic == b".snd":
        return NEXT
    if magic in _IRCAM_MAGICS:
        return IRCAM
    return None
