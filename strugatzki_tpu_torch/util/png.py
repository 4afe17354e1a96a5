"""Minimal dependency-free PNG encoder (RGB8), replacing the reference's
``javax.imageio.ImageIO.write(img, "png", file)`` (SelfSimilarityImpl.scala:167).

The deflate stream is produced pigz-style: filtered scanlines are cut into
~1 MB blocks, each raw-deflated on its own thread (CPython's zlib releases
the GIL) with the previous block's last 32 KB as preset dictionary and a
``Z_FULL_FLUSH`` joint, and the pieces are concatenated under one zlib
header + adler32 trailer.  Any decoder sees a single ordinary zlib stream —
bytes differ from the serial encoder's, pixels decode identically — and a
46340²-pixel image (the reference's extent ceiling) encodes with all cores
while holding only the in-flight blocks in memory.  (This harness's host
exposes a single vCPU, so the win is only realized on real multi-core
hosts; ``threads=1`` forces the serial path.)
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["write_png", "write_png_rows"]

#: uncompressed bytes per parallel deflate job
_BLOCK = 1 << 20
#: deflate window — the dictionary carried between blocks
_DICT = 32768


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _zlib_header(level: int) -> bytes:
    cmf = 0x78                                   # deflate, 32K window
    flevel = 0 if level < 2 else 1 if level < 6 else 2 if level == 6 else 3
    flg = flevel << 6
    flg |= 31 - ((cmf << 8) | flg) % 31          # FCHECK
    return bytes((cmf, flg))


def _deflate_block(data: bytes, zdict: bytes, level: int,
                   final: bool) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8,
                         zlib.Z_DEFAULT_STRATEGY, zdict) if zdict else \
        zlib.compressobj(level, zlib.DEFLATED, -15, 8)
    out = c.compress(data)
    return out + c.flush(zlib.Z_FINISH if final else zlib.Z_FULL_FLUSH)


class _ParallelDeflate:
    """Streaming zlib-compatible compressor over a thread pool.

    ``feed`` accepts raw bytes; ``drain``/``finish`` yield compressed bytes
    in order.  At most ``workers + 2`` blocks are in flight, so memory stays
    bounded for arbitrarily long streams.
    """

    def __init__(self, level: int, workers: int):
        self.level = level
        # one worker would only add handoff latency on top of a serial
        # compression order — compress inline instead (identical bytes:
        # same block/dictionary/flush sequence either way)
        self.pool = ThreadPoolExecutor(max_workers=workers) \
            if workers > 1 else None
        self.limit = workers + 2
        self.jobs = deque()
        self.buf = bytearray()
        self.tail = b""                          # last 32 KB submitted
        self.adler = zlib.adler32(b"")
        self.out = bytearray(_zlib_header(level))

    def _submit(self, data: bytes, final: bool) -> None:
        self.adler = zlib.adler32(data, self.adler)
        if self.pool is None:
            self.out += _deflate_block(data, self.tail, self.level, final)
        else:
            self.jobs.append(self.pool.submit(
                _deflate_block, data, self.tail, self.level, final))
        self.tail = data[-_DICT:]

    def _reap(self, drain: bool) -> None:
        """Collect finished jobs in order; with ``drain`` wait for all of
        them, else only block when the in-flight cap is hit."""
        while self.jobs and (drain or len(self.jobs) >= self.limit
                             or self.jobs[0].done()):
            self.out += self.jobs.popleft().result()

    def feed(self, data) -> None:
        self.buf += data
        while len(self.buf) >= _BLOCK:
            self._submit(bytes(self.buf[:_BLOCK]), final=False)
            del self.buf[:_BLOCK]
            self._reap(drain=False)

    def take(self) -> bytes:
        self._reap(drain=False)
        out = bytes(self.out)
        self.out.clear()
        return out

    def finish(self) -> bytes:
        # the held remainder (possibly empty) becomes the BFINAL block
        self._submit(bytes(self.buf), final=True)
        self.buf.clear()
        self._reap(drain=True)
        if self.pool is not None:
            self.pool.shutdown()
        self.out += struct.pack(">I", self.adler & 0xFFFFFFFF)
        out = bytes(self.out)
        self.out.clear()
        return out


def write_png_rows(path, height: int, width: int, rows_iter,
                   level: int = 6, threads: int = 0) -> None:
    """Write an 8-bit RGB PNG from a stream of row bands.

    ``rows_iter`` yields consecutive ``[k, width, 3]`` uint8 arrays (top to
    bottom, summing to ``height`` rows).  Scanlines stream through the
    parallel deflater and out as ~4 MB IDAT chunks.  ``threads`` 0 = one
    worker per core (capped at 8); 1 = serial (still one zlib stream).
    """
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    comp = _ParallelDeflate(level, threads)
    try:
        _write_png_rows(path, height, width, rows_iter, ihdr, comp)
    finally:
        # rows_iter may raise mid-stream (e.g. a processor abort inside a
        # stripe generator) — never strand the worker threads
        if comp.pool is not None:
            comp.pool.shutdown(wait=False, cancel_futures=True)


def _write_png_rows(path, height, width, rows_iter, ihdr, comp) -> None:
    rows_done = 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr))
        pending = bytearray()

        def flush_idat(force=False):
            nonlocal pending
            while len(pending) >= (1 << 22) or (force and pending):
                piece = bytes(pending[:1 << 22])
                del pending[:1 << 22]
                f.write(struct.pack(">I", len(piece)) + b"IDAT" + piece
                        + struct.pack(">I",
                                      zlib.crc32(piece, zlib.crc32(b"IDAT"))
                                      & 0xFFFFFFFF))

        for rows in rows_iter:
            rows = np.ascontiguousarray(rows, dtype=np.uint8)
            if rows.ndim != 3 or rows.shape[2] != 3 or rows.shape[1] != width:
                raise ValueError(f"expected [k, {width}, 3] band, "
                                 f"got {rows.shape}")
            k = rows.shape[0]
            # filter byte 0 (None) before each scanline
            filt = np.concatenate(
                [np.zeros((k, 1), np.uint8),
                 rows.reshape(k, width * 3)], axis=1)
            comp.feed(filt.tobytes())
            pending += comp.take()
            flush_idat()
            rows_done += k
        if rows_done != height:
            raise ValueError(f"row stream produced {rows_done} rows, "
                             f"IHDR promised {height}")
        pending += comp.finish()
        flush_idat(force=True)
        f.write(_chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> None:
    """Write an ``[H, W, 3]`` uint8 array as an 8-bit RGB PNG (row-banded
    through :func:`write_png_rows`)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] rgb array, got {rgb.shape}")
    h, w = rgb.shape[:2]
    band = max(1, (1 << 22) // (w * 3 + 1))
    write_png_rows(path, h, w,
                   (rgb[y0:y0 + band] for y0 in range(0, h, band)))
