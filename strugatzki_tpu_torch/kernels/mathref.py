"""Exact host-side mirror of the reference's correlation math.

These are numerically faithful re-implementations of
``impl/MathUtil.scala`` (float32 data, float64 accumulation, result cast to
float32) in vectorized NumPy.  They serve as

1. the parity anchor the TPU kernels are tested against, and
2. the host fallback for tiny inputs where device dispatch isn't worth it.

All matrices use the reference layout ``[channels, frames]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["stat", "correlate", "correlate_half", "avg", "normalize"]


def stat(mat: np.ndarray, frame_off: int, frame_len: int,
         chan_off: int, chan_len: int) -> Tuple[float, float]:
    """Mean and (population) standard deviation of a sub-matrix.

    Mirrors MathUtil.scala:29-62: both passes accumulate in float64 over the
    float32 cells; stddev divides by the full matrix size.
    """
    sub = mat[chan_off:chan_off + chan_len, frame_off:frame_off + frame_len]
    sub64 = sub.astype(np.float64)
    mean = float(sub64.sum() / sub64.size)
    var = float(((sub64 - mean) ** 2).sum() / sub64.size)
    return mean, float(np.sqrt(var))


def avg(b: np.ndarray, off: int, length: int) -> np.float32:
    """Mean of a float32 vector slice, f64 accumulation, f32 result
    (MathUtil.scala:109-118)."""
    return np.float32(b[off:off + length].astype(np.float64).sum() / length)


def normalize(norm_buf: Optional[np.ndarray], b: np.ndarray,
              b_off: int, b_len: int) -> None:
    """In-place per-channel min/max normalization, no clipping
    (MathUtil.scala:132-152).

    ``norm_buf`` has shape ``[channels, 2]`` (column 0 = min, column 1 = max);
    ``None`` is a no-op.  Division by zero when min == max is allowed to
    produce inf/NaN exactly like the reference ("XXX should values be
    clipped ... or not?", MathUtil.scala:146).
    """
    if norm_buf is None:
        return
    mins = norm_buf[:, 0:1].astype(np.float32)
    maxs = norm_buf[:, 1:2].astype(np.float32)
    sl = b[:, b_off:b_off + b_len]
    with np.errstate(divide="ignore", invalid="ignore"):
        sl[...] = (sl - mins) / (maxs - mins)


def correlate(a: np.ndarray, a_mean: float, a_std: float,
              num_frames: int, num_channels: int,
              b: np.ndarray, b_mean: float, b_std: float,
              b_frame_off: int, b_chan_off: int) -> np.float32:
    """Normalized cross-correlation of matrix ``a`` against a (possibly
    rotated ring-buffer) region of ``b`` (MathUtil.scala:177-196).

    ``b`` columns are indexed modulo its width starting at ``b_frame_off``.
    Guarantees ``correlate(a, a) == 1`` in exact arithmetic.
    """
    b_len = b.shape[1]
    idx = (np.arange(num_frames) + b_frame_off) % b_len
    a64 = a[:num_channels, :num_frames].astype(np.float64)
    b64 = b[b_chan_off:b_chan_off + num_channels][:, idx].astype(np.float64)
    s = ((a64 - a_mean) * (b64 - b_mean)).sum()
    return np.float32(s / (a_std * b_std * (num_channels * num_frames)))


def correlate_half(num_channels: int, half_win_size: int, a: np.ndarray,
                   frame_off: int, chan_off: int) -> np.float32:
    """Cross-correlation of the two halves of a (rotating) window
    (MathUtil.scala:80-99).

    Statistics are computed over the *whole* physical window (both halves,
    frames ``0 .. 2*half_win_size``), which is rotation-invariant; the product
    sum uses modulo indexing from ``frame_off``.
    """
    num_frames = half_win_size << 1
    mean, std = stat(a, 0, num_frames, chan_off, num_channels)
    rows = a[chan_off:chan_off + num_channels].astype(np.float64)
    i = (np.arange(half_win_size) + frame_off) % num_frames
    j = (np.arange(half_win_size) + frame_off + half_win_size) % num_frames
    s = ((rows[:, i] - mean) * (rows[:, j] - mean)).sum()
    mat_size = num_channels * half_win_size
    return np.float32(s / (std * std * mat_size))
