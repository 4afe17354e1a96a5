"""Feature database statistics (the ``feat_norms.aif`` producer).

Exact re-implementation of impl/FeatureStatsImpl.scala: per feature file and
channel, a two-pass skewed-histogram estimate of the 1st/99th percentiles
(reported as the (min, max) normalization range), then an element-wise
min/max across files (:38-49).  The algorithm *defines* the values stored in
``feat_norms.aif``, so it is kept bit-faithful (float64 math over float32
samples, Java double→int truncation semantics) rather than replaced by a sort
— it is IO-bound either way.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..io import audiofile as af
from ..runtime.processor import Processor, ProcessorFactory

__all__ = ["FeatureStats", "stats_for_file"]


def _to_int_java(x: np.ndarray) -> np.ndarray:
    """Java ``Double.toInt`` semantics: truncate toward zero, NaN → 0,
    ±Inf clamps (FeatureStatsImpl.scala:108 does ``(…).toInt``)."""
    out = np.where(np.isnan(x), 0.0, x)
    out = np.clip(out, -2147483648.0, 2147483647.0)
    return np.trunc(out).astype(np.int64)


#: frames per accumulation chunk — bounds the f64 temporaries to
#: O(C·_CHUNK) instead of O(C·T)·5 (full f64 copy + cumsum + per-channel
#: pow/bin arrays), the reference's own streaming discipline (it reads 8K
#: frames at a time, FeatureStatsImpl.scala:70-84)
_CHUNK = 1 << 16


def stats_for_file(path) -> Tuple[np.ndarray, np.ndarray]:
    """(p01, p99) arrays per channel for one feature file
    (impl/FeatureStatsImpl.scala:56-140)."""
    data, spec = af.read(path)          # [C, T] float32
    num_ch, n = data.shape
    if n == 0:
        raise ValueError(f"empty feature file: {path}")

    # JVM float semantics matter bit-for-bit here: mins/maxs and the range
    # d are Scala Float (f32) values (:61-62, :87 `maxs(ch) - mins(ch)`),
    # the mean accumulates in Double (:79), and the pass-2 quotient
    # `(f - min) / d` is an all-Float expression (:106) widened to Double
    # only for math.pow
    mins32 = data.min(axis=1)                                # f32
    maxs32 = data.max(axis=1)                                # f32
    d32 = (maxs32 - mins32).astype(np.float32)               # f32 subtract
    # sequential left-to-right f64 accumulation — the reference adds each
    # Float into a Double strictly in frame order (:79) and a ULP-different
    # mean can flip a histogram bin at a pow boundary.  Chunked cumsum
    # SEEDED with the running sums (the carry rides as the cumsum's first
    # column) keeps the association exactly ((s + x₁) + x₂) + … — bit-equal
    # to one full-length cumsum — while bounding the f64 temporary
    sums = np.zeros((num_ch, 1), np.float64)
    for o in range(0, n, _CHUNK):
        seeded = np.concatenate(
            [sums, data[:, o:o + _CHUNK].astype(np.float64)], axis=1)
        sums = seeded.cumsum(axis=1)[:, -1:]
    means = sums[:, 0] / n
    mins = mins32.astype(np.float64)
    d = d32.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        mn = (means - mins) / d
        skews = np.log(0.5) / np.log(mn)                     # (:86-91)

    p01 = np.zeros(num_ch)
    p99 = np.zeros(num_ch)
    p01n = int(n * 0.01)
    p99n = int(n * 0.99)
    for ch in range(num_ch):
        # histogram accumulation is associative — chunking is exact
        counts = np.zeros(2048, np.int64)
        for o in range(0, n, _CHUNK):
            with np.errstate(divide="ignore", invalid="ignore"):
                q32 = ((data[ch, o:o + _CHUNK] - mins32[ch])
                       / d32[ch]).astype(np.float32)
                norm = np.power(q32.astype(np.float64),
                                skews[ch]) * 2047 + 0.5
            bins = _to_int_java(norm)
            counts += np.bincount(np.clip(bins, 0, 2047), minlength=2048)
        # walk the histogram exactly like the reference (:123-132): advance
        # i while the running count is below the target — the final i is one
        # past the bin that crossed the threshold; value = unskewed i/2048
        cnt = 0
        i = 0
        while cnt < p01n:
            cnt += int(counts[i])
            i += 1
        skew_r = 1.0 / skews[ch]
        p01[ch] = np.power(i / 2048.0, skew_r) * d[ch] + mins[ch]
        while cnt < p99n:
            cnt += int(counts[i])
            i += 1
        p99[ch] = np.power(i / 2048.0, skew_r) * d[ch] + mins[ch]
    return p01, p99


class FeatureStats(ProcessorFactory):
    """``FeatureStats.run(paths, observer) -> Processor[list[(min, max)]]``.

    Config is simply the sequence of feature-file paths
    (reference FeatureStats.scala:23); the product is the per-channel
    (min, max) — robust p01/p99 — ranges across all files.
    """

    name = "stats"

    @classmethod
    def _make_body(cls, config: Sequence):
        paths = [str(p) for p in config]

        def body(proc: Processor) -> List[Tuple[float, float]]:
            if not paths:
                raise ValueError("no feature files given")
            # files are independent and the element-wise min/max merge is
            # order-invariant, so fan the IO+histogram work over a thread
            # pool (the reference is strictly sequential, README.md:83).
            # Explicit futures + cancel_futures on the way out: ex.map
            # queues EVERY file up front and a plain `with` exit waits for
            # all of them, so an abort (or one bad file) over a 10k-file
            # database would block until the whole queue had been read and
            # histogrammed — cancelling bounds the exit to the ≤8 in-flight
            # files (the reference aborts at one-file granularity)
            from concurrent.futures import ThreadPoolExecutor, as_completed

            all_mins = all_maxs = None
            done = 0
            ex = ThreadPoolExecutor(max_workers=min(8, max(len(paths), 1)))
            try:
                futs = {ex.submit(stats_for_file, p): p for p in paths}
                for fut in as_completed(futs):
                    proc.check_aborted()
                    mins, maxs = fut.result()
                    if all_mins is None:
                        all_mins, all_maxs = mins, maxs
                    else:
                        if len(mins) != len(all_mins):
                            raise ValueError(
                                f"channel count mismatch in {futs[fut]}")
                        all_mins = np.minimum(all_mins, mins)
                        all_maxs = np.maximum(all_maxs, maxs)
                    done += 1
                    proc.set_progress(done / len(paths))
            finally:
                ex.shutdown(wait=True, cancel_futures=True)
            return list(zip(all_mins.tolist(), all_maxs.tolist()))

        return body
