"""Self-/cross-similarity matrix image in PyTorch.

Port of ``strugatzki_tpu/analysis/self_similarity.py`` (a re-implementation
of the reference's impl/SelfSimilarityImpl.scala).  Windows are gathered
once into resident device stacks with their per-window sums; each chunk of
(row-block, column-block) pairs is one index_select of whole blocks and one
batched float64 matmul per channel group
(``kernels/corr.py::gram_similarity_block``); the sims come back float32.

Parity notes (as in the JAX package):

* decimation subsamples window starts (stride ``decim``), it does not
  average (:162-164); auto-decimation keeps the extent ≤ 0xB504 (:81-91);
* cell (i, j) correlates file 1's window i (first half) against file 2's
  window j (second half) with joint statistics; only i ≤ j is computed and
  both symmetric pixels are written y-flipped (:136, :152-155);
* pixel = palette(pow(max(0, sim), colorWarp) / colorCeil) (:150).  With
  colorWarp 1 the quantization runs on the device as three stages of
  separate eager ops (``_pix_s1``–``_pix_s3``), each op individually
  rounded, so the raster is bit-equal to the host ``_colorize``: no
  multiply is ever contracted with an add into an FMA.  Nothing here may be
  fused (no ``torch.compile``, no custom elementwise kernel).
"""

from __future__ import annotations

import os
import sys
import time
from collections import deque

import numpy as np
import torch

from strugatzki_tpu.analysis.common import (full_to_feat, load_norm,
                                            normalized, read_features)
from strugatzki_tpu.config import (ColorScheme, ExtractionConfig,
                                   SelfSimilarityConfig)
from strugatzki_tpu.runtime.processor import Processor, ProcessorFactory
from strugatzki_tpu.util import palette as P
from strugatzki_tpu.util.palette import apply_palette
from strugatzki_tpu.util.png import write_png, write_png_rows

from ..kernels import corr as K
from ..runtime.device import resolve

__all__ = ["SelfSimilarity", "self_similarity_matrix",
           "self_similarity_image", "self_similarity_to_png"]

_MAX_EXTENT = 0xB504
_BLOCK = 512
#: Above this extent the [n, n] float32 matrix would pass ~0.5 GB — switch
#: to the stripe-streaming PNG path (identical pixels, bounded memory).
_STREAM_EXTENT = 11000
#: Above this extent the factory's streaming path defaults to deflate
#: level 1.  Override per process via ``SelfSimilarity.png_level``.
_FAST_DEFLATE_EXTENT = 20000
#: block pairs per gram call
_PAIRS_PER_CALL = 32


# --- device colorization (colorWarp == 1) -----------------------------------
# The host quantization (``_colorize`` + ``apply_palette``) as the identical
# float32 op sequence, no pow.  Within each stage no multiply feeds an
# add/sub, and every eager torch op is its own kernel, so every result is
# individually IEEE-rounded (``1 − v`` and ``t + 0.5`` scale their operand by
# exactly ±1):
#   s1: max, ×inv_ceil
#   s2: [1−·], nan→0, [clip], ×k
#   s3: +0.5, [clip], truncating cast
# NaN is gone (s2) before any cast: a float NaN cast to an integer is
# undefined on CUDA.  Palette indices leave the device as int32 (exact
# truncation of values in [0, NUM_COLORS − 1]; uint16 has few CUDA ops) and
# are narrowed to uint16 on the host when stored.

def _pix_s1(sims: torch.Tensor, inv_ceil: float) -> torch.Tensor:
    return torch.clamp_min(sims, 0.0) * inv_ceil


def _pix_s2(v: torch.Tensor, k: float, gray: bool = False,
            inv: bool = False) -> torch.Tensor:
    if inv:
        v = 1.0 - v
    # np.nan_to_num semantics: NaN → 0 (Java's (int)NaN == 0), ±inf → ±huge
    v = torch.nan_to_num(v, nan=0.0)
    if gray:
        return v * k          # host clips after the +0.5 (``_colorize``)
    return torch.clamp(v, 0.0, 1.0) * k      # host clips first (apply_palette)


def _pix_s3(t: torch.Tensor, gray: bool = False) -> torch.Tensor:
    if gray:
        return torch.clamp(t + 0.5, 0.0, 255.0).to(torch.uint8)
    return (t + 0.5).to(torch.int32)


def _apply_pix_stages(sims: torch.Tensor, pix) -> torch.Tensor:
    """Quantize device sims: gray bytes (uint8) or palette indices
    (int32)."""
    inv_ceil, k, gray, inv = pix
    v = _pix_s1(sims, inv_ceil)
    return _pix_s3(_pix_s2(v, k, gray=gray, inv=inv), gray=gray)


def _device_pix(colors: str, color_warp: float, color_ceil: float,
                color_inv: bool):
    """``(inv_ceil, k, gray, inv)`` for the device colorization — ``k`` the
    quantization factor (255 for gray, ``NUM_COLORS − 1`` for palette
    indices), both rounded to f32 — or None when the bit-exact device path
    does not apply: ``colorWarp != 1`` (pow on the device is not
    ulp-identical to host pow) or a custom palette too large for uint16
    indices.  Callers then fetch float32 sims and colorize on the host."""
    if float(color_warp) != 1.0:
        return None
    gray = colors == ColorScheme.GRAY_SCALE
    if not gray and P.NUM_COLORS > 0xFFFF:
        return None
    k = 255 if gray else P.NUM_COLORS - 1
    return (K._f32(1.0 / color_ceil), K._f32(k), gray, bool(color_inv))


# --- the gram engine ----------------------------------------------------------

# copied verbatim from the JAX package, whose module imports jax
def _extent(x1: np.ndarray, x2: np.ndarray, half_win: int,
            decim: int) -> int:
    """Image extent ``n`` (decimated window-pair count) — the one formula
    both engines' preps share (SelfSimilarityImpl.scala:75-91)."""
    af_len = min(x1.shape[1], x2.shape[1])
    num_corrs = max(0, af_len - half_win * 2 + 1)
    return num_corrs // decim


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array → ``dev``, through pinned memory on CUDA so the
    copy does not wait for the chunks already queued."""
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _prep_resident(x1: np.ndarray, x2: np.ndarray, half_win: int,
                   decim: int, num_temporal: int = 1, device="cuda"):
    """Image extent, block count, and per-input ``(win_all [NB·_BLOCK, C,
    h], stats_all [4, NB·_BLOCK], num_temporal)`` resident stacks on
    ``device`` (``num_temporal`` rides with the stacks so a pair call can
    never blend with another split than the stats were computed with).

    The window starts are padded to whole blocks by repeating the last
    start (valid data, never indexed by a real cell).  In self mode
    (``x2 is x1``) both inputs share one pair of stacks."""
    n = _extent(x1, x2, half_win, decim)
    if n == 0:
        return 0, 0, None, None
    dev = resolve(device)
    num_blocks = (n + _BLOCK - 1) // _BLOCK
    starts = torch.as_tensor(
        np.minimum(np.arange(num_blocks * _BLOCK, dtype=np.int64),
                   n - 1) * decim, device=dev)

    def stacks_of(xj):
        win_all = K.extract_windows(
            torch.as_tensor(xj, dtype=torch.float32, device=dev), starts,
            half_win)
        stats_all = torch.stack(K.window_stats(win_all,
                                               num_temporal=num_temporal))
        return win_all, stats_all, num_temporal

    res1 = stacks_of(x1)
    res2 = res1 if x2 is x1 else stacks_of(x2)
    return n, num_blocks, res1, res2


def _pair_block_gather(win_all: torch.Tensor, stats_all: torch.Tensor,
                       block_ids: torch.Tensor):
    """Whole window blocks by id, one ``index_select`` each: ``[P]`` block
    ids → (``[P, _BLOCK, C, h]`` windows, 4× ``[P, _BLOCK]`` stats)."""
    nb = win_all.shape[0] // _BLOCK
    w = win_all.view(nb, _BLOCK, *win_all.shape[1:]).index_select(
        0, block_ids)
    s = stats_all.view(4, nb, _BLOCK).index_select(1, block_ids)
    return w, (s[0], s[1], s[2], s[3])


def _gram_pairs_core(win1, stats1, win2, stats2, idx: torch.Tensor,
                     tw: float, num_temporal: int = 1) -> torch.Tensor:
    """``idx``: ``[2, P]`` (row-block ids, column-block ids).  Returns
    ``sims [P, _BLOCK, _BLOCK]``: one batched matmul per group."""
    wi, sti = _pair_block_gather(win1, stats1, idx[0])
    wj, stj = _pair_block_gather(win2, stats2, idx[1])
    return K.gram_similarity_block(wi, wj, sti, stj, tw,
                                   num_temporal=num_temporal)


def _dispatch_pairs_fast(res1, res2, pairs, tw: float, pix=None):
    """One gram call (+ the colorize stages) for a chunk of (bi, bj) pairs,
    queued on the device: returns the device tensor."""
    win1, stats1, nt = res1
    win2, stats2, _ = res2
    idx = _upload(np.asarray(pairs, np.int64).T.copy(), win1.device)
    sims = _gram_pairs_core(win1, stats1, win2, stats2, idx, tw,
                            num_temporal=nt)
    return sims if pix is None else _apply_pix_stages(sims, pix)


def _iter_pair_sims(pairs, dispatch_chunk, chunk_size,
                    check_aborted=lambda: None, lookahead: int = 2):
    """Yield ``((bi, bj), sims[_BLOCK, _BLOCK])`` per pair, with
    ``lookahead`` chunks queued ahead of the fetch so device work overlaps
    the transfers and the host write-back."""
    chunks = [pairs[g0:g0 + chunk_size]
              for g0 in range(0, len(pairs), chunk_size)]
    pending: deque = deque()
    ci = 0
    while pending or ci < len(chunks):
        # checked every iteration, the drain of the queued chunks included
        check_aborted()
        while ci < len(chunks) and len(pending) < lookahead:
            pending.append((chunks[ci], dispatch_chunk(chunks[ci])))
            ci += 1
        c, dev = pending.popleft()
        sims = dev.cpu().numpy()
        for p, s in zip(c, sims):
            yield p, s


def _make_engine(x1, x2, half_win: int, decim: int, tw: float, pix,
                 device="cuda"):
    """Prep the gram engine: ``(n, num_blocks, dispatch, chunk)`` where
    ``dispatch(pairs)`` queues one chunk of (bi, bj) block pairs."""
    n, num_blocks, res1, res2 = _prep_resident(x1, x2, half_win, decim,
                                               device=device)
    return (n, num_blocks,
            lambda ps: _dispatch_pairs_fast(res1, res2, ps, tw, pix),
            _PAIRS_PER_CALL)


def _pixel_matrix(x1: np.ndarray, x2: np.ndarray, half_win: int,
                  decim: int, temp_weight: float,
                  check_aborted=lambda: None,
                  progress=lambda f: None, pix=None,
                  device="cuda") -> np.ndarray:
    """Shared matrix builder: float32 sims (``pix=None``) or the
    device-colorized uint8/uint16 raster over the same block schedule
    (int32 palette indices narrow to uint16 as they are stored)."""
    dtype = np.float32 if pix is None else (
        np.uint8 if pix[2] else np.uint16)
    n, num_blocks, dispatch, chunk = _make_engine(
        x1, x2, half_win, decim, temp_weight, pix, device)
    if n == 0:
        return np.zeros((0, 0), dtype)

    pairs = [(bi, bj) for bi in range(num_blocks)
             for bj in range(bi, num_blocks)]
    out = np.empty((n, n), dtype)
    done = 0
    for (bi, bj), sims in _iter_pair_sims(pairs, dispatch, chunk,
                                          check_aborted=check_aborted):
        r0 = bi * _BLOCK
        c0 = bj * _BLOCK
        r1 = min(r0 + _BLOCK, n)
        c1 = min(c0 + _BLOCK, n)
        s = sims[:r1 - r0, :c1 - c0]
        if bi == bj:
            # only i ≤ j cells are the reference's computed values
            # (SelfSimilarityImpl.scala:136); mirror the upper triangle —
            # in cross mode the i > j half of the block differs
            out[r0:r1, c0:c1] = np.triu(s) + np.triu(s, 1).T
        else:
            out[r0:r1, c0:c1] = s
            out[c0:c1, r0:r1] = s.T
        done += 1
        progress(done / len(pairs))
    return out


def self_similarity_matrix(x1: np.ndarray, x2: np.ndarray, half_win: int,
                           decim: int, temp_weight: float,
                           check_aborted=lambda: None,
                           progress=lambda f: None,
                           device="cuda") -> np.ndarray:
    """Similarity matrix ``[n, n]`` over decimated window starts of two
    prepared (normalized, jointly shifted) feature matrices."""
    return _pixel_matrix(x1, x2, half_win, decim, temp_weight,
                         check_aborted=check_aborted, progress=progress,
                         device=device)


def self_similarity_image(x1: np.ndarray, x2: np.ndarray, half_win: int,
                          decim: int, temp_weight: float,
                          colors: str = ColorScheme.PSYCHO_OPTICAL,
                          color_warp: float = 1.0, color_ceil: float = 1.0,
                          color_inv: bool = False,
                          check_aborted=lambda: None,
                          progress=lambda f: None,
                          device="cuda") -> np.ndarray:
    """RGB image (reference pixel layout) for the similarity matrix: the
    device colorization when ``colorWarp == 1``, else the float32 matrix
    colorized on the host exactly like :func:`render_image`."""
    pix = _device_pix(colors, color_warp, color_ceil, color_inv)
    if pix is None:
        sims = _pixel_matrix(x1, x2, half_win, decim, temp_weight,
                             check_aborted=check_aborted, progress=progress,
                             device=device)
        return render_image(sims, colors, color_warp, color_ceil, color_inv)
    vals = _pixel_matrix(x1, x2, half_win, decim, temp_weight,
                         check_aborted=check_aborted, progress=progress,
                         pix=pix, device=device)
    rgb = _pix_to_rgb(vals, pix[2])
    # same layout rule as render_image: x = i, y = flipped j
    return rgb.transpose(1, 0, 2)[::-1]


# copied verbatim from the JAX package, whose module imports jax
def _pix_to_rgb(pix_vals: np.ndarray, gray: bool) -> np.ndarray:
    """Device-colorized raster → RGB: gray bytes broadcast, palette indices
    gathered through the (possibly drop-in) host table."""
    if gray:
        return np.stack([pix_vals, pix_vals, pix_vals], axis=-1)
    from strugatzki_tpu.util.palette import lookup
    return lookup(pix_vals)


# copied verbatim from the JAX package, whose module imports jax
def _colorize(v_sims: np.ndarray, colors: str, color_warp: float,
              color_ceil: float, color_inv: bool) -> np.ndarray:
    """sim values → RGB via the reference's color mapping
    ``colorFun(pow(max(0, sim), warp) / ceil)`` (SelfSimilarityImpl.scala:150)."""
    v = np.power(np.maximum(v_sims, 0.0), color_warp) * (1.0 / color_ceil)
    if color_inv:
        v = 1.0 - v
    if colors == ColorScheme.GRAY_SCALE:
        # NaN → 0 like Java's (int)NaN (the reference's (sim*255+0.5).toInt,
        # SelfSimilarityImpl.scala:100); apply_palette applies the same rule
        v = np.nan_to_num(v, nan=0.0)
        with np.errstate(over="ignore"):   # ±huge × 255 → ±inf → clip
            g = np.clip(v * np.float32(255) + np.float32(0.5),
                        0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    return apply_palette(v)


# copied verbatim from the JAX package, whose module imports jax
def render_image(sims: np.ndarray, colors: str, color_warp: float,
                 color_ceil: float, color_inv: bool) -> np.ndarray:
    """Similarity matrix → RGB image with the reference's pixel layout:
    x = i, y = flipped j (SelfSimilarityImpl.scala:152-155)."""
    rgb = _colorize(sims, colors, color_warp, color_ceil, color_inv)
    # image[y, x] with y = extent−1−j, x = i  → flip the j (column) axis and
    # transpose so rows become y
    return rgb.transpose(1, 0, 2)[::-1]


def self_similarity_to_png(x1: np.ndarray, x2: np.ndarray, half_win: int,
                           decim: int, temp_weight: float, path,
                           colors: str = ColorScheme.PSYCHO_OPTICAL,
                           color_warp: float = 1.0, color_ceil: float = 1.0,
                           color_inv: bool = False,
                           check_aborted=lambda: None,
                           progress=lambda f: None,
                           png_level: int = 6, device="cuda") -> int:
    """Stream the similarity image straight to a PNG without ever holding
    the ``[n, n]`` matrix or its RGB raster: one ``[n, _BLOCK]`` column
    stripe at a time is computed on ``device``, colorized, and fed to the
    banded PNG compressor.

    PNG row ``y`` is matrix column ``j = n−1−y`` (the reference's y-flip),
    so stripes are emitted in descending-``j`` order.  Cells mirror the
    upper triangle exactly like :func:`self_similarity_matrix`;
    off-diagonal blocks are recomputed for their mirror stripe (2× the
    matmuls for O(n·block) memory).

    ``STRUGATZKI_RENDER_TIMING=1`` prints the wall split to stderr:
    "dispatch" (queueing the device work), "fetch-wait" (waiting for device
    results, including device time not hidden by the stripe-ahead),
    "raster" (host flip + colorize) and "png" (the rest: filter, deflate,
    write).

    Returns the image extent ``n``.
    """
    pix = _device_pix(colors, color_warp, color_ceil, color_inv)
    dtype = np.float32 if pix is None else (
        np.uint8 if pix[2] else np.uint16)
    n, num_blocks, dispatch, gsize = _make_engine(
        x1, x2, half_win, decim, temp_weight, pix, device)
    if n == 0:
        write_png(path, np.zeros((0, 0, 3), np.uint8))
        return 0
    timing = ({"dispatch": 0.0, "fetch": 0.0, "raster": 0.0}
              if os.environ.get("STRUGATZKI_RENDER_TIMING") else None)
    t_start = time.perf_counter()

    def dispatch_stripe(bj):
        """Queue every chunk of column-stripe ``bj``: row-blocks in chunks
        of ``gsize``; for bi > bj the cell is the mirrored upper-triangle
        value → compute (bj, bi), transpose."""
        t0 = time.perf_counter() if timing else 0.0
        out = []
        for g0 in range(0, num_blocks, gsize):
            group = list(range(g0, min(g0 + gsize, num_blocks)))
            lo_hi = [(min(bi, bj), max(bi, bj)) for bi in group]
            out.append((group, dispatch(lo_hi)))
        if timing:
            timing["dispatch"] += time.perf_counter() - t0
        return out

    def collect_stripe(bj, dispatched):
        c0 = bj * _BLOCK
        c1 = min(c0 + _BLOCK, n)
        stripe = np.empty((n, c1 - c0), dtype)
        for group, dev in dispatched:
            t0 = time.perf_counter() if timing else 0.0
            sims_g = dev.cpu().numpy()
            if timing:
                timing["fetch"] += time.perf_counter() - t0
            for bi, sims in zip(group, sims_g):
                r0 = bi * _BLOCK
                r1 = min(r0 + _BLOCK, n)
                if bi == bj:
                    s = sims[:r1 - r0, :c1 - c0]
                    stripe[r0:r1] = np.triu(s) + np.triu(s, 1).T
                elif bi < bj:
                    stripe[r0:r1] = sims[:r1 - r0, :c1 - c0]
                else:  # mirrored: computed as (bj, bi) → transpose
                    stripe[r0:r1] = sims[:c1 - c0, :r1 - r0].T
        return stripe

    def stripes():
        # stripe-ahead: stripe bj−1's device work (and its transfers)
        # overlaps stripe bj's host colorize/PNG time
        done = 0
        pending = dispatch_stripe(num_blocks - 1)
        for bj in range(num_blocks - 1, -1, -1):
            check_aborted()
            current, pending = pending, (
                dispatch_stripe(bj - 1) if bj > 0 else None)
            stripe = collect_stripe(bj, current)
            # stripe columns j = c0..c1−1 → PNG rows y = n−1−j (descending)
            t0 = time.perf_counter() if timing else 0.0
            flipped = stripe.T[::-1]
            rgb = _pix_to_rgb(flipped, pix[2]) if pix is not None else \
                _colorize(flipped, colors, color_warp, color_ceil, color_inv)
            if timing:
                timing["raster"] += time.perf_counter() - t0
            done += 1
            progress(done / num_blocks)
            yield rgb

    write_png_rows(path, n, n, stripes(), level=png_level)
    if timing:
        total = time.perf_counter() - t_start
        png_s = total - sum(timing.values())
        print(f"render timing (extent {n}, level {png_level}): "
              f"total {total:.3f}s = dispatch {timing['dispatch']:.3f}s "
              f"+ fetch-wait {timing['fetch']:.3f}s + raster "
              f"{timing['raster']:.3f}s + png(filter+deflate+io) "
              f"{png_s:.3f}s", file=sys.stderr)
    return n


def _joint_shifted(f1: np.ndarray, f2: np.ndarray, norm, af_start: int,
                   af_stop: int):
    """The factory's inputs: both spans normalized, then shifted by one
    joint per-group shift over both (the same constant on both sides keeps
    correlateHalf exact), subtracted in f32.  In self mode (``f2 is f1``)
    the second input IS the first, so the engine shares its stacks."""
    xn1 = normalized(f1[:, af_start:af_stop], norm)
    xn2 = xn1 if f2 is f1 else normalized(f2[:, af_start:af_stop], norm)
    joint = xn1 if xn2 is xn1 else np.concatenate([xn1, xn2], axis=1)
    _, sh_t, sh_s = K.shift_per_group(joint)

    def shift(x):
        out = x.copy()
        out[:1] -= np.float32(sh_t)
        out[1:] -= np.float32(sh_s)
        return out
    x1 = shift(xn1)
    return x1, (x1 if xn2 is xn1 else shift(xn2))


class SelfSimilarity(ProcessorFactory):
    """``SelfSimilarity.run(config, observer) -> Processor[None]`` (writes
    the PNG)."""

    name = "self similarity"
    Config = SelfSimilarityConfig
    #: the device the gram runs on (process state, not config)
    device = "cuda"
    #: deflate level for the streaming (giant-extent) path: None = auto
    #: (6, dropping to 1 above ``_FAST_DEFLATE_EXTENT``); set an int to
    #: force a level.  Process state, not config: the XML schema stays
    #: reference-compatible.
    png_level = None

    @classmethod
    def _make_body(cls, config: SelfSimilarityConfig):
        cfg = config.build()
        device = cls.device
        png_level = cls.png_level

        def body(proc: Processor):
            extr1 = ExtractionConfig.from_xml_file(cfg.meta_input)
            extr2 = ExtractionConfig.from_xml_file(cfg.meta_input2) \
                if cfg.meta_input2 else extr1
            if (extr1.fft_size != extr2.fft_size
                    or extr1.fft_overlap != extr2.fft_overlap
                    or extr1.num_coeffs != extr2.num_coeffs):
                raise ValueError("analysis settings of the two inputs differ")
            step = extr1.step_size
            half_win = full_to_feat(cfg.corr_len, step)

            norm = load_norm(cfg.database_folder, extr1.num_coeffs) \
                if cfg.normalize else None

            f1 = read_features(extr1)
            f2 = f1 if extr2.feature_output == extr1.feature_output \
                else read_features(extr2)
            af_frames = min(f1.shape[1], f2.shape[1])

            af_start = max(0, full_to_feat(cfg.span.start, step)) \
                if cfg.span.has_start else 0
            af_stop = min(af_frames, full_to_feat(cfg.span.stop, step)) \
                if cfg.span.has_stop else af_frames
            af_len = af_stop - af_start

            win_len = half_win * 2
            num_corrs = max(0, af_len - win_len + 1)
            if num_corrs > 0x7FFFFFFF:
                raise ValueError("32-bit overflow")

            # reference requires (SelfSimilarityImpl.scala:112-114)
            if not cfg.color_warp > 0:
                raise ValueError(
                    f"Illegal colorWarp setting of {cfg.color_warp}")
            if not cfg.color_ceil > 0:
                raise ValueError(
                    f"Illegal colorCeil setting of {cfg.color_ceil}")
            decim = cfg.decimation
            if decim < 1:
                raise ValueError(f"Illegal decimation setting of {decim}")
            img_ext = num_corrs // decim
            if img_ext > _MAX_EXTENT:
                decim = (num_corrs + _MAX_EXTENT - 1) // _MAX_EXTENT
                print("Warning: Decimation is too small to produce a "
                      f"reasonable image size. Automatically adjusting to {decim}")
                img_ext = num_corrs // decim
            if cls.verbose:
                print(f"Image extent is {img_ext} (yielding a matrix of "
                      f"{img_ext * img_ext} pixels)")
            if img_ext == 0:
                raise ValueError("span too short for the correlation length")

            x1, x2 = _joint_shifted(f1, f2, norm, af_start, af_stop)

            if img_ext > _STREAM_EXTENT:
                # giant image: stream column stripes straight into the PNG
                # compressor; the deflate level drops to 1 only at truly
                # giant extents (pixels are identical either way)
                level = png_level if png_level is not None else (
                    1 if img_ext > _FAST_DEFLATE_EXTENT else 6)
                with proc.sub(0.98):
                    self_similarity_to_png(
                        x1, x2, half_win, decim, cfg.temporal_weight,
                        cfg.image_output, cfg.colors, cfg.color_warp,
                        cfg.color_ceil, cfg.color_inv,
                        check_aborted=proc.check_aborted,
                        progress=proc.set_progress, png_level=level,
                        device=device)
            else:
                with proc.sub(0.95):
                    rgb = self_similarity_image(
                        x1, x2, half_win, decim, cfg.temporal_weight,
                        cfg.colors, cfg.color_warp, cfg.color_ceil,
                        cfg.color_inv, check_aborted=proc.check_aborted,
                        progress=proc.set_progress, device=device)
                write_png(cfg.image_output, rgb)
            proc.set_progress(1.0)
            return None

        return body
