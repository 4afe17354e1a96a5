"""Plain reference of the feature front-end (``-f``): loudness/32 and 13
MFCC per 512-sample frame, in float64.

A frozen copy of the front-end's math (Dan Stowell's MFCC and Nick
Collins' Loudness from SuperCollider's ML.cpp, as the repository
transcribes them), written as textbook matrix products: the DFT is a
product with cosine and sine matrices, not an FFT, so that the same code in
float32 with TF32 matmuls is the reference in the precision below the
program's.  The equal-loudness contours are built here (:func:`contours`)
from ISO 226's published tables and the configuration's loudness settings;
only published numbers are frozen, in ``loudness_tables.json``: the ERB
bands' FFT-bin edges and ISO 226:2003's Table 1.  Imports nothing of the
program.

Frame ``j`` covers samples ``[(j+1)·step − fft, (j+1)·step)``, zero beyond
the signal; a file of ``n`` samples has ``ceil(n/step) − 1`` frames.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

__all__ = ["Basis", "contours", "features", "num_frames"]

MEL_BANDS = 42
MEL_SCALE = 1127.01048
MEL_RECIP_700 = 0.001429857
MEL_LOG_FLOOR = 1e-10
MFCC_SCALE, MFCC_OFFSET = 0.1, 0.5
SPECTRAL_MASK = 0.25          # e_k = max(db_k, e_{k-1} · 0.25)
TEMPORAL_MASK = 1.0           # m_t = max(e_t, e_{t-1} · 1.0)
FULL_SCALE_DB = 90.0
SONE_PIVOT_PHON = 40.0
#: dB within which a band's masked level counts as at its audibility
#: threshold: the sone gate there may go either way under rounding
THRESHOLD_MARGIN_DB = 0.05

_TABLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "loudness_tables.json")


def num_frames(n: int, step: int) -> int:
    return max((n + step - 1) // step - 1, 0)


def _mel(f):
    return MEL_SCALE * np.log1p(np.asarray(f, np.float64) * MEL_RECIP_700)


def _hz(m):
    return np.expm1(np.asarray(m, np.float64) / MEL_SCALE) / MEL_RECIP_700


def _iso2003_spl(iso: dict, f, phon):
    """dB SPL of the ``phon`` equal-loudness contour at ``f`` Hz by ISO
    226:2003 §4.1, its parameters linear in log frequency, ``f`` held to
    the table's 20 Hz - 12.5 kHz."""
    fr = np.asarray(iso["freq_hz"])
    lx = np.log10(fr)
    lf = np.log10(np.clip(np.asarray(f, np.float64), fr[0], fr[-1]))
    alpha = np.interp(lf, lx, iso["alpha_f"])
    lu = np.interp(lf, lx, iso["L_U"])
    tf = np.interp(lf, lx, iso["T_f"])
    a_f = (4.47e-3 * (10.0 ** (0.025 * np.asarray(phon, np.float64)) - 1.15)
           + (0.4 * 10.0 ** ((tf + lu) / 10.0 - 9.0)) ** alpha)
    # below the lowest contours the sum goes negative: held at a tiny level
    return 10.0 / alpha * np.log10(np.maximum(a_f, 1e-30)) - lu + 94.0


def _iso2003_slope(iso: dict, ld: dict, f: float) -> float:
    """ISO 226:2003's secant slope dphon/ddB at ``f`` over the operating
    span, its phon levels read off the configuration's grid."""
    lo, hi, n = ld["iso2003_inverse_grid_phon"]
    grid = np.linspace(lo, hi, int(n))
    spl = _iso2003_spl(iso, f, grid)
    top = ld["operating_db"]
    span = ld["operating_span_db"]
    return float(np.interp(top, spl, grid)
                 - np.interp(top - span, spl, grid)) / span


def contours(loudness: dict, iso: dict) -> np.ndarray:
    """``[bands, phons]`` dB of each equal-loudness contour at each ERB
    band's centre, as the configuration's ``loudness`` group defines them
    (ISO 226:1987's analytic loudness level per band, fitted to a target
    slope), floored and made strictly increasing per band."""
    ld = loudness
    ea, eb = ld["erb_scale"]
    bands = 42
    centres = (10.0 ** ((np.arange(bands) + ld["band_centre_erb_offset"])
                        / ea) - 1.0) / eb
    anchors = np.asarray(ld["anchors_hz"], np.float64)
    target = (1.0 - np.log2(1.0 + np.asarray(ld["anchor_err_pct"]) / 100.0)
              + np.asarray(ld["slope_trim"]))
    phons = np.asarray(ld["phons"], np.float64)
    ln0, top_db = ld["ln_at_threshold"], ld["operating_db"]
    u = ld["anchor_phon"] - ln0
    keep = 1.0 - ld["denominator_floor"]
    fr = np.asarray(iso["freq_hz"])
    table = np.empty((bands, len(phons)))
    for k, f in enumerate(centres):
        if f <= anchors[0] or f >= anchors[-1]:
            edge = 0 if f <= anchors[0] else -1
            s = (_iso2003_slope(iso, ld, f) * target[edge]
                 / _iso2003_slope(iso, ld, anchors[edge]))
        else:
            s = float(np.interp(np.log10(1.0 + eb * f),
                                np.log10(1.0 + eb * anchors), target))
        thr = float(np.interp(np.log10(np.clip(f, fr[0], fr[-1])),
                              np.log10(fr), iso["T_f"]))
        xa = max(float(_iso2003_spl(iso, f, ld["anchor_phon"])) - thr,
                 ld["min_level_above_threshold_db"])
        x2 = top_db - thr
        x1 = x2 - ld["operating_span_db"]
        # LN - ln0 = a x / (1 + b x) through (xa, u), with the secant slope
        # a / ((1 + b x1)(1 + b x2)) = s over [x1, x2]: a quadratic in b,
        # of which the root nearest 0 (the straight line where s allows)
        qa, qb, qc = s * x1 * x2, s * (x1 + x2) - u, s - u / xa
        disc = qb * qb - 4.0 * qa * qc
        b = 0.0
        if disc >= 0.0 and abs(qa) > 1e-12:
            r = (-qb + np.array([-1.0, 1.0]) * np.sqrt(disc)) / (2.0 * qa)
            b = float(r[np.argmin(np.abs(r))])
        p_top = phons[-1] - ln0
        if b > 0.0 and p_top > keep * u:
            # the denominator stays above the floor through the top contour
            b = min(b, (keep * u / xa) / (p_top - keep * u))
        a = u * (1.0 + b * xa) / xa
        p = phons - ln0
        table[k] = thr + p / np.maximum(a - b * p, ld["denominator_floor"] * a)
    table = np.maximum(table, ld["floor_db"])
    for j in range(1, table.shape[1]):
        table[:, j] = np.maximum(table[:, j],
                                 table[:, j - 1] + ld["min_step_db"])
    return table


class Basis:
    """The constant matrices at one sample rate and FFT size, float64,
    with the equal-loudness contours of the configuration's ``loudness``
    settings."""

    def __init__(self, rate: float, fft: int, coeffs: int,
                 loudness: dict) -> None:
        with open(_TABLES) as f:
            tab = json.load(f)
        if (tab["sample_rate"], tab["fft_size"]) != (float(rate), fft):
            raise ValueError(f"loudness tables are for {tab['sample_rate']} "
                             f"Hz / FFT {tab['fft_size']}")
        bins = fft // 2 + 1
        n = np.arange(fft)
        freqs = np.arange(bins) * (rate / fft)
        self.hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft)
        w = 2.0 * np.pi / fft * np.outer(n, np.arange(bins))
        self.cos, self.sin = np.cos(w), np.sin(w)
        edges = _hz(np.linspace(_mel(0.0), _mel(rate / 2.0), MEL_BANDS + 2))
        self.mel = np.zeros((bins, MEL_BANDS))
        for b in range(MEL_BANDS):
            lo, mid, hi = edges[b:b + 3]
            up = (freqs - lo) / max(mid - lo, 1e-9)
            down = (hi - freqs) / max(hi - mid, 1e-9)
            self.mel[:, b] = np.clip(np.minimum(up, down), 0.0, 1.0)
        k = np.arange(MEL_BANDS)
        j = np.arange(1, 1 + coeffs)
        self.dct = np.sqrt(2.0 / MEL_BANDS) * np.cos(
            np.pi / MEL_BANDS * np.outer(k + 0.5, j))
        be = np.asarray(tab["erb_band_edges"])
        self.erb = np.zeros((bins, len(be) - 1))
        for b in range(len(be) - 1):
            self.erb[be[b]:be[b + 1], b] = 1.0
        table = contours(loudness, tab["iso226_2003"])
        ext = table[:, -1] + loudness["top_extrapolation"] * (
            table[:, -1] - table[:, -2])
        self.contours = np.concatenate([table, ext[:, None]], axis=1)
        self.phons = np.concatenate([loudness["phons"],
                                     [loudness["top_phon"]]])
        self.threshold = table[:, 0]
        # a full-scale 1 kHz sine reads FULL_SCALE_DB in its ERB band
        kf = 1000.0 * fft / rate
        sine = np.sin(2.0 * np.pi * kf * n / fft) * self.hann
        power = np.abs(np.fft.rfft(sine)) ** 2
        band = min(max(int(np.searchsorted(be, kf, side="right")) - 1, 0),
                   len(be) - 2)
        self.cal_db = FULL_SCALE_DB - 10.0 * np.log10(
            power[be[band]:be[band + 1]].sum())


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for matmuls and convolutions while ``on``; restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def features(pcm: np.ndarray, basis: Basis, step: int, device,
             precision: str = "float64", block: int = 2048):
    """``(feats [1 + coeffs, F], loud_lo [F], loud_hi [F])`` of int16
    ``pcm``.  Row 0 is loudness/32: ``loud_lo``/``loud_hi`` bound it over
    either outcome of the sone gate in bands within THRESHOLD_MARGIN_DB of
    their threshold.  ``precision``: ``"float64"`` (the reference) or
    ``"tf32"`` (float32 with TF32 matmuls: the control).  Frames go through
    in blocks of ``block``, so that the device holds little at a time."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    with _tf32(precision == "tf32"):
        return _features(pcm, basis, step, torch.device(device), dtype,
                         block)


def _features(pcm, basis, step, dev, dtype, block):
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    fft = basis.hann.shape[0]
    total = num_frames(len(pcm), step)
    # int16 samples, zero before the first frame's start and past the end
    padded = torch.zeros(total * step + fft, dtype=torch.int16, device=dev)
    m = min(len(pcm), padded.shape[0] - (fft - step))
    padded[fft - step:fft - step + m] = torch.as_tensor(
        np.ascontiguousarray(pcm[:m], np.int16), device=dev)
    hann, cos, sin = t(basis.hann), t(basis.cos), t(basis.sin)
    mel, dct, erb = t(basis.mel), t(basis.dct), t(basis.erb)
    coeffs, band = [], []
    for r in range(0, total, block):
        n = min(block, total - r)
        x = padded[r * step:(r + n - 1) * step + fft].to(dtype) / 32768.0
        frames = x.unfold(0, fft, step) * hann
        power = (frames @ cos) ** 2 + (frames @ sin) ** 2
        log_e = torch.log10(torch.clamp_min(power @ mel, MEL_LOG_FLOOR))
        coeffs.append((log_e @ dct) * MFCC_SCALE + MFCC_OFFSET)
        band.append(torch.clamp_min(
            10.0 * torch.log10(torch.clamp_min(power @ erb, 1e-30))
            + basis.cal_db, 0.0))
    coeffs = torch.cat(coeffs)
    band_db = torch.cat(band)
    cols, prev = [], torch.zeros_like(band_db[:, 0])
    for k in range(band_db.shape[1]):
        prev = torch.maximum(band_db[:, k], prev * SPECTRAL_MASK)
        cols.append(prev)
    exc = torch.stack(cols, dim=1)
    before = torch.cat([torch.zeros_like(exc[:1]), exc[:-1]])
    masked = torch.maximum(exc, before * TEMPORAL_MASK)
    c = t(basis.contours)
    p = t(basis.phons)
    thr = t(basis.threshold)
    loud, lo, hi = [], [], []
    for r in range(0, total, block):
        mb = masked[r:r + block]
        seg = torch.clamp((mb[..., None] - c[:, :-1]) / (c[:, 1:] - c[:, :-1]),
                          0.0, 1.0)
        phon = p[0] + (seg * (p[1:] - p[:-1])).sum(dim=-1)
        sones = torch.exp2((phon - SONE_PIVOT_PHON) * 0.1)
        on = mb > thr
        near = (mb - thr).abs() <= THRESHOLD_MARGIN_DB
        zero = torch.zeros_like(sones)
        loud.append(torch.where(on, sones, zero).sum(dim=1) / 32.0)
        lo.append(torch.where(on & ~near, sones, zero).sum(dim=1) / 32.0)
        hi.append(torch.where(on | near, sones, zero).sum(dim=1) / 32.0)
    feats = torch.cat([torch.cat(loud)[:, None], coeffs], dim=1).T
    return tuple(v.double().cpu().numpy()
                 for v in (feats, torch.cat(lo), torch.cat(hi)))
