"""Tables for the SuperCollider ``Loudness.kr`` UGen transcription.

The reference's loudness channel is produced by Nick Collins' ``Loudness``
UGen from SuperCollider's machine-listening plugin file ``server/plugins/
ML.cpp`` (invoked at reference impl/FeatureExtractionImpl.scala:52,
attribution README.md:79).  That UGen is an MP3-style perceptual model:

    FFT power → 42 ERB-spaced band intensities → dB → spectral masking
    (``smask``) → temporal masking (``tmask``) → equal-loudness-contour
    correction (dB → phon, per band) → phon → sone → Σ over bands

This module freezes the tables that parameterize it.  Provenance and
per-constant confidence are documented in docs/ML_DERIVATION.md; in brief:

* ``EQL_BAND_BINS`` — the FFT-bin partition of the 42 ERB bands for the
  44.1 kHz / FFT-1024 configuration, transcribed from ML.cpp's
  ``eqlbandbins`` table.  It is exactly reproduced by the rule
  ``bin_k = max(prev + 1, ceil(bin(E = k)))`` on the Glasberg–Moore ERB
  scale ``E(f) = 21.4·log10(1 + 0.00437·f)`` (verified entry-for-entry by
  :func:`erb_band_edges`), which is also used to generalize the partition
  to other sample rates / FFT sizes the way ML.cpp cannot.
* ``PHONS`` — the 11 loudness levels at which ML.cpp tabulates its
  equal-loudness contours (``static float phons[11]``).
* The contour *values* (``contours[42][11]`` in ML.cpp) are not
  recoverable in this sandbox; two reconstructions ship, selected by
  :func:`set_contour_model`.  The DEFAULT is ``"rd1987"``: pre-2003
  (Robinson–Dadson era) contours built from ISO 226:1987's analytic
  loudness-level form, with per-band slopes fitted so the full extraction
  pipeline reproduces ALL NINE of the reference author's measured
  boost-error anchors to ≤0.3 percentage points
  (notes/BoostFactor.txt:20-29; fit: tools/fit_contours.py, residual
  table in docs/ML_DERIVATION.md).  The alternative ``"iso2003"`` rebuild
  evaluates the ISO 226:2003 standard at the band centres — it matches
  the 200–1000 Hz and 5–10 kHz anchors but measurably lacks the UGen's
  28–30% error bump at 3–4 kHz, which is why it is not the default.
  Both are anchored phon ≡ dB SPL at 1 kHz (BoostFactor.txt reports 0%
  error there).  A verbatim ML.cpp table, once probed from a scsynth
  install, drops in via :func:`load_contour_table` /
  ``STRUGATZKI_CONTOURS`` and overrides either model.
"""

from __future__ import annotations

import os
import sys
from functools import lru_cache

import numpy as np

__all__ = [
    "ERB_BANDS", "PHONS", "EQL_BAND_BINS_44100_1024", "erb_band_edges",
    "band_centers_hz", "iso226_spl", "contour_table", "load_contour_table",
    "rd_contour_table", "rd_slope_target", "set_contour_model",
]

#: Number of ERB-spaced loudness bands (ML.cpp uses a fixed 42).
ERB_BANDS = 42

#: The 11 loudness levels (phon) of the contour table
#: (ML.cpp ``static float phons[11]``).
PHONS = np.array([2.0, 10.0, 20.0, 30.0, 40.0, 50.0,
                  60.0, 70.0, 80.0, 90.0, 100.0])

#: ML.cpp ``static int eqlbandbins[43]`` — for sample rate 44100, FFT 1024
#: (513 rfft bins): band k sums power over bins
#: ``[EQL_BAND_BINS[k], EQL_BAND_BINS[k+1])``.  Band 0 starts at bin 1, so
#: DC never contributes; the final edge 513 is the exclusive end past the
#: Nyquist bin.  (ML.cpp pairs this with ``eqlbandsizes[42]`` holding the
#: same information as consecutive differences.)
EQL_BAND_BINS_44100_1024 = np.array([
    1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 15, 17, 19, 22, 25, 28, 32, 36,
    41, 46, 52, 58, 65, 73, 82, 92, 103, 116, 129, 144, 161, 180, 201,
    225, 251, 280, 312, 348, 388, 433, 483, 513], dtype=np.int64)

# Glasberg & Moore (1990) ERB scale constants (the scale under ML.cpp's
# band table — see module docstring).
_ERB_A = 21.4
_ERB_B = 0.00437


def _erb_of_hz(f):
    return _ERB_A * np.log10(1.0 + _ERB_B * np.asarray(f, np.float64))


def _hz_of_erb(e):
    return (10.0 ** (np.asarray(e, np.float64) / _ERB_A) - 1.0) / _ERB_B


@lru_cache(maxsize=16)
def erb_band_edges(sample_rate: float, fft_size: int) -> np.ndarray:
    """43 FFT-bin edges of the 42 loudness bands.

    Reproduces ML.cpp's ``eqlbandbins`` exactly for (44100, 1024) from the
    ERB rule ``bin_k = max(prev + 1, ceil(f(E=k) / binwidth))`` with the
    final edge clamped to the bin past Nyquist; for other configurations it
    generalizes the same rule (the UGen itself is hard-coded to
    44.1 kHz / 1024 — a documented limitation this rebuild lifts).
    """
    binw = sample_rate / fft_size
    nbins = fft_size // 2 + 1
    edges = np.empty(ERB_BANDS + 1, np.int64)
    prev = 0
    for k in range(ERB_BANDS):
        b = int(np.ceil(_hz_of_erb(k + 1.0) / binw))
        b = max(b, prev + 1)
        edges[k] = b
        prev = b
    edges[ERB_BANDS] = nbins
    # keep edges within range for tiny FFTs: clamp and dedupe upward
    edges = np.minimum(edges, nbins)
    for k in range(1, ERB_BANDS + 1):
        edges[k] = max(edges[k], min(edges[k - 1] + 1, nbins))
    if (sample_rate, fft_size) == (44100.0, 1024):
        assert np.array_equal(edges, EQL_BAND_BINS_44100_1024)
    return edges


def band_centers_hz(sample_rate: float, fft_size: int) -> np.ndarray:
    """Band-centre frequencies: band k spans ERB numbers [k+1, k+2] (its bin
    edges are at E=k+1 and E=k+2), so the centre is the ERB midpoint
    E = k + 1.5 mapped back to Hz."""
    del sample_rate, fft_size  # centres are scale-defined, not bin-defined
    return _hz_of_erb(np.arange(ERB_BANDS, dtype=np.float64) + 1.5)


# ---------------------------------------------------------------------------
# ISO 226:2003 equal-loudness contours
# ---------------------------------------------------------------------------

#: ISO 226:2003 tabulated frequencies (Hz) and parameters α_f, L_U, T_f.
_ISO_F = np.array([
    20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0, 200.0,
    250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0,
    2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0,
    12500.0])
_ISO_ALPHA = np.array([
    0.532, 0.506, 0.480, 0.455, 0.432, 0.409, 0.387, 0.367, 0.349, 0.330,
    0.315, 0.301, 0.288, 0.276, 0.267, 0.259, 0.253, 0.250, 0.246, 0.244,
    0.243, 0.243, 0.243, 0.242, 0.242, 0.245, 0.254, 0.271, 0.301])
_ISO_LU = np.array([
    -31.6, -27.2, -23.0, -19.1, -15.9, -13.0, -10.3, -8.1, -6.2, -4.5,
    -3.1, -2.0, -1.1, -0.4, 0.0, 0.3, 0.5, 0.0, -2.7, -4.1, -1.0, 1.7,
    2.5, 1.2, -2.1, -7.1, -11.2, -10.7, -3.1])
_ISO_TF = np.array([
    78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4,
    11.4, 8.6, 6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0, -5.4,
    -1.5, 6.0, 12.6, 13.9, 12.3])


def iso226_spl(freq_hz, phon) -> np.ndarray:
    """Sound pressure level (dB SPL) of the ``phon`` equal-loudness contour
    at ``freq_hz`` per ISO 226:2003 §4.1.  Frequencies are clamped to the
    standard's 20 Hz – 12.5 kHz tabulation (flat extension above — the top
    two loudness bands sit beyond the standard's range); parameters are
    interpolated linearly in log-frequency.  Exactly anchored at 1 kHz:
    SPL(1000, P) = P."""
    f = np.clip(np.asarray(freq_hz, np.float64), _ISO_F[0], _ISO_F[-1])
    lf = np.log10(f)
    lx = np.log10(_ISO_F)
    alpha = np.interp(lf, lx, _ISO_ALPHA)
    lu = np.interp(lf, lx, _ISO_LU)
    tf = np.interp(lf, lx, _ISO_TF)
    ln = np.asarray(phon, np.float64)
    a_f = (4.47e-3 * (10.0 ** (0.025 * ln) - 1.15)
           + (0.4 * 10.0 ** ((tf + lu) / 10.0 - 9.0)) ** alpha)
    return 10.0 / alpha * np.log10(np.maximum(a_f, 1e-30)) - lu + 94.0


# ---------------------------------------------------------------------------
# Pre-2003 (Robinson–Dadson era) contours, fitted to the reference's
# measured boost-error anchors
# ---------------------------------------------------------------------------
#
# The reference author measured the boost estimator ``exp(Δln/0.6)`` against
# the real scsynth Loudness UGen at nine frequencies (reference
# notes/BoostFactor.txt:20-29).  For a 0.5 attenuation the error is set by
# the local contour slope s = Δphon/ΔdB at the operating level:
# err = 2^(1−s) − 1 (docs/ML_DERIVATION.md).  The ISO 226:2003 rebuild
# reproduces the 200–1000 Hz and 5–10 kHz anchors but lacks the UGen's
# 28–30% bump at 3–4 kHz — ML.cpp tabulates steeper pre-2003
# (Robinson–Dadson era) data there.  This section rebuilds the contours the
# pre-2003 way: ISO 226:1987's own analytic form per band,
#
#     LN(L) = 4.2 + a·(L − T) / (1 + b·(L − T))          [phon]
#
# (the 1987 standard expresses loudness level exactly so, with a, b, T
# frequency-dependent), with (a, b) solved per band so the curve (i) passes
# through the 90-phon contour position and (ii) has the anchor-implied
# secant slope over the experiment's 84→90 dB operating span.  Between
# anchors the slope field is interpolated on the ERB scale; beyond the
# anchored 200 Hz–10 kHz span it follows the ISO-2003 local slope scaled to
# match the edge anchor.  ``_RD_SLOPE_TRIM`` holds per-anchor corrections
# fitted by running the author's actual experiment through this pipeline
# (tools/fit_contours.py) — they absorb band-centre offsets, the 11-point
# sampling of the analytic curve, and window leakage.

#: the nine measured anchors (Hz → signed % error at 0.5 attenuation).
#: Magnitudes are the reference's (notes/BoostFactor.txt:20-29); the note
#: does not record signs, which are assigned by contour physics: low
#: frequencies compress with level (slope > 1 ⇒ negative), the 2–5 kHz
#: sensitivity-dip region spreads with level (slope < 1 ⇒ positive, the
#: only reading that makes 30% reachable), and 10 kHz takes the sign the
#: ISO-2003 rebuild independently measured there (−5.5%).
_RD_ANCHORS_HZ = np.array(
    [200.0, 300.0, 400.0, 1000.0, 2000.0, 3000.0, 4000.0, 5000.0, 10000.0])
_RD_ANCHOR_ERR = np.array(
    [-20.0, -10.0, -2.4, 0.0, 10.0, 30.0, 28.0, 3.0, -5.0])

#: anchor-implied operating-level slopes s = 1 − log2(1 + err/100)
_RD_SLOPES = 1.0 - np.log2(1.0 + _RD_ANCHOR_ERR / 100.0)

#: per-anchor additive slope trims from the pipeline-in-the-loop fit
#: (tools/fit_contours.py, 2026-08-16: 6 rounds to max residual 0.26
#: points; realized profile −19.9/−10.2/−2.4/0.0/+10.0/+30.0/+27.7/+3.1/
#: −5.0 vs the reference's 20/10/2.4/0/10/30/28/3/5)
_RD_SLOPE_TRIM = np.array(
    [0.086960, -0.018721, -0.022243, -0.004921, -0.018653, -0.077906,
     -0.140364, 0.042978, -0.000928])

#: operating band level of the experiment's full-scale sine (dB; equals
#: dsp.constants.FULL_SCALE_DB by calibration) and the 0.5-attenuation span
_RD_OP_DB = 90.0
_RD_OP_SPAN_DB = 20.0 * np.log10(2.0)   # 6.0206 dB

#: the 1987 formula's loudness level at threshold (LN(T) = 4.2 phon)
_RD_LN0 = 4.2


def _threshold_spl(freq_hz) -> np.ndarray:
    """Threshold of hearing T_f (dB SPL), interpolated in log-frequency from
    the ISO tabulation (thresholds changed little between the 1987 and 2003
    revisions, unlike the supra-threshold contours)."""
    f = np.clip(np.asarray(freq_hz, np.float64), _ISO_F[0], _ISO_F[-1])
    return np.interp(np.log10(f), np.log10(_ISO_F), _ISO_TF)


def _phon_of_spl_2003(freq_hz: float, spl) -> np.ndarray:
    """Invert :func:`iso226_spl` in phon (fine-grid interpolation)."""
    grid = np.linspace(0.5, 135.0, 540)
    spls = iso226_spl(freq_hz, grid)
    return np.interp(np.asarray(spl, np.float64), spls, grid)


def _slope_2003(freq_hz: float) -> float:
    """ISO-2003 secant slope Δphon/ΔdB over the experiment's operating
    span — the baseline the out-of-anchor extension scales."""
    lo = _phon_of_spl_2003(freq_hz, _RD_OP_DB - _RD_OP_SPAN_DB)
    hi = _phon_of_spl_2003(freq_hz, _RD_OP_DB)
    return float(hi - lo) / _RD_OP_SPAN_DB


def rd_slope_target(freq_hz: float) -> float:
    """Target operating-level slope at ``freq_hz``: anchor slopes (+ fitted
    trims) interpolated on the ERB scale, extended beyond the anchored span
    by scaling the ISO-2003 local slope to match the edge anchor."""
    s_anchor = _RD_SLOPES + _RD_SLOPE_TRIM
    if freq_hz <= _RD_ANCHORS_HZ[0]:
        base = _slope_2003(_RD_ANCHORS_HZ[0])
        return float(_slope_2003(freq_hz) * s_anchor[0] / base)
    if freq_hz >= _RD_ANCHORS_HZ[-1]:
        base = _slope_2003(_RD_ANCHORS_HZ[-1])
        return float(_slope_2003(freq_hz) * s_anchor[-1] / base)
    e = _erb_of_hz(freq_hz)
    return float(np.interp(e, _erb_of_hz(_RD_ANCHORS_HZ), s_anchor))


def rd_contour_table(sample_rate: float, fft_size: int) -> np.ndarray:
    """``[ERB_BANDS, len(PHONS)]`` pre-2003-era contour dB values (see the
    section comment above).  Per band: T from the threshold tabulation,
    anchored at the 90-phon contour position, (a, b) from the closed-form
    quadratic that matches the target secant slope over the 84→90 dB span;
    the row is then ``C(P) = T + (P − 4.2)/(a − b·(P − 4.2))`` — strictly
    increasing wherever the denominator stays positive (guarded)."""
    centers = band_centers_hz(sample_rate, fft_size)
    table = np.empty((ERB_BANDS, len(PHONS)), np.float64)
    anchor_phon = 90.0
    u = anchor_phon - _RD_LN0
    for k, f in enumerate(centers):
        t_f = float(_threshold_spl(f))
        la = float(iso226_spl(f, anchor_phon))
        xa = max(la - t_f, 1.0)
        x2 = _RD_OP_DB - t_f
        x1 = x2 - _RD_OP_SPAN_DB
        s = rd_slope_target(float(f))
        # s = a/((1+b·x1)(1+b·x2)) with a = u(1+b·xa)/xa  ⇒  quadratic in b
        qa = s * x1 * x2
        qb = s * (x1 + x2) - u
        qc = s - u / xa
        disc = qb * qb - 4.0 * qa * qc
        if disc >= 0.0 and abs(qa) > 1e-12:
            r = np.sqrt(disc)
            roots = np.array([(-qb - r), (-qb + r)]) / (2.0 * qa)
            b = float(roots[np.argmin(np.abs(roots))])
        else:
            b = 0.0
        # keep the denominator positive (no saturation) through the top
        # contour: a − b(100 − 4.2) ≥ 0.05·a
        p_top = PHONS[-1] - _RD_LN0
        if b > 0.0 and p_top > 0.95 * u:
            # closed form of a − b·p_top = 0.05a with a = u(1+b·xa)/xa
            b = min(b, (0.95 * u / xa) / (p_top - 0.95 * u))
        a = u * (1.0 + b * xa) / xa
        p = PHONS - _RD_LN0
        denom = np.maximum(a - b * p, 0.05 * a)
        table[k] = t_f + p / denom
    return table


#: verbatim ``contours[42][11]`` override (see :func:`load_contour_table`)
_EXACT_CONTOURS: "np.ndarray | None" = None

#: active contour reconstruction: "rd1987" (pre-2003 era, fitted to the
#: reference's measured anchors — the default, because it reproduces the
#: boost-error profile the ISO-2003 rebuild measurably cannot) or "iso2003"
_CONTOUR_MODEL = "rd1987"


def set_contour_model(name: str) -> None:
    """Select the contour reconstruction: ``"rd1987"`` (default) or
    ``"iso2003"``.  A verbatim :func:`load_contour_table` still wins."""
    global _CONTOUR_MODEL
    if name not in ("rd1987", "iso2003"):
        raise ValueError(f"unknown contour model {name!r}")
    _CONTOUR_MODEL = name
    contour_table.cache_clear()
    fe = sys.modules.get("strugatzki_tpu_torch.dsp.frontend")
    if fe is not None:
        fe.make_basis.cache_clear()
        fe._device_consts.cache_clear()


def load_contour_table(values) -> None:
    """Install ML.cpp's verbatim ``contours[42][11]`` table for the
    44.1 kHz / FFT-1024 configuration — the drop-in for a source-check
    session (docs/ML_DERIVATION.md: the one table not reconstructible
    offline).  Accepts band-major ``[42, 11]`` (ML.cpp's layout) or
    phon-major ``[11, 42]`` (transposed automatically; contour rows must
    be increasing in dB, which disambiguates the two).  The same
    monotonicity/audibility conditioning as the built-in reconstruction is
    applied.  Pass ``None`` to revert."""
    global _EXACT_CONTOURS
    contour_table.cache_clear()
    fe = sys.modules.get("strugatzki_tpu_torch.dsp.frontend")
    if fe is not None:  # drop cached bases built from the old table
        fe.make_basis.cache_clear()
        fe._device_consts.cache_clear()
    if values is None:
        _EXACT_CONTOURS = None
        return
    arr = np.asarray(values, np.float64)
    if arr.shape == (len(PHONS), ERB_BANDS):
        arr = arr.T
    elif arr.size == ERB_BANDS * len(PHONS) and arr.ndim <= 1:
        arr = arr.reshape(ERB_BANDS, len(PHONS))
    if arr.shape != (ERB_BANDS, len(PHONS)):
        raise ValueError(
            f"contour table must be [{ERB_BANDS}, {len(PHONS)}] "
            f"(band-major) or its transpose, got {arr.shape}")
    if not (np.diff(arr, axis=1) > 0).all():
        raise ValueError(
            "contour rows must be strictly increasing in dB per band — "
            "got a table that looks phon-major or scrambled")
    _EXACT_CONTOURS = arr


@lru_cache(maxsize=16)
def contour_table(sample_rate: float, fft_size: int) -> np.ndarray:
    """``[ERB_BANDS, len(PHONS)]`` dB values of each contour at each band
    centre (the transcription of ML.cpp's ``contours[42][11]``).

    A verbatim table installed via :func:`load_contour_table` (or the
    ``STRUGATZKI_CONTOURS`` env var: a text file ``np.loadtxt`` can read,
    42×11) takes precedence for the UGen's native 44.1 kHz / FFT-1024
    configuration.

    Two pragmatic adjustments, both confined to signal levels far below
    program material: every entry is floored at +0.1 dB so digital silence
    (banded power clamped at 0 dB) always falls below the first (2-phon)
    contour and yields exactly zero sones, and rows are forced strictly
    increasing so the dB → phon interpolation is well defined.
    """
    if (_EXACT_CONTOURS is not None
            and (sample_rate, fft_size) == (44100.0, 1024)):
        table = _EXACT_CONTOURS.copy()
    elif _CONTOUR_MODEL == "rd1987":
        table = rd_contour_table(sample_rate, fft_size)
    else:
        centers = band_centers_hz(sample_rate, fft_size)
        table = np.empty((ERB_BANDS, len(PHONS)), np.float64)
        for j, p in enumerate(PHONS):
            table[:, j] = iso226_spl(centers, p)
    table = np.maximum(table, 0.1)
    for j in range(1, len(PHONS)):
        table[:, j] = np.maximum(table[:, j], table[:, j - 1] + 0.01)
    return table


if os.environ.get("STRUGATZKI_CONTOUR_MODEL"):
    set_contour_model(os.environ["STRUGATZKI_CONTOUR_MODEL"])

if os.environ.get("STRUGATZKI_CONTOURS"):
    try:
        load_contour_table(
            np.loadtxt(os.environ["STRUGATZKI_CONTOURS"], dtype=np.float64))
    except Exception as e:
        raise RuntimeError(
            f"STRUGATZKI_CONTOURS: cannot load contour table from "
            f"{os.environ['STRUGATZKI_CONTOURS']!r}: {e}") from e
