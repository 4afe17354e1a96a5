"""DSP front-end constants: transcription of the SuperCollider UGens.

The reference delegates feature extraction to two C++ UGens inside
SuperCollider's scsynth (reference impl/FeatureExtractionImpl.scala:50-54,
README.md:79): ``MFCC.kr(chain, numCoeffs)`` by Dan Stowell and
``Loudness.kr(chain) / 32`` by Nick Collins, both implemented in SC's
``server/plugins/ML.cpp``.  This module freezes the constants of this
framework's transcription of those algorithms; per-constant provenance and
confidence are documented in docs/ML_DERIVATION.md, and the loudness band /
contour tables live in :mod:`strugatzki_tpu_torch.dsp.ml_tables`.

Interop note: quantities that are *per-channel affine* wash out of every
default analysis — each channel is normalized by the database-wide p01/p99
range (``feat_norms.aif``, reference MathUtil.scala:132-152) and the
correlation math is Pearson-style (mean/σ removed).  What cannot wash out,
and is therefore transcribed rather than designed here, is the nonlinear
structure: mel/ERB band layouts, the log law, the masking model, the
equal-loudness correction, and the phon→sone law the boost estimator
inverts (notes/BoostFactor.txt).
"""

from __future__ import annotations

import numpy as np

from .ml_tables import ERB_BANDS  # noqa: F401  (re-export)

# ---------------------------------------------------------------------------
# MFCC (ML.cpp, Dan Stowell)
# ---------------------------------------------------------------------------

#: Number of triangular mel bands (fixed 42 in ML.cpp; numCoeffs selects how
#: many DCT outputs are kept, ≤ 42).
MEL_BANDS = 42

#: ML.cpp's mel scale literals: mel(f) = 1127.01048 · ln(1 + f·0.001429857).
#: (0.001429857 is the file's literal reciprocal-of-700; kept verbatim.)
MEL_SCALE = 1127.01048
MEL_RECIP_700 = 0.001429857

#: Band layout: 42 triangles equally spaced in mel over [0, Nyquist] — 44
#: edge points at i · mel(nyquist)/43, band b rising over [edge_b, edge_{b+1}]
#: and falling over [edge_{b+1}, edge_{b+2}].
MEL_FMIN = 0.0

#: Floor inside the log to avoid -inf on silent bands.
MEL_LOG_FLOOR = 1e-10

#: The DCT keeps coefficients 1..numCoeffs (the 0th/DC cepstral coefficient,
#: overall energy, is not output — per the UGen's documentation; loudness
#: carries the energy channel instead).
DCT_FIRST_COEFF = 1

#: Affine output mapping: out = coeff · MFCC_SCALE + MFCC_OFFSET — the
#: UGen's "scaled to approximately 0..1" convention.  Being per-channel
#: affine, the exact values are invariant under the default normalization
#: (see module docstring).
MFCC_SCALE = 0.1
MFCC_OFFSET = 0.5


def mel_of_hz(f):
    """ML.cpp mel scale."""
    return MEL_SCALE * np.log1p(np.asarray(f, dtype=np.float64) * MEL_RECIP_700)


def hz_of_mel(m):
    return np.expm1(np.asarray(m, dtype=np.float64) / MEL_SCALE) / MEL_RECIP_700


# ---------------------------------------------------------------------------
# Loudness (ML.cpp, Nick Collins)
# ---------------------------------------------------------------------------

#: UGen parameter defaults (``Loudness.kr(chain, smask: 0.25, tmask: 1)``)
#: — the reference always calls it with defaults
#: (FeatureExtractionImpl.scala:52).  ``smask``: lower bands mask higher
#: bands; ``tmask``: a frame masks its successor.  Both act as
#: multiplicative factors on the masker's (non-negative) dB excitation.
SPECTRAL_MASK_DEFAULT = 0.25
TEMPORAL_MASK_DEFAULT = 1.0

#: Digital→acoustic calibration: a full-scale (0 dBFS) sine is assigned
#: this band SPL, so it reads ~90 phon → 2^((90−40)/10) = 32 sones —
#: exactly the reference's ``Loudness.kr(chain) / 32`` headroom
#: (FeatureExtractionImpl.scala:52): a full-scale sine maps to ≈1.0 on the
#: loudness channel, and the help file's "output typically 0..64 sones".
FULL_SCALE_DB = 90.0

#: Stevens' law pivot: 40 phon = 1 sone, doubling per +10 phon.  This is
#: the exact law the reference's boost estimator inverts
#: (notes/BoostFactor.txt: boost = exp(Δln/0.6), 0% error at 1 kHz ⇔
#: sone ∝ amp^(2·log10 2) ≈ amp^0.602 there).
SONE_PIVOT_PHON = 40.0

# ---------------------------------------------------------------------------
# Structural hypotheses under experimental discrimination
# ---------------------------------------------------------------------------
# Four ML.cpp details remain C-grade reconstructions (docs/ML_DERIVATION.md):
# what the MFCC triangles sum (power vs magnitude), the MFCC log floor, the
# two masking update forms, and the absolute dB calibration.  Each is held
# behind a named hypothesis here so ``tools/discriminate_constants.py`` can
# extract the same probe signal under every candidate and score which one a
# reference-extracted feature file matches (per-channel affine-invariant
# residual).  The defaults are the shipped transcription; change them only
# through :func:`set_hypothesis` (it invalidates the compiled pipelines).

#: What the mel triangles integrate: ``"power"`` (re²+im², the shipped
#: choice — avoids per-bin sqrt in a per-block UGen) or ``"magnitude"``.
#: A global power↔magnitude factor washes out (log → spectral scale), but
#: band *contrast* between tonal and broadband content does not.
MEL_BAND_INPUT = "power"

#: Spectral masking update: ``"factor_db"`` (the shipped form,
#: e_k = max(db_k, e_{k−1}·smask): the factor scales the dB value) or
#: ``"factor_intensity"`` (the factor scales the masker's intensity —
#: equivalently e_k = max(db_k, e_{k−1} + 10·log10 smask), a constant
#: −6.02 dB/band skirt at the default 0.25).
SMASK_FORM = "factor_db"

#: Temporal masking update: ``"prev_frame"`` (the shipped one-frame-deep
#: form, m_t = max(e_t, e_{t−1}·tmask)) or ``"feedback"``
#: (m_t = max(e_t, m_{t−1}·tmask): the masked output feeds back — an
#: unbounded running max at the default tmask = 1, which the UGen's
#: decaying output argues against, but kept as a testable candidate).
TMASK_FORM = "prev_frame"

#: candidate values per structural hypothesis (the discriminator scans
#: these; numeric constants MEL_LOG_FLOOR / FULL_SCALE_DB are scanned over
#: numeric grids instead)
HYPOTHESES = {
    "MEL_BAND_INPUT": ("power", "magnitude"),
    "SMASK_FORM": ("factor_db", "factor_intensity"),
    "TMASK_FORM": ("prev_frame", "feedback"),
}


def set_hypothesis(**kw) -> None:
    """Set structural/numeric DSP hypotheses and invalidate every compiled
    pipeline that baked the old values (the structural branches are traced
    statically; lru/jit caches would silently keep serving stale code).

    Accepts the three structural names above plus ``MEL_LOG_FLOOR`` and
    ``FULL_SCALE_DB``.  Discrimination tooling only — production code uses
    the shipped defaults."""
    import sys as _sys
    g = globals()
    for name, value in kw.items():
        if name in HYPOTHESES:
            if value not in HYPOTHESES[name]:
                raise ValueError(f"{name}: unknown candidate {value!r} "
                                 f"(choose from {HYPOTHESES[name]})")
        elif name not in ("MEL_LOG_FLOOR", "FULL_SCALE_DB"):
            raise ValueError(f"unknown hypothesis {name!r}")
        g[name] = value
    fe = _sys.modules.get("strugatzki_tpu_torch.dsp.frontend")
    if fe is not None:   # the port's frontend has no jit caches
        fe.make_basis.cache_clear()
        fe._device_consts.cache_clear()
