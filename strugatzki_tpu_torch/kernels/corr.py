"""Sliding template correlation (the FFT trace family) in PyTorch.

Port of the trace half of ``strugatzki_tpu/kernels/corr.py``: one rfft per
channel serves the template dots and, through a ones-kernel spectrum, the
sliding window sums and sums of squares.  Templates are pre-centered in f64
on the host and feature matrices pre-shifted per channel group, so the f32
FFT round trip holds the parity budget (see the JAX module's docstring for
the algebra).

Every device function takes ``[..., C, Tp]`` feature stacks: a leading
batch dimension stands in for ``vmap`` over files.  Template statistics and
weights are host scalars (rounded to f32 like the JAX package's
``jnp.float32`` arguments); ``temporal_shift`` is a scalar or a ``[...]``
tensor of per-file shifts.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["prepare_template", "shift_per_group", "sliding_dot_fft",
           "correlation_trace", "trace_spectra",
           "correlation_trace_from_spectra"]


# ---------------------------------------------------------------------------
# host-side preparation (float64, tiny) — copied verbatim from
# strugatzki_tpu/kernels/corr.py, whose module imports jax
# ---------------------------------------------------------------------------

def prepare_template(mat: np.ndarray):
    """Center a template channel-group in f64; return (centered f32, mean, std).

    ``mean``/``std`` come from the single parity anchor
    :func:`~strugatzki_tpu.kernels.mathref.stat` (MathUtil.stat,
    FeatureCorrelationImpl.scala:92-97) so the device template statistics
    can never desynchronize from the host mirror the tests anchor to.
    """
    from strugatzki_tpu.kernels import mathref as M

    m64 = np.asarray(mat, dtype=np.float64)
    mean, std = M.stat(m64, 0, m64.shape[1], 0, m64.shape[0])
    centered = (m64 - mean).astype(np.float32)
    return centered, float(mean), float(std)


def shift_per_group(x: np.ndarray, num_temporal: int = 1):
    """Subtract the global f64 mean of each channel group (temporal = rows
    ``[0:num_temporal)``, spectral = the rest).  Returns (shifted f32,
    temporal_shift, spectral_shift).  Correlations are invariant to this; the
    temporal shift is returned so loudness window means can be recovered for
    the boost estimate."""
    x = np.asarray(x, dtype=np.float32)
    t64 = x[:num_temporal].astype(np.float64)
    s64 = x[num_temporal:].astype(np.float64)
    ts = float(t64.mean()) if t64.size else 0.0
    ss = float(s64.mean()) if s64.size else 0.0
    out = np.empty_like(x)
    out[:num_temporal] = (t64 - ts).astype(np.float32)
    out[num_temporal:] = (s64 - ss).astype(np.float32)
    return out, ts, ss


# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------

def _f32(v) -> float:
    """A host scalar rounded to float32 (the JAX package passes these as
    ``jnp.float32``); exactly representable, so torch casts it losslessly."""
    return float(np.float32(v))


def _fft_len(n: int) -> int:
    """Next power of two ≥ n (the JAX package's rule; cuFFT sizes on the
    H100 are not measured yet)."""
    p = 1
    while p < n:
        p <<= 1
    return p


@lru_cache(maxsize=64)
def _ones_spectrum(length: int, n: int, device: torch.device) -> torch.Tensor:
    """rfft of a length-``length`` ones kernel, built in f64 on the host and
    cast to complex64: correlating with it yields sliding window sums."""
    return torch.as_tensor(
        np.fft.rfft(np.ones(length), n=n).astype(np.complex64), device=device)


def sliding_dot_fft(template: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FFT cross-correlation: ``Σ_c Σ_i template[c,i]·x[...,c,t+i]`` for all
    valid ``t`` → ``[..., T − L + 1]``."""
    L = template.shape[-1]
    T = x.shape[-1]
    W = T - L + 1
    if W <= 0:
        raise ValueError(f"template length {L} exceeds signal length {T}")
    N = _fft_len(T)
    ta = torch.fft.rfft(template, n=N, dim=-1)
    xa = torch.fft.rfft(x, n=N, dim=-1)
    spec = (torch.conj(ta) * xa).sum(dim=-2)
    return torch.fft.irfft(spec, n=N)[..., :W].to(torch.float32)


# ---------------------------------------------------------------------------
# sliding template correlation (FeatureCorrelation)
# ---------------------------------------------------------------------------

def correlation_trace(xs: torch.Tensor,
                      template_t: torch.Tensor, template_s: torch.Tensor,
                      a_std_t: float, a_std_s: float,
                      ln_avg_loud: float, temporal_shift,
                      temp_weight: float, max_boost: float,
                      num_temporal: int = 1):
    """Similarity + boost traces for a template slid over feature matrices.

    * ``xs``: ``[..., C, Tp]`` normalized, group-shifted features,
      zero-padded so ``Tp = W + L − 1`` for ``W`` window positions.
    * ``template_t``/``template_s``: pre-centered template groups
      ``[nt, L]`` / ``[C−nt, L]`` (:func:`prepare_template`).
    * boost(t) = ``exp((lnAvgLoud_template − ln(mean loud window))/0.6)``;
      windows whose boost is not ``≤ max_boost`` get sim = 0, NaN included.
    * a group with zero weight is skipped, keeping NaN/inf from an unused
      degenerate group out of the result.

    Returns ``(sim [..., W], boost [..., W])`` float32.
    """
    X, Xsq = trace_spectra(xs, num_temporal=num_temporal)
    return correlation_trace_from_spectra(
        X, Xsq, xs.shape[-1], template_t, template_s, a_std_t, a_std_s,
        ln_avg_loud, temporal_shift, temp_weight, max_boost,
        num_temporal=num_temporal)


def trace_spectra(xs: torch.Tensor, num_temporal: int = 1):
    """The per-file half of :func:`correlation_trace`: forward spectra of
    every channel (``[..., C, N/2+1]``) plus the two group power rows
    (``[..., 2, N/2+1]``)."""
    nt = num_temporal
    N = _fft_len(xs.shape[-1])
    xs = xs.to(torch.float32)
    X = torch.fft.rfft(xs, n=N, dim=-1)
    t, s = xs[..., :nt, :], xs[..., nt:, :]
    Xsq = torch.fft.rfft(
        torch.cat([(t * t).sum(dim=-2, keepdim=True),
                   (s * s).sum(dim=-2, keepdim=True)], dim=-2), n=N, dim=-1)
    return X, Xsq


def correlation_trace_from_spectra(X: torch.Tensor, Xsq: torch.Tensor,
                                   t_padded: int,
                                   template_t: torch.Tensor,
                                   template_s: torch.Tensor,
                                   a_std_t: float, a_std_s: float,
                                   ln_avg_loud: float, temporal_shift,
                                   temp_weight: float, max_boost: float,
                                   num_temporal: int = 1):
    """:func:`correlation_trace` continued from precomputed
    :func:`trace_spectra` output (``t_padded`` = the original ``xs`` width)."""
    nt = num_temporal
    L = template_t.shape[-1]
    W = t_padded - L + 1
    if W <= 0:
        raise ValueError(
            f"template length {L} exceeds padded signal length {t_padded}")
    N = _fft_len(t_padded)
    ones_l = torch.conj(_ones_spectrum(L, N, X.device))

    def wsum(spec_row):
        return torch.fft.irfft(spec_row * ones_l, n=N)[..., :W]

    s_t = wsum(X[..., :nt, :].sum(dim=-2))
    q_t = wsum(Xsq[..., 0, :])
    s_s = wsum(X[..., nt:, :].sum(dim=-2))
    q_s = wsum(Xsq[..., 1, :])
    mu0 = None if nt == 1 else wsum(X[..., 0, :]) / L
    return _trace_epilogue(X, t_padded, s_t, q_t, s_s, q_s, mu0,
                           template_t, template_s, a_std_t, a_std_s,
                           ln_avg_loud, temporal_shift, temp_weight,
                           max_boost, num_temporal=nt)


def _trace_epilogue(X, t_padded, s_t, q_t, s_s, q_s, mu0,
                    template_t, template_s, a_std_t, a_std_s,
                    ln_avg_loud, temporal_shift, temp_weight, max_boost,
                    num_temporal: int = 1):
    """Window statistics → template dots (2 irffts) → blend → boost gate.
    ``mu0`` is the window mean of channel 0 when ``num_temporal != 1``,
    else ``None`` (reuses ``mu_t``)."""
    nt = num_temporal
    L = template_t.shape[-1]
    W = t_padded - L + 1
    C_s = X.shape[-2] - nt
    N = _fft_len(t_padded)

    n_t = nt * L
    mu_t = s_t / n_t
    var_t = torch.clamp_min(q_t / n_t - mu_t * mu_t, 0.0)
    std_t = torch.sqrt(var_t)

    n_s = C_s * L
    mu_s = s_s / n_s
    var_s = torch.clamp_min(q_s / n_s - mu_s * mu_s, 0.0)
    std_s = torch.sqrt(var_s)

    def tdot(tmpl, rows):
        ta = torch.fft.rfft(tmpl, n=N, dim=-1)
        spec = (torch.conj(ta) * rows).sum(dim=-2)
        return torch.fft.irfft(spec, n=N)[..., :W]

    # a group with zero weight is never evaluated (the JAX package computes
    # it and selects 0 with ``where``: the same values)
    w = _f32(temp_weight)
    one_minus_w = _f32(np.float32(1.0) - np.float32(w))
    zeros = torch.zeros_like(mu_t)
    sim_t = (tdot(template_t, X[..., :nt, :])
             / (std_t * _f32(a_std_t) * n_t)) if w > 0.0 else zeros
    sim_s = (tdot(template_s, X[..., nt:, :])
             / (std_s * _f32(a_std_s) * n_s)) if w < 1.0 else zeros
    sim = sim_t * w + sim_s * one_minus_w

    # loudness boost: window mean of (unshifted) channel 0 — NOT the whole
    # temporal group (FeatureCorrelationImpl.scala:73-78)
    if mu0 is None:
        mu0 = mu_t
    shift = torch.as_tensor(temporal_shift, dtype=torch.float32,
                            device=mu0.device)
    loud_mean = mu0 + shift[..., None]
    boost = torch.exp((_f32(ln_avg_loud) - torch.log(loud_mean)) / 0.6)
    # `<=` is false for a NaN boost: such windows are gated to 0
    sim = torch.where(boost <= _f32(max_boost), sim, 0.0)
    return sim.to(torch.float32), boost.to(torch.float32)
