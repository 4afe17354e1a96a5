"""Sliding-correlation kernels in PyTorch.

Port of ``strugatzki_tpu/kernels/corr.py``:

* **sliding template correlation** (FeatureCorrelation, CrossSimilarity):
  one rfft per channel serves the template dots and, through a ones-kernel
  spectrum, the sliding window sums and sums of squares;
* **novelty curve** (FeatureSegmentation): ``correlateHalf`` at every window
  position from a lag product plus FFT window sums;
* **gram similarity** (SelfSimilarity): ``correlateHalf`` over window pairs
  from one matmul per channel group plus per-window sums.

Templates are pre-centered in f64 on the host and feature matrices
pre-shifted per channel group, which holds the template traces' parity
budget in f32 (see the JAX module's docstring for the algebra).  The two
``correlateHalf`` families compute their statistics in float64 instead:
their ``q/N − μ²`` has no template centering to rescue it (see
:func:`novelty_trace`).

Every device function takes ``[..., C, Tp]`` feature stacks (``[..., B, C,
h]`` window blocks for the gram): a leading batch dimension stands in for
``vmap``.  Template statistics and weights are host scalars (rounded to f32
like the JAX package's ``jnp.float32`` arguments); ``temporal_shift`` is a
scalar or a ``[...]`` tensor of per-file shifts.  A group whose blend weight
is zero is never evaluated (the JAX package computes it and selects 0 with
``where``: the same values).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["prepare_template", "shift_per_group", "sliding_dot_fft",
           "correlation_trace", "trace_spectra",
           "correlation_trace_from_spectra", "forward_spectra",
           "pack_spectra", "unpack_spectra", "window_sum_table",
           "correlation_trace_from_sums", "novelty_trace",
           "extract_windows", "window_stats", "gram_similarity_block"]


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
def _ones_spectrum(length: int, n: int, device: torch.device,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """rfft of a length-``length`` ones kernel, built in f64 on the host and
    cast to ``dtype``: correlating with it yields sliding window sums."""
    return torch.as_tensor(np.fft.rfft(np.ones(length), n=n), dtype=dtype,
                           device=device)


def _blend(temp_weight: float, temporal, spectral):
    """``temporal()·w + spectral()·(1 − w)`` with ``1 − w`` rounded to f32;
    a group whose weight is zero is never evaluated, which keeps NaN/inf
    from an unused degenerate group out of the result."""
    w = _f32(temp_weight)
    sim_t = temporal() if w > 0.0 else 0.0
    sim_s = spectral() if w < 1.0 else 0.0
    return sim_t * w + sim_s * _f32(np.float32(1.0) - np.float32(w))


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


# ---------------------------------------------------------------------------
# the compact spectra cache: reduced planar spectra + window-sum tables
# ---------------------------------------------------------------------------

def forward_spectra(xs: torch.Tensor) -> torch.Tensor:
    """Per-channel forward spectra only (``X`` of :func:`trace_spectra`,
    ``[..., C, N/2+1]``): the half the sums-based trace needs."""
    N = _fft_len(xs.shape[-1])
    return torch.fft.rfft(xs.to(torch.float32), n=N, dim=-1)


def pack_spectra(z: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """Complex spectra → planar ``(re, im)`` tensors of a real ``dtype``
    (round to nearest even, as XLA casts).  Bfloat16 halves a spectra
    cache and puts ~1e-3 of noise on the sims traced from it."""
    return z.real.to(dtype), z.imag.to(dtype)


def unpack_spectra(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_spectra`: any real dtype pair → complex64."""
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def window_sum_table(xs: torch.Tensor, num_temporal: int = 1) -> torch.Tensor:
    """Exclusive prefix sums of the window-statistic rows of ``[..., C,
    Tp]`` features: ``[..., R, Tp+1]`` float32 with rows ``[Σ_t x, Σ_t x²,
    Σ_s x, Σ_s x²]`` (plus an ``x[0]`` row when ``num_temporal != 1``: the
    boost averages channel 0 alone).  A length-``L`` window sum is then
    ``P[..., L:] − P[..., :W]``, no inverse FFT.

    The table stays float32 as in the JAX package, so the error of a window
    sum is absolute in the prefix magnitude: about ``eps32 · max|P|`` (the
    scan order of ``torch.cumsum`` and XLA's differ, the bound does not),
    which for a low-energy window near the end of a long row is far more
    than the ~1e-5 relative the JAX docstring claims.  Hold anything traced
    from it to a tolerance sized from ``max|P|``, not from the window."""
    nt = num_temporal
    xs = xs.to(torch.float32)
    t, s = xs[..., :nt, :], xs[..., nt:, :]
    rows = [t.sum(dim=-2), (t * t).sum(dim=-2),
            s.sum(dim=-2), (s * s).sum(dim=-2)]
    if nt != 1:
        rows.append(xs[..., 0, :])
    r = torch.stack(rows, dim=-2)
    zero = torch.zeros(r.shape[:-1] + (1,), dtype=torch.float32,
                       device=r.device)
    return torch.cat([zero, torch.cumsum(r, dim=-1, dtype=torch.float32)],
                     dim=-1)


def correlation_trace_from_sums(X: torch.Tensor, sums: torch.Tensor,
                                t_padded: int,
                                template_t: torch.Tensor,
                                template_s: torch.Tensor,
                                a_std_t: float, a_std_s: float,
                                ln_avg_loud: float, temporal_shift,
                                temp_weight: float, max_boost: float,
                                num_temporal: int = 1):
    """:func:`correlation_trace` continued from forward spectra ``X`` and a
    :func:`window_sum_table`: the 2-irfft trace (template dots only) of the
    compact spectra cache."""
    nt = num_temporal
    L = template_t.shape[-1]
    W = t_padded - L + 1
    if W <= 0:
        raise ValueError(
            f"template length {L} exceeds padded signal length {t_padded}")

    def wsum(r: int):
        return sums[..., r, L:L + W] - sums[..., r, :W]

    mu0 = None if nt == 1 else wsum(4) / L
    return _trace_epilogue(X, t_padded, wsum(0), wsum(1), wsum(2), wsum(3),
                           mu0, template_t, template_s, a_std_t, a_std_s,
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

    sim = _blend(
        temp_weight,
        lambda: tdot(template_t, X[..., :nt, :])
        / (std_t * _f32(a_std_t) * n_t),
        lambda: tdot(template_s, X[..., nt:, :])
        / (std_s * _f32(a_std_s) * n_s))

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


# ---------------------------------------------------------------------------
# novelty curve (FeatureSegmentation)
# ---------------------------------------------------------------------------

def novelty_trace(xs: torch.Tensor, half_win: int, temp_weight: float,
                  num_temporal: int = 1) -> torch.Tensor:
    """``correlateHalf`` at every window position, per group, blended.

    ``xs``: ``[..., C, Tp]`` with ``Tp = W + 2·half_win − 1`` for ``W``
    positions.  Returns float32 ``sim [..., W]``.  For the window at ``t``
    (length ``2h``) the statistics run over the whole window and the
    numerator reduces to ``P(t) − h·C·μ(t)²``, ``P`` the lag-``h`` product
    sum (FeatureSegmentationImpl.scala:107-133, MathUtil.scala:82).

    The JAX package's formulation, computed in float64 whatever dtype comes
    in: both ``P − h·C·μ²`` and ``q/N − μ²`` cancel when a window's
    variance is small against its squared mean, and the FFT window sums
    carry round-off in proportion to the whole row, not to the window.  In
    f32 that costs up to 3e-4 against the f64 mirror on a 5-minute
    recording of steady sections (PERF.md, Findings).
    """
    h = half_win
    nt = num_temporal
    xs = xs.to(torch.float64)
    Tp = xs.shape[-1]
    W = Tp - 2 * h + 1
    N = _fft_len(Tp)
    ones_h = torch.conj(_ones_spectrum(h, N, xs.device, torch.complex128))
    ones_2h = torch.conj(_ones_spectrum(2 * h, N, xs.device,
                                        torch.complex128))

    def wsum(row, ones):
        return torch.fft.irfft(torch.fft.rfft(row, n=N) * ones, n=N)[..., :W]

    def group(rows: torch.Tensor) -> torch.Tensor:
        c = rows.shape[-2]
        # lag product y[i] = Σ_c x[c, i]·x[c, i+h]
        p = wsum((rows[..., :-h] * rows[..., h:]).sum(dim=-2), ones_h)
        s = wsum(rows.sum(dim=-2), ones_2h)
        q = wsum((rows * rows).sum(dim=-2), ones_2h)
        n2 = 2 * h * c
        mu = s / n2
        # the reference's two-pass variance is non-negative by construction;
        # q/N − μ² can round negative
        var = torch.clamp_min(q / n2 - mu * mu, 0.0)
        n_half = h * c
        return (p - n_half * mu * mu) / (var * n_half)

    return _blend(temp_weight, lambda: group(xs[..., :nt, :]),
                  lambda: group(xs[..., nt:, :])).to(torch.float32)


# ---------------------------------------------------------------------------
# gram similarity (SelfSimilarity)
# ---------------------------------------------------------------------------

def extract_windows(xs: torch.Tensor, starts: torch.Tensor,
                    half_win: int) -> torch.Tensor:
    """Gather windows ``xs[:, s:s+half_win]`` for each start → contiguous
    ``[B, C, h]``."""
    idx = starts[:, None] + torch.arange(half_win, device=starts.device)
    return xs[:, idx].permute(1, 0, 2).contiguous()


def window_stats(win: torch.Tensor, num_temporal: int = 1):
    """Per-window per-group sums and sums of squares: ``[..., B, C, h]`` →
    ``(s_t, q_t, s_s, q_s)`` each ``[..., B]``, in float64 (see
    :func:`gram_similarity_block`)."""
    nt = num_temporal
    win = win.to(torch.float64)
    t, s = win[..., :nt, :], win[..., nt:, :]
    return (t.sum(dim=(-2, -1)), (t * t).sum(dim=(-2, -1)),
            s.sum(dim=(-2, -1)), (s * s).sum(dim=(-2, -1)))


def gram_similarity_block(win_i: torch.Tensor, win_j: torch.Tensor,
                          stats_i, stats_j, temp_weight: float,
                          num_temporal: int = 1) -> torch.Tensor:
    """Blended ``correlateHalf`` for blocks of window pairs: cell ``(i, j)``
    correlates window ``i`` (first half) against window ``j`` (second half)
    with joint statistics over both (SelfSimilarityImpl.scala:127-165).

    ``win_*``: ``[..., B, C, h]``; ``stats_*`` from :func:`window_stats`.
    The pair dot is one matmul per group over ``[..., B, c·h]`` rows.
    Returns float32 ``sim [..., Bi, Bj]``.

    The JAX package's formulation at float64 (a DGEMM; FP64 runs on the
    H100's tensor cores at the rate of FP32 without them):
    ``D − N·μ²`` and ``q/N − μ²`` cancel for a window pair whose variance
    is small against its squared mean, which in f32 costs up to 3e-4 on a
    3-minute piece (PERF.md, Findings)."""
    nt = num_temporal
    h = win_i.shape[-1]

    def group(a, b, sa, qa, sb, qb):
        c = a.shape[-2]
        n_h = c * h
        a = a.to(torch.float64).reshape(*a.shape[:-2], n_h)
        b = b.to(torch.float64).reshape(*b.shape[:-2], n_h)
        d = torch.matmul(a, b.transpose(-1, -2))
        mu = (sa[..., :, None] + sb[..., None, :]) / (2 * n_h)
        var = torch.clamp_min(
            (qa[..., :, None] + qb[..., None, :]) / (2 * n_h) - mu * mu, 0.0)
        return (d - n_h * mu * mu) / (var * n_h)

    s_ti, q_ti, s_si, q_si = stats_i
    s_tj, q_tj, s_sj, q_sj = stats_j
    return _blend(
        temp_weight,
        lambda: group(win_i[..., :nt, :], win_j[..., :nt, :],
                      s_ti, q_ti, s_tj, q_tj),
        lambda: group(win_i[..., nt:, :], win_j[..., nt:, :],
                      s_si, q_si, s_sj, q_sj)).to(torch.float32)
